// Decode attention read from the paged KV pool in place: one query a lane
// against that lane's cached keys and values, up to its own position,
// through its row of the page table.
//
// Replaces no Pallas TPU kernel: the JAX package's decode attention is plain
// jnp (repro.models.attention.decode_attention), run over a dense view that
// the paged tick gathers for every lane's whole max_len.  This kernel was
// added for that gather and its float32 copies, which took most of a long-
// context decode tick on the card.
//
// Semantics (held against repro_torch.kernels.paged_attention
// .paged_decode_attention_ref, which gathers the pages and runs
// repro_torch.models.attention.decode_attention): scores in f32 from the
// cached values, times `scale`, then soft-capped as cap * tanh(s / cap)
// where cap > 0; slots above the lane's position, or window or more behind
// it where window > 0, take no part; softmax and P.V in f32, P never
// rounded; the output rounded once to the cache's type.
//
// Layout: q T[lanes, H, hd]; k, v T[pages, page_size, KV, hd]; table
// i32[lanes, pages_per_lane] (null: the cache is contiguous, lane b's slots
// are page b and page_size is max_len); pos i32[lanes]; scratch m, l
// f32[lanes, H, nchunk], o f32[lanes, H, nchunk, hd]; out T[lanes, H, hd].
// Query head h reads KV head h / G, G = H / KV.  T is float or bfloat16.
//
// Bound on the card: device memory, the live K and V bytes, each lane's
// pos + 1 slots (fewer under a window) of hd values a KV head, read once.
// Design: flash-decode over fixed chunks of CHUNK slots.  A block is one
// (chunk, KV head, lane); a chunk that holds none of its lane's live slots
// returns at once, so short and idle lanes cost almost nothing.  The block
// resolves its slots' rows through the page table once, then its threads
// read each row in 16-byte vectors, tpr neighbouring threads a row, UNROLL
// rows in flight a thread; the G query heads of the KV head share each
// load.  It writes its chunk's softmax partials (max m, sum l of exp(s - m),
// unnormalised sum o of exp(s - m) v), and a second kernel merges each
// (lane, head)'s live chunks in chunk order.  Every sum runs in a fixed
// order set by the slot index alone: no atomics, so a lane's result depends
// only on its own query, pages and position, and is the same whatever its
// batch-mates, in a CUDA graph or not, and whatever the page size.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE expf, tanhf, division).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int CHUNK = 256;            // slots a block (the flash-decode split)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;             // rows a thread has in flight
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* table;
  const int32_t* pos;
  float* m;
  float* l;
  float* o;
  void* out;
  int lanes, H, KV, hd, page_size, pages_per_lane, max_len, nchunk, window;
  float scale, cap;
};

// 16 bytes of T widened to f32, and f32 rounded back to T.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // element 2i in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ inline int clamp_pos(const Args& a, int lane) {
  return min(max(a.pos[lane], 0), a.max_len - 1);
}

// The block's share of rows, UNROLL at a time: rows base + u * rows + r,
// u < UNROLL, of the n live slots; the vectors of rows past n are zero.
template <int NV>
__device__ inline void load_rows(uint4 (&x)[UNROLL][NV], const uint4* src,
                                 const int* rb, int base, int rows, int r,
                                 int n, int j, size_t row_stride,
                                 size_t head_off) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int i = base + u * rows + r;
#pragma unroll
    for (int w = 0; w < NV; ++w) x[u][w] = make_uint4(0u, 0u, 0u, 0u);
    if (i < n) {
      const uint4* p = src + (rb[i] * row_stride + head_off) + j * NV;
#pragma unroll
      for (int w = 0; w < NV; ++w) x[u][w] = p[w];
    }
  }
}

// One (chunk, KV head, lane): the chunk's softmax partials for the KV
// head's G query heads, GT of them at a time.  NV vectors of 16 bytes a
// thread a row; tpr = hd / (NV * Vec<T>::N) threads a row (a power of two,
// at most 32).
template <typename T, int GT, int NV>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const Args a) {
  constexpr int E = NV * Vec<T>::N;   // a thread's values of a row
  const int c = blockIdx.x, kvh = blockIdx.y, lane = blockIdx.z;
  const int p = clamp_pos(a, lane);
  const int c0 = c * CHUNK;
  const int lo = a.window > 0 ? max(c0, p - a.window + 1) : c0;
  const int hi = min(c0 + CHUNK - 1, p);
  if (lo > hi) return;                // no live slot in this chunk
  const int n = hi - lo + 1;
  const int hd = a.hd, G = a.H / a.KV;
  const int tpr = hd / E, rows = THREADS / tpr;
  const int t = threadIdx.x, r = t / tpr, j = t % tpr;
  const int warp = t >> 5, wl = t & 31;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [GT][hd]: the tile's queries
  float* ps = qs + GT * hd;           // [GT][CHUNK]: scores, then exp(s - m)
  float* os = ps + GT * CHUNK;        // [GT][hd]: the tile's value sums
  int* rb = reinterpret_cast<int*>(os + GT * hd);   // [CHUNK]: slot -> row

  for (int i = t; i < n; i += THREADS) {
    const int s = lo + i;
    const int page = a.table
        ? a.table[lane * a.pages_per_lane + s / a.page_size] : lane;
    rb[i] = page * a.page_size + s % a.page_size;
  }
  // a row's 16-byte vectors: rows of KV heads, each hd / Vec<T>::N vectors
  const size_t vecs = (size_t)hd / Vec<T>::N;
  const size_t row_stride = (size_t)a.KV * vecs, head_off = kvh * vecs;
  const uint4* kb = static_cast<const uint4*>(a.k);
  const uint4* vb = static_cast<const uint4*>(a.v);
  const T* qg = static_cast<const T*>(a.q) + ((size_t)lane * a.H + kvh * G) * hd;

  for (int g0 = 0; g0 < G; g0 += GT) {
    const int gn = min(GT, G - g0);
    for (int i = t; i < GT * hd; i += THREADS)
      qs[i] = i < gn * hd ? Vec<T>::load(qg + g0 * hd + i) : 0.f;
    __syncthreads();

    // scores: a row's tpr threads each dot their E values, then a tree
    float qr[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = qs[g * hd + j * E + e];
    for (int base = 0; base < n; base += rows * UNROLL) {
      uint4 x[UNROLL][NV];
      load_rows<NV>(x, kb, rb, base, rows, r, n, j, row_stride, head_off);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kf[E];
#pragma unroll
        for (int w = 0; w < NV; ++w) Vec<T>::widen(x[u][w], kf + w * Vec<T>::N);
        float acc[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], kf[e], s);
          acc[g] = s;
        }
        for (int off = tpr >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < GT; ++g)
            acc[g] += __shfl_xor_sync(FULL, acc[g], off);
        }
        const int i = base + u * rows + r;
        if (j == 0 && i < n) {
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            if (g < gn) {
              float s = acc[g] * a.scale;
              if (a.cap > 0.f) s = a.cap * tanhf(s / a.cap);
              ps[g * CHUNK + i] = s;
            }
          }
        }
      }
    }
    __syncthreads();

    // the chunk's softmax partials: a warp a head
    for (int g = warp; g < gn; g += WARPS) {
      float* sg = ps + g * CHUNK;
      float mx = -INFINITY;
      for (int i = wl; i < n; i += 32) mx = fmaxf(mx, sg[i]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      float sum = 0.f;
      for (int i = wl; i < n; i += 32) {
        const float e = expf(sg[i] - mx);
        sg[i] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      if (wl == 0) {
        const size_t at = ((size_t)lane * a.H + kvh * G + g0 + g) * a.nchunk + c;
        a.m[at] = mx;
        a.l[at] = sum;
      }
    }
    __syncthreads();

    // P.V: each thread sums its E values over its rows ...
    float acc[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    for (int base = 0; base < n; base += rows * UNROLL) {
      uint4 x[UNROLL][NV];
      load_rows<NV>(x, vb, rb, base, rows, r, n, j, row_stride, head_off);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * rows + r;
        if (i < n) {
          float vf[E];
#pragma unroll
          for (int w = 0; w < NV; ++w)
            Vec<T>::widen(x[u][w], vf + w * Vec<T>::N);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float pg = g < gn ? ps[g * CHUNK + i] : 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
          }
        }
      }
    }
    // ... then a tree over a warp's rows, then the warps in warp order
    for (int off = 16; off >= tpr; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }
    for (int w = 0; w < WARPS; ++w) {
      if (warp == w && wl < tpr) {
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float* d = os + g * hd + j * E + e;
            *d = w == 0 ? acc[g][e] : *d + acc[g][e];
          }
      }
      __syncthreads();
    }
    for (int i = t; i < gn * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      a.o[(((size_t)lane * a.H + kvh * G + g0 + g) * a.nchunk + c) * hd + d] =
          os[i];
    }
    __syncthreads();                  // before the next tile reuses smem
  }
}

// One (head, lane): its live chunks' partials merged in chunk order,
// M = max m, out = sum o e^(m - M) / sum l e^(m - M), rounded to T.
template <typename T>
__global__ void merge_kernel(const Args a) {
  const int h = blockIdx.x, lane = blockIdx.y;
  const int p = clamp_pos(a, lane);
  const int c_lo = a.window > 0 ? max(0, p - a.window + 1) / CHUNK : 0;
  const int c_hi = p / CHUNK;
  const size_t base = ((size_t)lane * a.H + h) * a.nchunk;
  float mx = -INFINITY;
  for (int c = c_lo; c <= c_hi; ++c) mx = fmaxf(mx, a.m[base + c]);
  float den = 0.f;
  for (int c = c_lo; c <= c_hi; ++c)
    den += a.l[base + c] * expf(a.m[base + c] - mx);
  T* out = static_cast<T*>(a.out) + ((size_t)lane * a.H + h) * a.hd;
  for (int d = threadIdx.x; d < a.hd; d += blockDim.x) {
    float num = 0.f;
    for (int c = c_lo; c <= c_hi; ++c)
      num += a.o[(base + c) * a.hd + d] * expf(a.m[base + c] - mx);
    out[d] = Vec<T>::store(num / den);
  }
}

template <typename T, int GT, int NV>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (2 * GT * a.hd + GT * CHUNK) * sizeof(float)
                      + CHUNK * sizeof(int);
  partials_kernel<T, GT, NV>
      <<<dim3(a.nchunk, a.KV, a.lanes), THREADS, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = a.hd >= 256 ? 256 : (a.hd + 31) / 32 * 32;
  merge_kernel<T><<<dim3(a.H, a.lanes), threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// GT, the query heads a tile: G rounded up to a power of two, at most 8.
template <typename T, int NV>
int launch_g(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G == 1) return launch<T, 1, NV>(a, stream);
  if (G == 2) return launch<T, 2, NV>(a, stream);
  if (G <= 4) return launch<T, 4, NV>(a, stream);
  return launch<T, 8, NV>(a, stream);
}

template <typename T>
int launch_t(const Args& a, cudaStream_t stream) {
  const int vecs = a.hd * (int)sizeof(T) / 16;
  if (vecs <= 32) return launch_g<T, 1>(a, stream);
  return launch_g<T, 2>(a, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0: no window; cap <= 0: no soft
// cap.  The caller has checked the shapes: H a multiple of KV, hd * sizeof
// (T) a power-of-two multiple of 16 bytes of at most 1024, 16-byte aligned
// pointers, scratch of lanes * H * ceil(max_len / 256) partials.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const int32_t* table,
    const int32_t* pos, float* m, float* l, float* o, void* out, int dtype,
    int lanes, int H, int KV, int hd, int page_size, int pages_per_lane,
    int window, float scale, float cap, void* stream) {
  if (lanes <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || page_size <= 0 ||
      pages_per_lane <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, table, pos, m, l, o, out, lanes, H, KV, hd, page_size,
         pages_per_lane, page_size * pages_per_lane, 0, window, scale, cap};
  a.nchunk = (a.max_len + CHUNK - 1) / CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(a, s);
  if (dtype == 1) return launch_t<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
