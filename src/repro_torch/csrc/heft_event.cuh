// One HEFT_RT mapping event per CTA: the body shared by heft_fused.cu and
// fused_decision.cu.
//
// Semantics (the port's plain versions, repro_torch.kernels.ref.heft_fused_ref
// and repro_torch.kernels.fused_decision.decision_ref, hold it bitwise):
//   1. Priority sort: stable descending by key, NaN keys after -inf (the
//      order of torch.argsort(-keys, stable=True)).  Sorted as a bitonic
//      network over composite 64-bit keys (rank of the key, slot), which are
//      unique, so the result is the stable order.  -0.0 ranks with +0.0.
//   2. Drain: D serial steps on one warp.  Step t reads the exec row of the
//      t-th slot (with the PE mask applied as +inf when MASKED), forms
//      finish = avail + exec with IEEE f32 adds over the P lanes, takes the
//      first minimum (a NaN finish wins, as in jnp/np argmin), and, if that
//      finish is finite, latches it into avail[pe].  Otherwise the step
//      reports -1 with start and finish +inf.
//
// Layout: keys f32[B, D], exec f32[B, D, P] indexed by slot, avail f32[B, P],
// mask bool[P] shared by the batch; outputs order/assignment i32[B, D],
// start/finish f32[B, D], new avail f32[B, P] (may alias avail_in).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace heft {

constexpr int kWarp = 32;
constexpr int kMaxPes = 32 * kWarp;        // 32 lanes of registers per thread
constexpr int kSmemSortSlots = 4096;       // 32 KB of keys; above: scratch
constexpr int kMaxThreads = 1024;

// Unsigned rank whose ascending order is the descending key order.
__device__ __forceinline__ uint32_t desc_rank(float k) {
  if (isnan(k)) return 0xFFFFFFFFu;        // after every number, -inf included
  if (k == 0.0f) k = 0.0f;                 // -0.0 ties with +0.0
  const uint32_t u = __float_as_uint(k);
  const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~asc;
}

// Does candidate (va, ia) beat (vb, ib)?  NaN first, then the smaller value,
// then the lower lane: a strict total order, so a butterfly reduction gives
// every lane the same winner, the first minimum.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

template <int C>
__device__ __forceinline__ void load_row(float (&r)[C], const float* row,
                                         int lane, int P) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    r[c] = (p < P) ? __ldg(row + p) : 0.0f;
  }
}

template <int C, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
event_kernel(const float* __restrict__ keys, const float* __restrict__ exec,
             const float* avail_in, const bool* __restrict__ mask,
             int32_t* __restrict__ order, int32_t* __restrict__ assignment,
             float* __restrict__ start, float* __restrict__ finish,
             float* avail_out, unsigned long long* scratch,
             int D, int P, int N) {
  extern __shared__ unsigned long long smem[];
  const int b = blockIdx.x;
  unsigned long long* buf =
      (N <= kSmemSortSlots) ? smem : scratch + (size_t)b * N;

  // ---- phase 1: the priority queue (bitonic over unique composite keys) --
  const float* kb = keys + (size_t)b * D;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const uint32_t hi = (i < D) ? desc_rank(kb[i]) : 0xFFFFFFFFu;
    buf[i] = ((unsigned long long)hi << 32) | (uint32_t)i;  // pads sort last
  }
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < N / 2; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const unsigned long long x = buf[i], y = buf[l];
        if ((x > y) == ((i & k) == 0)) {
          buf[i] = y;
          buf[l] = x;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x >= kWarp) return;

  // ---- phase 2: the drain, one warp, lanes strided over the P PEs --------
  const int lane = threadIdx.x;
  const float* eb = exec + (size_t)b * D * P;
  float av[C];
  bool masked[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    av[c] = (p < P) ? avail_in[(size_t)b * P + p] : 0.0f;
    masked[c] = MASKED && p < P && mask[p];
  }
  float ex[C], exn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) exn[c] = 0.0f;
  int q = (int)(uint32_t)buf[0];
  load_row(ex, eb + (size_t)q * P, lane, P);
  for (int t = 0; t < D; ++t) {
    // The sorted slots are known up front: fetch the next row while this
    // step's reduction runs (only avail carries a dependency).
    int qn = 0;
    if (t + 1 < D) {
      qn = (int)(uint32_t)buf[t + 1];
      load_row(exn, eb + (size_t)qn * P, lane, P);
    }
    float bv = __int_as_float(0x7f800000);  // +inf
    int bi = 0x7fffffff;
    float bs = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int p = lane + c * kWarp;
      if (p < P) {
        const float e = masked[c] ? __int_as_float(0x7f800000) : ex[c];
        const float f = __fadd_rn(av[c], e);
        if (better(f, p, bv, bi)) {
          bv = f;
          bi = p;
          bs = av[c];
        }
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bs = os;
      }
    }
    const bool ok = isfinite(bv);
    if (ok) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (lane + c * kWarp == bi) av[c] = bv;
    }
    if (lane == 0) {
      const size_t o = (size_t)b * D + t;
      order[o] = q;
      assignment[o] = ok ? bi : -1;
      start[o] = ok ? bs : __int_as_float(0x7f800000);
      finish[o] = ok ? bv : __int_as_float(0x7f800000);
    }
    q = qn;
#pragma unroll
    for (int c = 0; c < C; ++c) ex[c] = exn[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    if (p < P) avail_out[(size_t)b * P + p] = av[c];
  }
}

// Sort slots: the next power of two >= max(D, 2).
inline int sort_slots(int D) {
  int n = 2;
  while (n < D) n <<= 1;
  return n;
}

// Slots of u64 scratch per event the caller must supply (0: shared memory).
inline int scratch_slots(int D) {
  const int n = sort_slots(D);
  return n <= kSmemSortSlots ? 0 : n;
}

template <bool MASKED>
int launch_event(const float* keys, const float* exec, const float* avail_in,
                 const bool* mask, int32_t* order, int32_t* assignment,
                 float* start, float* finish, float* avail_out,
                 unsigned long long* scratch, int B, int D, int P,
                 cudaStream_t stream) {
  if (B <= 0 || D <= 0 || P <= 0 || P > kMaxPes || (MASKED && !mask))
    return (int)cudaErrorInvalidValue;
  const int N = sort_slots(D);
  if (N > kSmemSortSlots && !scratch) return (int)cudaErrorInvalidValue;
  int threads = N / 2;
  if (threads < kWarp) threads = kWarp;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = N <= kSmemSortSlots ? (size_t)N * 8 : 0;
  const int chunks = (P + kWarp - 1) / kWarp;
#define HEFT_LAUNCH(CH)                                                      \
  event_kernel<CH, MASKED><<<B, threads, smem, stream>>>(                    \
      keys, exec, avail_in, mask, order, assignment, start, finish,          \
      avail_out, scratch, D, P, N)
  if (chunks <= 1) HEFT_LAUNCH(1);
  else if (chunks <= 2) HEFT_LAUNCH(2);
  else if (chunks <= 4) HEFT_LAUNCH(4);
  else if (chunks <= 8) HEFT_LAUNCH(8);
  else if (chunks <= 16) HEFT_LAUNCH(16);
  else HEFT_LAUNCH(32);
#undef HEFT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace heft
