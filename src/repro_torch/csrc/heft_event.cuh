// The two phases of a HEFT_RT mapping event as device functions, and the
// one-event-per-CTA kernel built from them.  heft_fused.cu and
// fused_decision.cu launch event_kernel (both phases); oddeven_sort.cu runs
// phase 1 alone and eft_select.cu phase 2 alone, on the same bodies.
//
// Semantics (the port's plain versions, repro_torch.kernels.ref.heft_fused_ref
// and repro_torch.kernels.fused_decision.decision_ref, hold it bitwise):
//   1. Priority sort (sort_queue): stable descending by key, NaN keys after
//      -inf (the order of torch.argsort(-keys, stable=True)).  Sorted as a
//      bitonic network over composite 64-bit keys (rank of the key, slot),
//      which are unique, so the result is the stable order.  -0.0 ranks with
//      +0.0; int32 keys rank by the exact integer order.
//   2. Drain (drain): D serial steps on one warp.  Step t reads the exec row
//      of the t-th slot (with the PE mask applied as +inf when MASKED), forms
//      finish = avail + exec with IEEE f32 adds over the P lanes, takes the
//      first minimum (a NaN finish wins, as in jnp/np argmin), and, if that
//      finish is finite, latches it into avail[pe].  Otherwise the step
//      reports -1 with start and finish +inf.
//
// Layout of event_kernel: keys f32[B, D], exec f32[B, D, P] indexed by slot,
// avail f32[B, P], mask bool[P] shared by the batch; outputs
// order/assignment i32[B, D], start/finish f32[B, D], new avail f32[B, P]
// (may alias avail_in).
#pragma once

#include <cuda_fp16.h>
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

// Order-preserving rank of an int32 key: descending key order is ascending
// rank order, with the exact integer compare (no trip through f32).
__device__ __forceinline__ uint32_t desc_rank(int32_t k) {
  return ~((uint32_t)k ^ 0x80000000u);
}

// 16-bit float keys, held as their raw bits: ranked as the f32 value they
// widen to exactly (bf16: the high half of an f32; f16: __half2float).
struct Bf16Bits { uint16_t v; };
struct F16Bits { uint16_t v; };
__device__ __forceinline__ uint32_t desc_rank(Bf16Bits k) {
  return desc_rank(__uint_as_float((uint32_t)k.v << 16));
}
__device__ __forceinline__ uint32_t desc_rank(F16Bits k) {
  return desc_rank(__half2float(__ushort_as_half(k.v)));
}

// ---- phase 1: the priority queue -----------------------------------------
// All threads of the block sort the D keys at kb into buf[0, N) (N the
// power of two >= D): a bitonic network over unique composite 64-bit keys
// (rank of the key, slot), so the result is the stable descending order.
// Slots D..N-1 are padding and sort after every real slot, NaN and -inf
// keys included.  Ends with a __syncthreads: buf is readable by every thread.
template <typename K>
__device__ __forceinline__ void sort_queue(const K* kb,
                                           unsigned long long* buf, int D,
                                           int N) {
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
}

// Which exec row step t of the drain reads, and whether the drain reports
// it as the step's queue slot (the order output).
struct SortedSlots {          // the fused event: the slot sorted t-th
  const unsigned long long* buf;
  static constexpr bool kWritesOrder = true;
  __device__ __forceinline__ int operator()(int t) const {
    return (int)(uint32_t)buf[t];
  }
};
struct QueueOrder {           // eft_select: rows already in priority order
  static constexpr bool kWritesOrder = false;
  __device__ __forceinline__ int operator()(int t) const { return t; }
};

// ---- phase 2: the drain, one warp, lanes strided over the P PEs ----------
// Called by the 32 threads of one warp.  eb is the event's exec f32[D, P]
// (row read by slot(t)), av_row / av_out its registers (may alias: the row
// is read before it is written), mask the bool[P] register when MASKED, and
// order / assignment / start / finish the event's f32/i32[D] outputs (order
// is written only when Slot::kWritesOrder).
template <int C, bool MASKED, typename Slot>
__device__ __forceinline__ void drain(Slot slot, const float* eb,
                                      const float* av_row, const bool* mask,
                                      int32_t* order, int32_t* assignment,
                                      float* start, float* finish,
                                      float* av_out, int D, int P) {
  const int lane = threadIdx.x;
  float av[C];
  bool masked[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    av[c] = (p < P) ? av_row[p] : 0.0f;
    masked[c] = MASKED && p < P && mask[p];
  }
  float ex[C], exn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) exn[c] = 0.0f;
  int q = slot(0);
  load_row(ex, eb + (size_t)q * P, lane, P);
  for (int t = 0; t < D; ++t) {
    // The slot order is known up front: fetch the next row while this
    // step's reduction runs (only avail carries a dependency).
    int qn = 0;
    if (t + 1 < D) {
      qn = slot(t + 1);
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
      if constexpr (Slot::kWritesOrder) order[t] = q;
      assignment[t] = ok ? bi : -1;
      start[t] = ok ? bs : __int_as_float(0x7f800000);
      finish[t] = ok ? bv : __int_as_float(0x7f800000);
    }
    q = qn;
#pragma unroll
    for (int c = 0; c < C; ++c) ex[c] = exn[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    if (p < P) av_out[p] = av[c];
  }
}

// One mapping event per CTA: phase 1 on the whole block, phase 2 on warp 0.
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
  sort_queue(keys + (size_t)b * D, buf, D, N);
  if (threadIdx.x >= kWarp) return;
  const size_t o = (size_t)b * D;
  drain<C, MASKED>(SortedSlots{buf}, exec + o * P, avail_in + (size_t)b * P,
                   mask, order + o, assignment + o, start + o, finish + o,
                   avail_out + (size_t)b * P, D, P);
}

// Launch kernel<C> with C the number of 32-lane chunks that hold P lanes.
#define HEFT_DISPATCH_CHUNKS(P, LAUNCH) \
  do {                                  \
    const int chunks_ = ((P) + kWarp - 1) / kWarp; \
    if (chunks_ <= 1) LAUNCH(1);        \
    else if (chunks_ <= 2) LAUNCH(2);   \
    else if (chunks_ <= 4) LAUNCH(4);   \
    else if (chunks_ <= 8) LAUNCH(8);   \
    else if (chunks_ <= 16) LAUNCH(16); \
    else LAUNCH(32);                    \
  } while (0)

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
#define HEFT_LAUNCH(CH)                                                      \
  event_kernel<CH, MASKED><<<B, threads, smem, stream>>>(                    \
      keys, exec, avail_in, mask, order, assignment, start, finish,          \
      avail_out, scratch, D, P, N)
  HEFT_DISPATCH_CHUNKS(P, HEFT_LAUNCH);
#undef HEFT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace heft
