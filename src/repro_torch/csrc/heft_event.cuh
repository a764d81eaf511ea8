// The two phases of a HEFT_RT mapping event as device functions, and the
// one-event-per-CTA kernel built from them.  heft_fused.cu and
// fused_decision.cu launch event_kernel (both phases); oddeven_sort.cu runs
// phase 1 alone (sort_queue) and eft_select.cu phase 2 alone (drain_event,
// the same staged drain that event_kernel runs after its sort).
//
// Semantics (the port's plain versions, repro_torch.kernels.ref.heft_fused_ref
// and repro_torch.kernels.fused_decision.decision_ref, hold it bitwise; the
// step-by-step mirrors are repro_torch.kernels.ref.bitonic_sort_sim of
// sort_queue and heft_event_sim / eft_select_sim of the drain):
//   1. Priority sort (sort_queue): stable descending by key, NaN keys after
//      -inf (the order of torch.argsort(-keys, stable=True)).  Sorted as a
//      bitonic network over composite 64-bit keys (rank of the key, slot),
//      which are unique, so any correct schedule of the network gives the
//      stable order.  -0.0 ranks with +0.0; int32 keys rank by the exact
//      integer order.
//   2. Drain: D serial steps.  Step t reads the exec row of the t-th slot
//      (with the PE mask applied as +inf), forms finish = avail + exec with
//      IEEE f32 adds over the P lanes, takes the first minimum (a NaN finish
//      wins, as in jnp/np argmin), and, if that finish is finite, latches it
//      into avail[pe].  Otherwise the step reports -1 with start and finish
//      +inf.
//
// The drain runs on the card's terms (the notes at the top of heft_fused.cu
// say why): the rows are staged in shared memory in drain order, rows whose
// every lane is +inf are flagged and skipped (they always give (-1, +inf,
// +inf) and never touch a register, whatever the registers hold: -inf + inf
// is NaN, which is not finite), the step is short, and the outputs leave
// the block coalesced.  The sort keeps its keys in registers for every
// stage whose pairs lie within a warp (see the note above sort_queue).
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

using u64 = unsigned long long;

constexpr int kWarp = 32;
constexpr int kMaxPes = 32 * kWarp;        // 32 lanes of registers per thread
constexpr int kSortChunk = 4096;           // 32 KB of keys; above: scratch
constexpr int kSmallPes = 8;               // up to here one thread steps
constexpr int kEventThreads = 512;         // two event CTAs an SM
constexpr size_t kMaxSmem = 232448;        // 227 KB of shared memory a block

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// Unsigned rank whose ascending order is the descending key order.
__device__ __forceinline__ uint32_t desc_rank(float k) {
  if (isnan(k)) return 0xFFFFFFFFu;        // after every number, -inf included
  if (k == 0.0f) k = 0.0f;                 // -0.0 ties with +0.0
  const uint32_t u = __float_as_uint(k);
  const uint32_t asc = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~asc;
}

// Rank of a finish whose ascending order is the drain's value order: NaN
// first, then by value, -0.0 tied with +0.0.
__device__ __forceinline__ uint32_t finish_rank(float f) {
  if (isnan(f)) return 0u;                 // -inf ranks 0x007FFFFF
  if (f == 0.0f) f = 0.0f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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
// A bitonic network over the composite keys, ascending (the descending key
// order), as the block runs it.  Each thread holds E consecutive keys in
// registers (E = sort_grain: 2 to 8), thread t keys t*E .. t*E + E - 1.
// Stage (k, j) pairs index i with i ^ j and puts the smaller key first
// where (i & k) == 0, i the key's index in the whole queue.  So:
//   - j < E: both keys in one thread's registers;
//   - E <= j < 32 E: the partner is lane ^ (j / E) of the same warp, one
//     __shfl_xor_sync of the 64-bit key, no barrier;
//   - j >= 32 E: through a shared buffer, one __syncthreads a stage.
// At N = 2048 with 256 threads (E = 8) that is 6 shared stages of 66.
// Queues of up to 4096 slots sort in shared memory.  Above, chunks of 4096
// keys are sorted in shared memory, and each later level k runs its
// stages j >= 4096 as passes over the scratch buffer (10 at N = 65536) and
// then, chunk by chunk, its stages j < 4096 in registers and shared
// memory.  A queue of at most 32 E slots (64 in the event kernels, 256 in
// oddeven_sort) is one warp's alone: the rest of the block waits at the
// closing barrier.

// Keys a thread holds: N / threads (a chunk's above 4096 slots), 2 to 8.
// The launchers give at least N / 8 threads (512 above 4096 slots).
__host__ __device__ inline int sort_grain(int N, int threads) {
  const int n = N < kSortChunk ? N : kSortChunk;
  const int e = n / threads;
  return e < 2 ? 2 : e > 8 ? 8 : e;
}

// Where key i sits in a shared buffer between two register phases: its
// 16-byte unit permuted within each 128-byte row, so that the threads'
// 16-byte stores and loads of E consecutive keys meet no bank conflict.
__device__ __forceinline__ int swz(int i) { return i ^ (((i >> 4) & 7) << 1); }

// Put the smaller key first where up, the larger where not.
__device__ __forceinline__ void order_pair(u64& a, u64& b, bool up) {
  const bool swap = (a > b) == up;
  const u64 x = a;
  a = swap ? b : a;
  b = swap ? x : b;
}

template <int E>
__device__ __forceinline__ void put_keys(u64* s, const u64 (&v)[E], int i,
                                         bool swizzled) {
#pragma unroll
  for (int c = 0; c < E; c += 2)
    *reinterpret_cast<ulonglong2*>(s + (swizzled ? swz(i + c) : i + c)) =
        make_ulonglong2(v[c], v[c + 1]);
}

template <int E>
__device__ __forceinline__ void get_keys(u64 (&v)[E], const u64* s, int i,
                                         bool swizzled) {
#pragma unroll
  for (int c = 0; c < E; c += 2) {
    const ulonglong2 x = *reinterpret_cast<const ulonglong2*>(
        s + (swizzled ? swz(i + c) : i + c));
    v[c] = x.x;
    v[c + 1] = x.y;
  }
}

// Levels 2 .. E: each thread sorts its own E keys, up where (i0 & E) == 0
// (below E the directions are those of the key's place in the thread).
template <int E>
__device__ __forceinline__ void sort_own(u64 (&v)[E], int i0) {
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
#pragma unroll
    for (int j = k / 2; j > 0; j >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & j))
          order_pair(v[e], v[e | j], k == E ? (i0 & E) == 0 : (e & k) == 0);
    }
  }
}

// Stages j < E of a level k > E: the thread's own keys, all one way.
template <int E>
__device__ __forceinline__ void register_stages(u64 (&v)[E], bool up) {
#pragma unroll
  for (int j = E / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (!(e & j)) order_pair(v[e], v[e | j], up);
  }
}

// Stage (k, j), E <= j < 32 E: each key against the same key of lane
// lane ^ (j / E); this thread keeps the smaller one where its keys are the
// lower of their pairs (bit j of i0 clear) and the level runs up there, or
// both not.
template <int E>
__device__ __forceinline__ void shuffle_stage(u64 (&v)[E], int i0, int k,
                                              int j) {
  const bool keep_min = ((i0 & j) == 0) == ((i0 & k) == 0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const u64 y = __shfl_xor_sync(0xffffffffu, v[e], j / E);
    v[e] = (keep_min == (y < v[e])) ? y : v[e];
  }
}

// Stage (k, j) over n keys at s (indices g0 + i), all threads, pair by
// pair; `swizzled` as put_keys laid them out.  The caller synchronises.
__device__ __forceinline__ void buffer_stage(u64* s, int n, int g0, int k,
                                             int j, bool swizzled) {
  for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int a = swizzled ? swz(i) : i, b = swizzled ? swz(i | j) : i | j;
    const u64 x = s[a], y = s[b];
    if ((x > y) == (((g0 | i) & k) == 0)) {
      s[a] = y;
      s[b] = x;
    }
  }
}

// Levels k0 .. k1 (powers of two; k0 = 2 or k0 > E) over n <= 4096 keys,
// E a thread in v, global indices from g0: the stages j >= 32 E of a level
// through the shared buffer s (n slots, swizzled), the rest in registers
// and shuffles.
// All threads call it; threads past n / E hold nothing, and the lanes of
// warp 0 past n / E (n < 32 E) hold padding that no holder's stage reads.
template <int E>
__device__ __forceinline__ void bitonic_levels(u64 (&v)[E], u64* s, int n,
                                               int g0, int k0, int k1) {
  const int t = threadIdx.x;
  const bool holds = t * E < n;
  const bool warp_holds = (t & ~(kWarp - 1)) * E < n;
  const int i0 = g0 + t * E;
  if (k0 == 2) {
    if (warp_holds) sort_own(v, i0);
    k0 = 2 * E;
  }
  for (int k = k0; k <= k1; k <<= 1) {
    int j = (k < n ? k : n) / 2;
    if (j >= kWarp * E) {
      if (holds) put_keys(s, v, t * E, true);
      __syncthreads();
      for (; j >= kWarp * E; j >>= 1) {
        buffer_stage(s, n, g0, k, j, true);
        __syncthreads();
      }
      // each thread reads back the slots it wrote: the next level's
      // put_keys needs no barrier before it
      if (holds) get_keys(v, s, t * E, true);
    }
    if (warp_holds) {
      for (; j >= E; j >>= 1) shuffle_stage(v, i0, k, j);
      register_stages(v, (i0 & k) == 0);
    }
  }
}

template <int E, typename K>
__device__ __forceinline__ void sort_keys(const K* kb, u64* buf, u64* chunk,
                                          int D, int N) {
  const int t = threadIdx.x;
  auto key = [&](int i) -> u64 {
    const uint32_t hi = (i < D) ? desc_rank(kb[i]) : 0xFFFFFFFFu;
    return ((u64)hi << 32) | (uint32_t)i;   // pads sort after every key
  };
  u64 v[E];
  if (N <= kSortChunk) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      v[e] = (t * E + e < N) ? key(t * E + e) : ~0ull;
    bitonic_levels(v, buf, N, 0, 2, N);
    __syncthreads();   // every thread has read its swizzled slots back
    if (t * E < N) put_keys(buf, v, t * E, false);
  } else {
    // every thread holds keys here (blockDim.x == kSortChunk / E)
    for (int g0 = 0; g0 < N; g0 += kSortChunk) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = key(g0 + t * E + e);
      bitonic_levels(v, chunk, kSortChunk, g0, 2, kSortChunk);
      put_keys(buf + g0, v, t * E, false);
    }
    for (int k = 2 * kSortChunk; k <= N; k <<= 1) {
      for (int j = k / 2; j >= kSortChunk; j >>= 1) {
        __syncthreads();
        buffer_stage(buf, N, 0, k, j, false);
      }
      __syncthreads();
      for (int g0 = 0; g0 < N; g0 += kSortChunk) {
        get_keys(v, buf + g0, t * E, false);
        bitonic_levels(v, chunk, kSortChunk, g0, k, k);
        put_keys(buf + g0, v, t * E, false);
      }
    }
  }
  __syncthreads();
}

// All threads of the block sort the D keys at kb into buf[0, N) (N the
// power of two >= D): slots D..N-1 are padding and sort after every real
// slot, NaN and -inf keys included.  buf is shared memory up to 4096
// slots, else the event's N slots of scratch, with `chunk` 4096 slots of
// shared memory.  Ends with a __syncthreads: buf is readable by every
// thread, and chunk is free.  Not inlined: the sort's registers (up to 8
// 64-bit keys a thread) are allocated apart from the caller's, whose drain
// then keeps all of its own.
template <typename K>
__device__ __noinline__ void sort_queue(const K* kb, u64* buf, u64* chunk,
                                        int D, int N) {
  switch (sort_grain(N, blockDim.x)) {
    case 2: sort_keys<2>(kb, buf, chunk, D, N); break;
    case 4: sort_keys<4>(kb, buf, chunk, D, N); break;
    default: sort_keys<8>(kb, buf, chunk, D, N);
  }
}

// ---- phase 2: staged rows, live rows only ---------------------------------
// Position g of the queue drains source row src(g): the sorted slot in
// event_kernel (SortedQueue), g itself in eft_select (QueueOrder).  The
// positions are cut into tiles of `tile` positions.  Staging a
// tile flags its live rows (a lane other than +inf once the mask is
// applied), numbers them by a prefix sum of the flags and copies them into
// shared memory in that order (row stride: P rounded up to 4 floats, pad
// lanes +inf), so the drain reads rows 0, 1, ... with no indirection.
// `slot` maps each position to its live row (kNoop for the others).  The
// drain writes one 16-byte record (assignment, start, finish) per live row;
// the write-back reads a position's record through `slot`, or gives a
// no-op position (-1, +inf, +inf).  One tile: everything fits.  Several: a
// ring of two row tiles and three record / slot tiles, so warps 1.. stage
// tile k+1 and write back tile k-1 while warp 0 drains tile k.
constexpr uint16_t kNoop = 0xFFFF;

struct Plan {
  int tile, ntiles, stride, nrows, nouts;
  size_t rows_off, rec_off, slot_off, live_off, masks_off, flags_off, bytes;
};

__host__ __device__ inline size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// The shared memory of one event: the sort's keys first (N slots up to
// 4096; N = 0 when no sort runs; above 4096 the sort's chunk buffer
// aliases the row ring, which is free until the sort has ended), then the
// drain's tiles.
__host__ __device__ inline Plan plan_event(int D, int P, int N, int tile) {
  Plan s;
  s.tile = tile;
  s.ntiles = (D + tile - 1) / tile;
  s.stride = (P + 3) & ~3;
  s.nrows = s.ntiles > 1 ? 2 : 1;
  s.nouts = s.ntiles > 1 ? 3 : 1;
  size_t off = N <= kSortChunk ? (size_t)N * 8 : 0;   // the sort's keys
  s.rows_off = off;          // 16-byte aligned; one spare row: read ahead
  off += (size_t)s.nrows * (tile + 1) * s.stride * 4;
  s.rec_off = off;           // per live row: assignment, start, finish
  off += (size_t)s.nouts * tile * 16;
  s.slot_off = off;          // per position: its live row or kNoop (u16)
  off += (size_t)s.nouts * tile * 2;
  off = align_up(off, 4);
  s.live_off = off;          // per row tile: the number of live rows
  off += 8;
  s.masks_off = off;         // live bits, one word per 32 positions
  off += (size_t)((tile + 31) / 32) * 4;
  s.flags_off = off;         // live flag per position (P > 8)
  off += tile;
  if (N > kSortChunk && off < (size_t)kSortChunk * 8) off = kSortChunk * 8;
  s.bytes = align_up(off, 16);
  return s;
}

// The whole event in one tile if it fits, else the largest ring tile.
inline int pick_tile(int D, int P, int N) {
  if (plan_event(D, P, N, D).bytes <= kMaxSmem) return D;
  int lo = 1, hi = D - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (plan_event(D, P, N, mid).bytes <= kMaxSmem) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Barrier over the threads that stage: the whole block, or the producer
// warps (all but warp 0) on named barrier 1.
__device__ __forceinline__ void stage_sync(bool producers, int nthreads) {
  if (producers)
    asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
  else
    __syncthreads();
}

// The row at src (P <= 8 lanes) with the mask bits applied: +inf in masked
// and pad lanes; one 16-byte load per 4 lanes where aligned.
template <bool MASKED>
__device__ __forceinline__ void fetch_small(float (&v)[kSmallPes],
                                            const float* src, int P,
                                            uint32_t mbits) {
  if ((P & 3) == 0 && ((uintptr_t)src & 15) == 0) {
#pragma unroll
    for (int p = 0; p < kSmallPes; p += 4) {
      if (p < P) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + p));
        v[p] = x.x; v[p + 1] = x.y; v[p + 2] = x.z; v[p + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < kSmallPes; ++p)
      if (p < P) v[p] = __ldg(src + p);
  }
#pragma unroll
  for (int p = 0; p < kSmallPes; ++p)
    if (p >= P || (MASKED && ((mbits >> p) & 1u))) v[p] = f32_inf();
}

// Stage positions [t0, t0 + len) of the queue (see the note above): live
// rows copied in order into `rows`, `slot` per position, the number of live
// rows into *nlive.  Called by `nthreads` threads (a multiple of 32),
// tid their index among them; the caller synchronises after it.
template <bool MASKED, typename Src>
__device__ void stage_tile(const float* eb, Src row, const bool* mask,
                           int stride, float* rows, uint16_t* slot,
                           int* nlive, uint32_t* masks, uint8_t* flags,
                           int t0, int len, int P, int tid, int nthreads,
                           bool producers) {
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int nwarps = nthreads / kWarp;
  const float inf = f32_inf();
  const bool small = P <= kSmallPes;
  uint32_t mbits = 0;
  if (MASKED && small)
    for (int p = 0; p < P; ++p) mbits |= (uint32_t)mask[p] << p;
  auto src = [&](int t) { return eb + (size_t)row(t0 + t) * P; };
  if (small) {
    // one thread a row; a warp's lanes hold 32 consecutive positions
    for (int base = warp * kWarp; base < len; base += nthreads) {
      const int t = base + lane;
      bool live = false;
      if (t < len) {
        float v[kSmallPes];
        fetch_small<MASKED>(v, src(t), P, mbits);
#pragma unroll
        for (int p = 0; p < kSmallPes; ++p) live |= p < P && v[p] != inf;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) masks[base / kWarp] = m;
    }
  } else {
    // one warp a row, lanes strided over its lanes
    for (int t = warp; t < len; t += nwarps) {
      const float* q = src(t);
      bool live = false;
      for (int p = lane; p < P; p += kWarp)
        live |= !(MASKED && mask[p]) && __ldg(q + p) != inf;
      live = __any_sync(0xffffffffu, live);
      if (lane == 0) flags[t] = live;
    }
    stage_sync(producers, nthreads);
    for (int base = warp * kWarp; base < len; base += nthreads) {
      const int t = base + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, t < len && flags[t]);
      if (lane == 0) masks[base / kWarp] = m;
    }
  }
  stage_sync(producers, nthreads);
  // a warp per 32 positions: its live rows are numbered after those of the
  // words before it (the same positions and lanes as the flag pass above,
  // for P <= 8, so each lane copies the row it flagged)
  const int nwords = (len + kWarp - 1) / kWarp;
  for (int w = warp; w < nwords; w += nwarps) {
    int before = 0;
    for (int j = lane; j < w; j += kWarp) before += __popc(masks[j]);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      before += __shfl_xor_sync(0xffffffffu, before, off);
    const uint32_t m = masks[w];
    const int t = w * kWarp + lane;
    if (t < len) {
      const bool live = (m >> lane) & 1u;
      const int d = before + __popc(m & ((1u << lane) - 1u));
      slot[t] = live ? (uint16_t)d : kNoop;
      if (small && live) {
        float v[kSmallPes];
        fetch_small<MASKED>(v, src(t), P, mbits);
        float4* dst = reinterpret_cast<float4*>(rows + (size_t)d * stride);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        if (stride > 4) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    if (w == nwords - 1 && lane == 0) *nlive = before + __popc(m);
  }
  if (!small) {
    stage_sync(producers, nthreads);
    for (int t = warp; t < len; t += nwarps) {
      const int d = slot[t];
      if (d == kNoop) continue;
      const float* q = src(t);
      float* dst = rows + (size_t)d * stride;
      for (int p = lane; p < stride; p += kWarp)
        dst[p] = (p >= P || (MASKED && mask[p])) ? inf : __ldg(q + p);
    }
  }
}

// min with NaN propagation (PTX min.NaN, sm_80 on): NaN if either is NaN.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int4 record(bool ok, int pe, float s, float f) {
  return ok ? make_int4(pe, __float_as_int(s), __float_as_int(f), 0)
            : make_int4(-1, 0x7f800000, 0x7f800000, 0);
}

// The step for P <= 8: one thread holds the S (power of two >= P) registers
// (pad lanes 0, whose finish is 0 + inf = +inf and never beats a real
// lane) and adds the staged row.  Two trees run side by side over the S
// finishes: a strict less-than tree that carries the lane and the start
// (a higher lane wins only if strictly smaller, so ties, -0.0 against +0.0
// included, go to the lower lane, and the winner keeps its own bits), and
// a min.NaN tree whose result is finite exactly when no lane is NaN and the
// minimum is finite, the step's guard (a NaN lane wins the first minimum, and
// reports -1 like any non-finite winner, so it needs no lane).  The next
// row is read ahead; only the registers carry from step to step.
template <int S>
struct SmallStep {
  static constexpr int kThreads = 1;
  float av[S];

  __device__ __forceinline__ void load(const float* a, int P) {
#pragma unroll
    for (int p = 0; p < S; ++p) av[p] = p < P ? a[p] : 0.0f;
  }
  __device__ __forceinline__ void store(float* a, int P) const {
#pragma unroll
    for (int p = 0; p < S; ++p)
      if (p < P) a[p] = av[p];
  }
  static __device__ __forceinline__ void read(float (&e)[S], const float* r) {
    if constexpr (S >= 4) {
#pragma unroll
      for (int p = 0; p < S; p += 4) {
        const float4 x = *reinterpret_cast<const float4*>(r + p);
        e[p] = x.x; e[p + 1] = x.y; e[p + 2] = x.z; e[p + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < S; ++p) e[p] = r[p];
    }
  }
  __device__ __forceinline__ void run(const float* rows, int n, int stride,
                                      int P, int4* rec) {
    float e[S], en[S];
    read(e, rows);
    for (int i = 0; i < n; ++i) {
      read(en, rows + (i + 1) * stride);   // the spare row: always readable
      float v[S], sv[S], mn[S];
      int ix[S];
#pragma unroll
      for (int p = 0; p < S; ++p) {
        v[p] = mn[p] = __fadd_rn(av[p], e[p]);
        sv[p] = av[p];
        ix[p] = p;
      }
#pragma unroll
      for (int w = 1; w < S; w <<= 1) {
#pragma unroll
        for (int p = 0; p + w < S; p += 2 * w) {
          const bool hi = v[p + w] < v[p];
          v[p] = hi ? v[p + w] : v[p];
          sv[p] = hi ? sv[p + w] : sv[p];
          ix[p] = hi ? ix[p + w] : ix[p];
          mn[p] = fmin_nan(mn[p], mn[p + w]);
        }
      }
      const bool ok = isfinite(mn[0]);
#pragma unroll
      for (int p = 0; p < S; ++p) av[p] = (ok && ix[0] == p) ? v[0] : av[p];
      rec[i] = record(ok, ix[0], sv[0], v[0]);
#pragma unroll
      for (int p = 0; p < S; ++p) e[p] = en[p];
    }
  }
};

// The step for P > 8: one warp, lanes strided over the P lanes (C of them
// per lane).  Each lane runs the two trees of SmallStep over its own lanes;
// its rank is 0 if it holds a NaN, else its best finish's rank (by value,
// -0.0 tied with +0.0).  The warp's least rank is one redux.sync, the least
// lane at that rank a second, and the winner's finish and start come from
// its owner in one 64-bit shuffle (the winner is its owner's own best).
template <int C>
struct WideStep {
  static constexpr int kThreads = kWarp;
  float av[C];

  __device__ __forceinline__ void load(const float* a, int P) {
    const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int p = lane + c * kWarp;
      av[c] = p < P ? a[p] : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* a, int P) const {
    const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int p = lane + c * kWarp;
      if (p < P) a[p] = av[c];
    }
  }
  __device__ __forceinline__ void run(const float* rows, int n, int stride,
                                      int P, int4* rec) {
    const int lane = threadIdx.x & (kWarp - 1);
    for (int i = 0; i < n; ++i) {
      const float* r = rows + i * stride;
      float v[C], sv[C], mn[C];
      int ix[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int p = lane + c * kWarp;
        v[c] = mn[c] = __fadd_rn(av[c], p < P ? r[p] : f32_inf());
        sv[c] = av[c];
        ix[c] = p;
      }
#pragma unroll
      for (int w = 1; w < C; w <<= 1) {
#pragma unroll
        for (int c = 0; c + w < C; c += 2 * w) {
          const bool hi = v[c + w] < v[c];
          v[c] = hi ? v[c + w] : v[c];
          sv[c] = hi ? sv[c + w] : sv[c];
          ix[c] = hi ? ix[c + w] : ix[c];
          mn[c] = fmin_nan(mn[c], mn[c + w]);
        }
      }
      const uint32_t rank = isnan(mn[0]) ? 0u : finish_rank(v[0]);
      const uint32_t least = __reduce_min_sync(0xffffffffu, rank);
      const int wi = (int)__reduce_min_sync(
          0xffffffffu, rank == least ? (uint32_t)ix[0] : 0xFFFFFFFFu);
      unsigned long long pair = ((unsigned long long)__float_as_uint(sv[0])
                                 << 32) | __float_as_uint(v[0]);
      pair = __shfl_sync(0xffffffffu, pair, wi & (kWarp - 1));
      const float wv = __uint_as_float((uint32_t)pair);
      const float ws = __uint_as_float((uint32_t)(pair >> 32));
      const bool ok = least != 0u && isfinite(wv);
#pragma unroll
      for (int c = 0; c < C; ++c)
        av[c] = (ok && lane + c * kWarp == wi) ? wv : av[c];
      if (lane == 0) rec[i] = record(ok, wi, ws, wv);
    }
  }
};

// Where position g's row comes from, and whether its slot is an output.
struct SortedQueue {           // event_kernel: the g-th key of the sort
  static constexpr bool kOrder = true;
  const u64* buf;
  __device__ __forceinline__ int operator()(int g) const {
    return (int)(uint32_t)buf[g];
  }
};
struct QueueOrder {            // eft_select: rows already in priority order
  static constexpr bool kOrder = false;
  __device__ __forceinline__ int operator()(int g) const { return g; }
};

// Copy tile positions [0, len) of the outputs to device memory, coalesced:
// order (where the queue was sorted) from the source row, the rest from
// the position's record.
template <typename Src>
__device__ __forceinline__ void write_back(Src row, const int4* rec,
                                           const uint16_t* slot,
                                           int32_t* order,
                                           int32_t* assignment, float* start,
                                           float* finish, int t0, int len,
                                           int tid, int nthreads) {
  for (int t = tid; t < len; t += nthreads) {
    const int g = t0 + t;
    const int d = slot[t];
    const int4 r = d == kNoop ? record(false, 0, 0.0f, 0.0f) : rec[d];
    if constexpr (Src::kOrder) order[g] = row(g);
    assignment[g] = r.x;
    start[g] = __int_as_float(r.y);
    finish[g] = __int_as_float(r.z);
  }
}

// Phase 2 of event blockIdx.x, the whole block: tile 0 staged by the
// block, then warp 0 (Step::kThreads of it) drains tile k while warps 1..
// write back tile k-1 and stage tile k+1.  The arguments are the batch's:
// exec f32[B, D, P] read through `row`, avail_in / avail_out f32[B, P]
// (may alias: read before the drain, written after it), order
// (Src::kOrder only) / assignment / start / finish [B, D]; the event's
// offsets are taken where they are used, so that they hold no registers
// through the drain.  It writes shared memory from s.rows_off on from its
// first line: the caller's barrier must end any earlier use of it.
template <typename Step, bool MASKED, typename Src>
__device__ __forceinline__ void drain_event(
    const Plan& s, unsigned char* smem, Src row, const float* exec,
    const bool* mask, const float* avail_in, float* avail_out,
    int32_t* order, int32_t* assignment, float* start, float* finish, int D,
    int P) {
  const int b = blockIdx.x;
  const float* eb = exec + (size_t)b * D * P;
  const size_t o = (size_t)b * D;
  int* nlive = reinterpret_cast<int*>(smem + s.live_off);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + s.masks_off);
  uint8_t* flags = smem + s.flags_off;
  auto rows = [&](int k) {
    return reinterpret_cast<float*>(smem + s.rows_off) +
           (size_t)(k % s.nrows) * (s.tile + 1) * s.stride;
  };
  auto rec = [&](int k) {
    return reinterpret_cast<int4*>(smem + s.rec_off) +
           (size_t)(k % s.nouts) * s.tile;
  };
  auto slot = [&](int k) {
    return reinterpret_cast<uint16_t*>(smem + s.slot_off) +
           (size_t)(k % s.nouts) * s.tile;
  };
  auto len = [&](int k) { return min(s.tile, D - k * s.tile); };
  auto stage = [&](int k, int tid, int nthreads, bool producers) {
    stage_tile<MASKED>(eb, row, mask, s.stride, rows(k), slot(k),
                       nlive + k % s.nrows, masks, flags, k * s.tile, len(k),
                       P, tid, nthreads, producers);
  };
  auto back = [&](int k, int tid, int nthreads) {
    write_back(row, rec(k), slot(k), order + o, assignment + o, start + o,
               finish + o, k * s.tile, len(k), tid, nthreads);
  };

  stage(0, threadIdx.x, blockDim.x, false);
  __syncthreads();
  Step step;
  const bool drains = threadIdx.x < Step::kThreads;
  if (drains) step.load(avail_in + (size_t)b * P, P);
  const int nprod = blockDim.x - kWarp;
  for (int k = 0; k < s.ntiles; ++k) {
    if (threadIdx.x < kWarp) {
      if (drains) step.run(rows(k), nlive[k % s.nrows], s.stride, P, rec(k));
    } else {
      const int tid = threadIdx.x - kWarp;
      if (k >= 1) back(k - 1, tid, nprod);
      if (k + 1 < s.ntiles) stage(k + 1, tid, nprod, true);
    }
    __syncthreads();
  }
  back(s.ntiles - 1, threadIdx.x, blockDim.x);
  if (drains) step.store(avail_out + (size_t)b * P, P);
}

// One mapping event per CTA: phase 1 on the whole block, then phase 2.
template <typename Step, bool MASKED>
__global__ void __launch_bounds__(kEventThreads, 2)
event_kernel(const float* __restrict__ keys, const float* __restrict__ exec,
             const float* avail_in, const bool* __restrict__ mask,
             int32_t* __restrict__ order, int32_t* __restrict__ assignment,
             float* __restrict__ start, float* __restrict__ finish,
             float* avail_out, u64* scratch, int D, int P, int N, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  u64* buf = (N <= kSortChunk) ? reinterpret_cast<u64*>(smem)
                               : scratch + (size_t)b * N;
  // above 4096 slots the plan has no sort region, and the sort's chunk
  // buffer is the start of the row ring: sort_queue's closing __syncthreads
  // frees it for drain_event.  (The plan is made after the sort, so that
  // it holds no registers through it.)
  sort_queue(keys + (size_t)b * D, buf, reinterpret_cast<u64*>(smem), D, N);
  const Plan s = plan_event(D, P, N, tile);
  drain_event<Step, MASKED>(s, smem, SortedQueue{buf}, exec, mask, avail_in,
                            avail_out, order, assignment, start, finish, D,
                            P);
}

// Invoke LAUNCH(Step) with the drain step for P lanes: one thread over the
// power of two >= P up to 8 lanes, else a warp over C 32-lane chunks.
#define HEFT_DISPATCH_STEP(P, LAUNCH)                             \
  do {                                                            \
    const int chunks_ = ((P) + heft::kWarp - 1) / heft::kWarp;     \
    if ((P) <= 1) LAUNCH(heft::SmallStep<1>);                     \
    else if ((P) <= 2) LAUNCH(heft::SmallStep<2>);                \
    else if ((P) <= 4) LAUNCH(heft::SmallStep<4>);                \
    else if ((P) <= heft::kSmallPes) LAUNCH(heft::SmallStep<8>);  \
    else if (chunks_ <= 1) LAUNCH(heft::WideStep<1>);             \
    else if (chunks_ <= 2) LAUNCH(heft::WideStep<2>);             \
    else if (chunks_ <= 4) LAUNCH(heft::WideStep<4>);             \
    else if (chunks_ <= 8) LAUNCH(heft::WideStep<8>);             \
    else if (chunks_ <= 16) LAUNCH(heft::WideStep<16>);           \
    else LAUNCH(heft::WideStep<32>);                              \
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
  return n <= kSortChunk ? 0 : n;
}

// The CTA of a staged event of D slots on P lanes (N the sort's slots, 0
// when no sort runs): its ring tile, threads (N / 2, or the queue's
// power of two / 2 without a sort, from 64 to 512: warp 0 and producers,
// and 512 above 4096 slots, as the chunked sort needs) and shared memory.
// False if the event cannot be planned.
struct EventLaunch {
  int tile, threads;
  size_t bytes;
};

inline bool plan_launch(int D, int P, int N, EventLaunch* l) {
  l->tile = pick_tile(D, P, N);
  l->bytes = plan_event(D, P, N, l->tile).bytes;
  int threads = sort_slots(D) / 2;
  if (threads < 2 * kWarp) threads = 2 * kWarp;
  if (threads > kEventThreads) threads = kEventThreads;
  l->threads = threads;
  return l->bytes <= kMaxSmem && l->tile <= 0xFFFF;
}

template <typename Step, bool MASKED>
int launch_event_with(const float* keys, const float* exec,
                      const float* avail_in, const bool* mask, int32_t* order,
                      int32_t* assignment, float* start, float* finish,
                      float* avail_out, u64* scratch, int B, int D, int P,
                      int N, cudaStream_t stream) {
  auto kernel = event_kernel<Step, MASKED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  EventLaunch l;
  if (!plan_launch(D, P, N, &l)) return (int)cudaErrorInvalidValue;
  kernel<<<B, l.threads, l.bytes, stream>>>(keys, exec, avail_in, mask, order,
                                            assignment, start, finish,
                                            avail_out, scratch, D, P, N,
                                            l.tile);
  return (int)cudaGetLastError();
}

template <bool MASKED>
int launch_event(const float* keys, const float* exec, const float* avail_in,
                 const bool* mask, int32_t* order, int32_t* assignment,
                 float* start, float* finish, float* avail_out, u64* scratch,
                 int B, int D, int P, cudaStream_t stream) {
  if (B <= 0 || D <= 0 || P <= 0 || P > kMaxPes || (MASKED && !mask))
    return (int)cudaErrorInvalidValue;
  const int N = sort_slots(D);
  if (N > kSortChunk && !scratch) return (int)cudaErrorInvalidValue;
#define HEFT_LAUNCH(STEP)                                                  \
  return launch_event_with<STEP, MASKED>(keys, exec, avail_in, mask, order, \
                                         assignment, start, finish,        \
                                         avail_out, scratch, B, D, P, N,   \
                                         stream)
  HEFT_DISPATCH_STEP(P, HEFT_LAUNCH);
#undef HEFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace heft
