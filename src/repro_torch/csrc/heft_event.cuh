// The two phases of a HEFT_RT mapping event as device functions, and the
// one-event-per-CTA kernel built from them.  heft_fused.cu and
// fused_decision.cu launch event_kernel (both phases); oddeven_sort.cu runs
// phase 1 alone (sort_queue) and eft_select.cu phase 2 alone, on the
// one-warp drain (drain).
//
// Semantics (the port's plain versions, repro_torch.kernels.ref.heft_fused_ref
// and repro_torch.kernels.fused_decision.decision_ref, hold it bitwise; the
// step-by-step mirror of event_kernel is repro_torch.kernels.ref.heft_event_sim):
//   1. Priority sort (sort_queue): stable descending by key, NaN keys after
//      -inf (the order of torch.argsort(-keys, stable=True)).  Sorted as a
//      bitonic network over composite 64-bit keys (rank of the key, slot),
//      which are unique, so the result is the stable order.  -0.0 ranks with
//      +0.0; int32 keys rank by the exact integer order.
//   2. Drain: D serial steps.  Step t reads the exec row of the t-th slot
//      (with the PE mask applied as +inf), forms finish = avail + exec with
//      IEEE f32 adds over the P lanes, takes the first minimum (a NaN finish
//      wins, as in jnp/np argmin), and, if that finish is finite, latches it
//      into avail[pe].  Otherwise the step reports -1 with start and finish
//      +inf.
//
// event_kernel runs phase 2 on the card's terms (the notes at the top of
// heft_fused.cu say why): the rows are staged in shared memory in drain
// order, rows whose every lane is +inf are flagged and skipped (they always
// give (-1, +inf, +inf) and never touch a register, whatever the registers
// hold: -inf + inf is NaN, which is not finite), the step is short, and the
// outputs leave the block coalesced.
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

// Does candidate (va, ia) beat (vb, ib)?  NaN first, then the smaller value,
// then the lower lane: a strict total order, so a butterfly reduction gives
// every lane the same winner, the first minimum.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na != nb) return na;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

// Rank of a finish whose ascending order is better()'s value order: NaN
// first, then by value, -0.0 tied with +0.0.
__device__ __forceinline__ uint32_t finish_rank(float f) {
  if (isnan(f)) return 0u;                 // -inf ranks 0x007FFFFF
  if (f == 0.0f) f = 0.0f;
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

// ---- phase 2 alone: the one-warp drain of eft_select.cu -------------------
// Called by the 32 threads of one warp, lanes strided over the P PEs.  eb is
// the event's exec f32[D, P] in priority order (row t read at step t),
// av_row / av_out its registers (may alias: the row is read before it is
// written), and assignment / start / finish the event's i32/f32[D] outputs.
template <int C>
__device__ __forceinline__ void drain(const float* eb, const float* av_row,
                                      int32_t* assignment, float* start,
                                      float* finish, float* av_out, int D,
                                      int P) {
  const int lane = threadIdx.x;
  float av[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    av[c] = (p < P) ? av_row[p] : 0.0f;
  }
  float ex[C], exn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) exn[c] = 0.0f;
  load_row(ex, eb, lane, P);
  for (int t = 0; t < D; ++t) {
    // fetch the next row while this step's reduction runs (only avail
    // carries a dependency)
    if (t + 1 < D) load_row(exn, eb + (size_t)(t + 1) * P, lane, P);
    float bv = f32_inf();
    int bi = 0x7fffffff;
    float bs = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int p = lane + c * kWarp;
      if (p < P) {
        const float f = __fadd_rn(av[c], ex[c]);
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
      assignment[t] = ok ? bi : -1;
      start[t] = ok ? bs : f32_inf();
      finish[t] = ok ? bv : f32_inf();
    }
#pragma unroll
    for (int c = 0; c < C; ++c) ex[c] = exn[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = lane + c * kWarp;
    if (p < P) av_out[p] = av[c];
  }
}

// ---- phase 2 of event_kernel: staged rows, live rows only ------------------
// The sorted positions are cut into tiles of `tile` positions.  Staging a
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

__host__ __device__ inline Plan plan_event(int D, int P, int N, int tile) {
  Plan s;
  s.tile = tile;
  s.ntiles = (D + tile - 1) / tile;
  s.stride = (P + 3) & ~3;
  s.nrows = s.ntiles > 1 ? 2 : 1;
  s.nouts = s.ntiles > 1 ? 3 : 1;
  size_t off = N <= kSmemSortSlots ? (size_t)N * 8 : 0;   // the sort's keys
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

// Stage positions [t0, t0 + len) of the sorted queue (see the note above):
// live rows copied in order into `rows`, `slot` per position, the number of
// live rows into *nlive.  Called by `nthreads` threads (a multiple of 32),
// tid their index among them; the caller synchronises after it.
template <bool MASKED>
__device__ void stage_tile(const float* eb, const unsigned long long* buf,
                           const bool* mask, int stride, float* rows,
                           uint16_t* slot, int* nlive, uint32_t* masks,
                           uint8_t* flags, int t0, int len, int P, int tid,
                           int nthreads, bool producers) {
  const int lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int nwarps = nthreads / kWarp;
  const float inf = f32_inf();
  const bool small = P <= kSmallPes;
  uint32_t mbits = 0;
  if (MASKED && small)
    for (int p = 0; p < P; ++p) mbits |= (uint32_t)mask[p] << p;
  auto src = [&](int t) {
    return eb + (size_t)(uint32_t)buf[t0 + t] * P;
  };
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
// minimum is finite, the step's guard (a NaN lane wins in better(), and
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

// Copy tile positions [0, len) of the outputs to device memory, coalesced:
// order from the sorted buffer, the rest from the position's record.
__device__ __forceinline__ void write_back(const unsigned long long* buf,
                                           const int4* rec,
                                           const uint16_t* slot,
                                           int32_t* order,
                                           int32_t* assignment, float* start,
                                           float* finish, int t0, int len,
                                           int tid, int nthreads) {
  for (int t = tid; t < len; t += nthreads) {
    const int g = t0 + t;
    const int d = slot[t];
    const int4 r = d == kNoop ? record(false, 0, 0.0f, 0.0f) : rec[d];
    order[g] = (int)(uint32_t)buf[g];
    assignment[g] = r.x;
    start[g] = __int_as_float(r.y);
    finish[g] = __int_as_float(r.z);
  }
}

// One mapping event per CTA: phase 1 on the whole block; phase 2 with the
// rows staged by the block (tile 0) and then by warps 1.. (the rest of the
// ring) while warp 0 (Step::kThreads of it) drains.
template <typename Step, bool MASKED>
__global__ void __launch_bounds__(kEventThreads, 2)
event_kernel(const float* __restrict__ keys, const float* __restrict__ exec,
             const float* avail_in, const bool* __restrict__ mask,
             int32_t* __restrict__ order, int32_t* __restrict__ assignment,
             float* __restrict__ start, float* __restrict__ finish,
             float* avail_out, unsigned long long* scratch,
             int D, int P, int N, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan s = plan_event(D, P, N, tile);
  const int b = blockIdx.x;
  unsigned long long* buf =
      (N <= kSmemSortSlots) ? reinterpret_cast<unsigned long long*>(smem)
                            : scratch + (size_t)b * N;
  sort_queue(keys + (size_t)b * D, buf, D, N);

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
    stage_tile<MASKED>(eb, buf, mask, s.stride, rows(k), slot(k),
                       nlive + k % s.nrows, masks, flags, k * s.tile, len(k),
                       P, tid, nthreads, producers);
  };
  auto back = [&](int k, int tid, int nthreads) {
    write_back(buf, rec(k), slot(k), order + o, assignment + o, start + o,
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

template <typename Step, bool MASKED>
int launch_event_with(const float* keys, const float* exec,
                      const float* avail_in, const bool* mask, int32_t* order,
                      int32_t* assignment, float* start, float* finish,
                      float* avail_out, unsigned long long* scratch, int B,
                      int D, int P, int N, cudaStream_t stream) {
  auto kernel = event_kernel<Step, MASKED>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int tile = pick_tile(D, P, N);
  const Plan s = plan_event(D, P, N, tile);
  if (s.bytes > kMaxSmem || tile > 0xFFFF) return (int)cudaErrorInvalidValue;
  int threads = N / 2;
  if (threads < 2 * kWarp) threads = 2 * kWarp;  // warp 0 + producers
  if (threads > kEventThreads) threads = kEventThreads;
  kernel<<<B, threads, s.bytes, stream>>>(keys, exec, avail_in, mask, order,
                                          assignment, start, finish,
                                          avail_out, scratch, D, P, N, tile);
  return (int)cudaGetLastError();
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
#define HEFT_LAUNCH(STEP)                                                  \
  return launch_event_with<STEP, MASKED>(keys, exec, avail_in, mask, order, \
                                         assignment, start, finish,        \
                                         avail_out, scratch, B, D, P, N,   \
                                         stream)
#define HEFT_LAUNCH_WIDE(CH) HEFT_LAUNCH(WideStep<CH>)
  if (P <= 1) HEFT_LAUNCH(SmallStep<1>);
  if (P <= 2) HEFT_LAUNCH(SmallStep<2>);
  if (P <= 4) HEFT_LAUNCH(SmallStep<4>);
  if (P <= kSmallPes) HEFT_LAUNCH(SmallStep<8>);
  HEFT_DISPATCH_CHUNKS(P, HEFT_LAUNCH_WIDE);
#undef HEFT_LAUNCH_WIDE
#undef HEFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace heft
