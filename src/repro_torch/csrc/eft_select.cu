// The PE-handler / EFT-selector loop as a kernel: the drain of a ready queue
// already in priority order, one warp per event.
//
// Replaces the Pallas TPU kernel src/repro/kernels/eft_select.py:
// _eft_kernel (reached through repro.kernels.eft_select).
//
// Semantics (held bitwise against repro_torch.kernels.ref.eft_select_ref,
// which is repro_torch.core.heft_rt.eft_assign): step t reads exec row t,
// forms finish = avail + exec with IEEE f32 adds, takes the first minimum
// and latches it into avail[pe] if it is finite (the isfinite guard of
// repro.core.heft_rt: a -inf register yields -1 / +inf, where the Pallas
// kernel's fmin < inf guard would assign it).
//
// Layout: exec f32[B, D, P] in priority order, avail f32[B, P]; outputs
// assignment i32[B, D], start/finish f32[B, D], new avail f32[B, P] (may
// alias avail: each warp reads its row before it writes it).
//
// Bound on the card: the serial chain of D drain steps (the bytes, D*P*4
// read and 12*D written per event, take a fraction of it).  Design: the
// one-warp drain of heft_event.cuh (drain), rows read in queue order, the
// next exec row prefetched while the current step reduces; one 32-thread
// CTA per event.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE f32 adds, no FTZ/DAZ).
#include "heft_event.cuh"

namespace {

template <int C>
__global__ void __launch_bounds__(heft::kWarp)
eft_kernel(const float* __restrict__ exec, const float* avail_in,
           int32_t* __restrict__ assignment, float* __restrict__ start,
           float* __restrict__ finish, float* avail_out, int D, int P) {
  const int b = blockIdx.x;
  const size_t o = (size_t)b * D;
  heft::drain<C>(exec + o * P, avail_in + (size_t)b * P, assignment + o,
                 start + o, finish + o, avail_out + (size_t)b * P, D, P);
}

}  // namespace

extern "C" int eft_select_launch(const float* exec, const float* avail_in,
                                 int32_t* assignment, float* start,
                                 float* finish, float* avail_out, int B,
                                 int D, int P, void* stream) {
  if (B <= 0 || D <= 0 || P <= 0 || P > heft::kMaxPes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using heft::kWarp;
#define EFT_LAUNCH(CH)                                                 \
  eft_kernel<CH><<<B, heft::kWarp, 0, s>>>(exec, avail_in, assignment, \
                                           start, finish, avail_out, D, P)
  HEFT_DISPATCH_CHUNKS(P, EFT_LAUNCH);
#undef EFT_LAUNCH
  return (int)cudaGetLastError();
}
