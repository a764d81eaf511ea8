// The PE-handler / EFT-selector loop as a kernel: the drain of a ready queue
// already in priority order, one CTA per event.
//
// Replaces the Pallas TPU kernel src/repro/kernels/eft_select.py:
// _eft_kernel (reached through repro.kernels.eft_select).
//
// Semantics (held bitwise against repro_torch.kernels.ref.eft_select_ref,
// which is repro_torch.core.heft_rt.eft_assign; the step-by-step mirror is
// repro_torch.kernels.ref.eft_select_sim): step t reads exec row t, forms
// finish = avail + exec with IEEE f32 adds, takes the first minimum and
// latches it into avail[pe] if it is finite (the isfinite guard of
// repro.core.heft_rt: a -inf register yields -1 / +inf, where the Pallas
// kernel's fmin < inf guard would assign it).
//
// Layout: exec f32[B, D, P] in priority order, avail f32[B, P]; outputs
// assignment i32[B, D], start/finish f32[B, D], new avail f32[B, P] (may
// alias avail: each CTA reads its registers before it writes them).
//
// Bound on the card: the serial chain of D drain steps (the bytes, D*P*4
// read and 12*D written per event, take a fraction of it).  Design: phase 2
// of event_kernel (drain_event in heft_event.cuh) with the identity as
// position -> row and no order output: the rows staged in shared memory in
// drain order, rows +inf on every lane flagged by ballot and skipped, one
// thread steps up to P = 8 and a warp above, a ring of row tiles when the
// event does not fit in 227 KB, one 16-byte record per step written back
// coalesced; 512-thread CTAs, two an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE f32 adds, no FTZ/DAZ).
#include "heft_event.cuh"

namespace {

template <typename Step>
__global__ void __launch_bounds__(heft::kEventThreads, 2)
eft_kernel(const float* __restrict__ exec, const float* avail_in,
           int32_t* __restrict__ assignment, float* __restrict__ start,
           float* __restrict__ finish, float* avail_out, int D, int P,
           int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const heft::Plan s = heft::plan_event(D, P, 0, tile);
  heft::drain_event<Step, false>(s, smem, heft::QueueOrder{}, exec, nullptr,
                                 avail_in, avail_out, nullptr, assignment,
                                 start, finish, D, P);
}

template <typename Step>
int launch_eft(const float* exec, const float* avail_in, int32_t* assignment,
               float* start, float* finish, float* avail_out, int B, int D,
               int P, cudaStream_t stream) {
  auto kernel = eft_kernel<Step>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)heft::kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  heft::EventLaunch l;
  if (!heft::plan_launch(D, P, 0, &l)) return (int)cudaErrorInvalidValue;
  kernel<<<B, l.threads, l.bytes, stream>>>(exec, avail_in, assignment, start,
                                            finish, avail_out, D, P, l.tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eft_select_launch(const float* exec, const float* avail_in,
                                 int32_t* assignment, float* start,
                                 float* finish, float* avail_out, int B,
                                 int D, int P, void* stream) {
  if (B <= 0 || D <= 0 || P <= 0 || P > heft::kMaxPes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define EFT_LAUNCH(STEP)                                                   \
  return launch_eft<STEP>(exec, avail_in, assignment, start, finish,       \
                          avail_out, B, D, P, s)
  HEFT_DISPATCH_STEP(P, EFT_LAUNCH);
#undef EFT_LAUNCH
  return (int)cudaErrorInvalidValue;
}
