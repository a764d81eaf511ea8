// HEFT_RT mapping event, fused: the priority sort and the EFT drain in one
// launch, one CTA per event.
//
// Replaces the Pallas TPU kernel src/repro/kernels/heft_fused.py:
// _fused_kernel (the reference fabric's "pallas" backend).
//
// Bound on the card: the serial chain of D drain steps.  The bytes are tiny
// (D*P*4 read plus 16*D written per event), so neither the memory rate nor
// the arithmetic rate limits it; each step waits on the previous step's
// availability register through a warp reduction.  Design: one warp drains
// while the exec row of the next slot is already in flight; the batch runs
// as a grid of independent CTAs.  Several events per CTA (one per warp),
// clusters or a persistent design are the ways to make it faster.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE f32 adds, no FTZ/DAZ).
#include "heft_event.cuh"

extern "C" int heft_fused_scratch_slots(int D) { return heft::scratch_slots(D); }

extern "C" int heft_fused_launch(const float* keys, const float* exec,
                                 const float* avail_in, int32_t* order,
                                 int32_t* assignment, float* start,
                                 float* finish, float* avail_out,
                                 unsigned long long* scratch, int B, int D,
                                 int P, void* stream) {
  return heft::launch_event<false>(keys, exec, avail_in, nullptr, order,
                                   assignment, start, finish, avail_out,
                                   scratch, B, D, P, (cudaStream_t)stream);
}
