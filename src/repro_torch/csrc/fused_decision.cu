// HEFT_RT mapping event with a device-resident PE mask: the fused_decision
// kernel, one CTA per event.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_decision.py:
// _decision_kernel (the reference fabric's "fused" backend, and the decision
// the paged decode tick inlines).
//
// The mask is a bool[P] register shared by the batch; a masked lane's exec
// read becomes +inf, the select of decision_ref (where(mask, inf, exec)).
// For exec in [0, +inf] this equals the reference kernel's additive mask row
// (exec + 0 on live lanes, exec + inf on masked ones), and with an
// all-False mask the kernel computes exactly what heft_fused.cu computes.
//
// Bound on the card: the serial chain of D drain steps, as in heft_fused.cu
// (D*P*4 + P bytes read, 16*D written per event).  Same design, the same
// event_kernel of heft_event.cuh: the sort in registers and shared memory
// (chunks of 4096 keys and scratch passes above 4096 slots), the rows
// staged in shared memory with the mask applied there, so the step never
// sees it, and a row that the mask leaves all +inf is skipped like any
// other no-op row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: IEEE f32 adds, no FTZ/DAZ).
#include "heft_event.cuh"

extern "C" int fused_decision_scratch_slots(int D) {
  return heft::scratch_slots(D);
}

extern "C" int fused_decision_launch(const float* keys, const float* exec,
                                     const float* avail_in, const bool* mask,
                                     int32_t* order, int32_t* assignment,
                                     float* start, float* finish,
                                     float* avail_out,
                                     unsigned long long* scratch, int B,
                                     int D, int P, void* stream) {
  return heft::launch_event<true>(keys, exec, avail_in, mask, order,
                                  assignment, start, finish, avail_out,
                                  scratch, B, D, P, (cudaStream_t)stream);
}
