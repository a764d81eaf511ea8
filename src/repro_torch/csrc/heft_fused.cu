// HEFT_RT mapping event, fused: the priority sort and the EFT drain in one
// launch, one CTA per event.
//
// Replaces the Pallas TPU kernel src/repro/kernels/heft_fused.py:
// _fused_kernel (the reference fabric's "pallas" backend).
//
// Bound on the card: the serial chain of D drain steps.  The bytes are tiny
// (D*P*4 read plus 16*D written per event), so neither the memory rate nor
// the arithmetic rate limits it; each step waits on the previous step's
// availability registers.  A one-warp drain reading its rows from device
// memory took ~0.45 us a step at every shape, for 4 adds and 3 compares at
// P = 4, because:
//   - the next row was a dependent gather from device memory (slot from the
//     sorted buffer, then the row), fetched one step ahead;
//   - the first minimum was a 5-level butterfly of 3 shuffles a level over
//     32 lanes, 28 of which hold nothing at P = 4;
//   - lane 0 stored 4 scalars to device memory every step;
//   - the drain walked the whole power-of-two bucket, +inf padding included;
//   - the other warps of the CTA sat idle after the sort.
// Design (event_kernel in heft_event.cuh), cause by cause:
//   - after the sort the block stages the event's rows in shared memory:
//     it flags the live ones (a lane other than +inf once the PE mask is
//     applied), numbers them by a prefix sum of the flags and copies them
//     in drain order, so the drain reads row i at a fixed stride, the next
//     one ahead, with no dependent load;
//   - an event too large for 227 KB streams through a ring of two row
//     tiles that warps 1.. fill while warp 0 drains (named barrier 1 among
//     the producers, one __syncthreads per tile);
//   - at P <= 8 one thread holds every register: a strict less-than tree
//     picks the first minimum and a min.NaN tree beside it gives the
//     finite guard, no shuffle; above, one warp takes the least finish
//     rank and then the least lane with two redux.sync;
//   - one 16-byte record per step goes to shared memory, and the block
//     writes the outputs back coalesced, per tile;
//   - rows that are +inf on every lane (the fabric's padding, unsupported
//     tasks, lanes masked off) are never drained: they always give
//     (-1, +inf, +inf) and never touch a register, whatever the registers
//     hold, so the write-back fills them in;
//   - CTAs of 512 threads, two an SM, so a batch of 256 events runs in one
//     wave on 132 SMs.
//   - the sort (sort_queue) keeps its composite keys in registers, 4 a
//     thread at D = 2048: the stages whose pairs lie within a warp are
//     register compares and shuffles, and only those of partner distance
//     >= 128 pass through shared memory behind a barrier (10 of 66);
//     above 4096 slots chunks of 4096 sort in shared memory (aliasing the
//     row ring, free until the sort ends) and only the stages of distance
//     >= 4096 pass over the scratch tensor.
// What bounds it now: the step's dependent chain in one thread (an add,
// log2 P compare-and-select levels, the guard, the latch), then the sort's
// shuffle stages (PERF.md has the split).
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
