// The shift-register priority queue as a kernel: a stable descending sort of
// keys[B, D] (f32, bf16, f16 or i32) carrying an int32 payload[B, D], one
// CTA per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/oddeven_sort.py:
// _sort_kernel (the odd-even transposition network, reached through
// repro.kernels.oddeven_sort).
//
// Semantics (held bitwise against the plain version beside the wrapper,
// repro_torch.kernels.oddeven_sort.sort_plain): the order of
// torch.argsort(-keys.float(), stable=True) for float keys (NaN last, -0.0
// ties with +0.0; bf16 and f16 compare as the f32 values they widen to) and
// of torch.sort(keys, descending=True, stable=True) for i32 keys (the exact
// integer compare).  The outputs are gathered from the inputs by the sorted
// slot, bit for bit in the keys' own width, so -0.0 and NaN payloads come
// back as given.
// Padding slots (D up to the power of two N) sort after every real slot.
//
// Bound on the card: bytes (16 per slot for 32-bit keys: key and payload
// read once, written once); the compares are a few integer operations per slot and stage.  The
// network has log2(N)(log2(N)+1)/2 stages, each a block-wide pass over N/2
// pairs behind a __syncthreads, so at the shapes of the main path the
// barriers, not the bytes, set the time.  Design: phase 1 of heft_event.cuh
// (the composite keys in 32 KB of shared memory up to 4096 slots, in a
// scratch tensor above), then one coalesced gather pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).
#include <type_traits>

#include "heft_event.cuh"

namespace {

template <typename K>
__global__ void __launch_bounds__(heft::kMaxThreads)
sort_kernel(const K* __restrict__ keys, const int32_t* __restrict__ payload,
            K* __restrict__ keys_out, int32_t* __restrict__ payload_out,
            unsigned long long* scratch, int D, int N) {
  extern __shared__ unsigned long long smem[];
  const int b = blockIdx.x;
  unsigned long long* buf =
      (N <= heft::kSmemSortSlots) ? smem : scratch + (size_t)b * N;
  const size_t row = (size_t)b * D;
  heft::sort_queue(keys + row, buf, D, N);
  // Keys move as raw words of their own width: no float operation (and no
  // NaN canonicalisation) touches them.
  using Bits = typename std::conditional<sizeof(K) == 2, uint16_t,
                                         uint32_t>::type;
  const Bits* kin = reinterpret_cast<const Bits*>(keys + row);
  Bits* kout = reinterpret_cast<Bits*>(keys_out + row);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const int s = (int)(uint32_t)buf[i];
    kout[i] = kin[s];
    payload_out[row + i] = payload[row + s];
  }
}

}  // namespace

extern "C" int oddeven_sort_scratch_slots(int D) {
  return heft::scratch_slots(D);
}

template <typename K>
void launch_sort(const void* keys, const int32_t* payload, void* keys_out,
                 int32_t* payload_out, unsigned long long* scratch, int B,
                 int D, int N, int threads, size_t smem, cudaStream_t s) {
  sort_kernel<K><<<B, threads, smem, s>>>((const K*)keys, payload,
                                          (K*)keys_out, payload_out, scratch,
                                          D, N);
}

// key_kind: 0 f32, 1 i32, 2 bf16, 3 f16.
extern "C" int oddeven_sort_launch(const void* keys, const int32_t* payload,
                                   void* keys_out, int32_t* payload_out,
                                   unsigned long long* scratch, int key_kind,
                                   int B, int D, void* stream) {
  if (B <= 0 || D <= 0 || key_kind < 0 || key_kind > 3)
    return (int)cudaErrorInvalidValue;
  const int N = heft::sort_slots(D);
  if (N > heft::kSmemSortSlots && !scratch) return (int)cudaErrorInvalidValue;
  int threads = N / 2;
  if (threads < heft::kWarp) threads = heft::kWarp;
  if (threads > heft::kMaxThreads) threads = heft::kMaxThreads;
  const size_t smem = N <= heft::kSmemSortSlots ? (size_t)N * 8 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (key_kind) {
    case 0: launch_sort<float>(keys, payload, keys_out, payload_out, scratch,
                               B, D, N, threads, smem, s); break;
    case 1: launch_sort<int32_t>(keys, payload, keys_out, payload_out,
                                 scratch, B, D, N, threads, smem, s); break;
    case 2: launch_sort<heft::Bf16Bits>(keys, payload, keys_out, payload_out,
                                        scratch, B, D, N, threads, smem, s);
            break;
    default: launch_sort<heft::F16Bits>(keys, payload, keys_out, payload_out,
                                        scratch, B, D, N, threads, smem, s);
  }
  return (int)cudaGetLastError();
}
