// Fixed-order reduction of per-block gradient slots, shared by the kernels
// that accumulate parameter gradients over row tiles (fused_ppo.cu,
// fused_mlp_bwd.cu). Each block of such a kernel adds its tiles' gradients
// into its own slot; this pass sums the slots in block order, so the result
// is deterministic and needs no atomics.
#pragma once

#include <cuda_runtime.h>

// out[e] = sum over blocks b (in order) of slots[b][e].
__global__ void reduce_slots_kernel(const float* slots, int n_slots,
                                    long long slot_size, float* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= slot_size) return;
  float s = 0.f;
  for (int b = 0; b < n_slots; ++b) s += slots[(long long)b * slot_size + e];
  out[e] = s;
}

static int reduce(const float* slots, int n_blocks, long long slot_size, float* out,
                  cudaStream_t s) {
  const unsigned grid = (unsigned)((slot_size + 255) / 256);
  reduce_slots_kernel<<<grid, 256, 0, s>>>(slots, n_blocks, slot_size, out);
  return (int)cudaGetLastError();
}
