// K1: generalized advantage estimation over independent columns.
//
// Replaces the Pallas kernel dcc_tpu/ops/pallas_gae.py::_gae_kernel (reached
// through compute_gae_pallas). For t = T-1 .. 0 and every column b:
//   delta = r + gamma * v_next * m_next - v_cur
//   adv   = delta + gamma * lambda * m_next * adv'
//   ret   = adv + v_cur
//
// What bounds it on an H100: 4 reads and 2 writes of 4 bytes per element
// against ~6 operations, so HBM bandwidth (3.35 TB/s) bounds it; at the
// default 16 envs (B = 16) it is one warp and launch latency dominates.
//
// Design: one thread per column with the running advantage in a register;
// threads of a warp walk neighbouring columns, so every load and store of a
// time step is coalesced along B. Each element is read and written once.
#include <cuda_runtime.h>

__global__ void gae_kernel(const float* __restrict__ r, const float* __restrict__ vn,
                           const float* __restrict__ vc, const float* __restrict__ m,
                           float* __restrict__ adv, float* __restrict__ ret, int T,
                           long long B, float gamma, float gamma_lambda) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float gae = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const long long i = (long long)t * B + b;
    const float mt = m[i];
    const float v = vc[i];
    const float delta = r[i] + gamma * vn[i] * mt - v;
    gae = delta + gamma_lambda * mt * gae;
    adv[i] = gae;
    ret[i] = gae + v;
  }
}

extern "C" int dcc_gae(const float* r, const float* vn, const float* vc,
                       const float* m, float* adv, float* ret, int T, long long B,
                       float gamma, float gamma_lambda, void* stream) {
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    gae_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        r, vn, vc, m, adv, ret, T, B, gamma, gamma_lambda);
  return (int)cudaGetLastError();
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
