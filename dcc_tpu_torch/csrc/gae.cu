// K1: generalized advantage estimation over independent columns.
//
// Replaces the Pallas kernel dcc_tpu/ops/pallas_gae.py::_gae_kernel (reached
// through compute_gae_pallas). For every column b and t = T-1 .. 0:
//   delta_t = r_t + gamma * v_{t+1} * m_{t+1} - v_t
//   A_t     = delta_t + gamma * lambda * m_{t+1} * A_{t+1},   A_T = 0
//   R_t     = A_t + v_t
//
// What bounds it on an H100: bytes. rewards (T rows), values (T + 1 rows)
// and masks rows 1..T are read once, adv and ret (T rows each) written
// once: 4 * B * (5T + 1) bytes at 3.35 TB/s, 14.7 us at T = 150 and
// B = 16384. At the default 16 envs that bound is 14 ns, far below a single
// launch; there the cost is the chain of T dependent steps after the loads.
//
// Design: time is cut into S segments of L steps. A block is a stripe of W
// columns times S segments; thread (c, s) owns column c of the stripe and
// the steps of segment s. Lanes sit on neighbouring columns, so each row
// access of a warp is one coalesced run of 4-byte loads or stores.
//  1. Each thread starts every load of its segment at once, into registers,
//     and folds the segment from a zero carry into the affine map
//     A_end -> a_s * A_end + b_s (b_s: the segment's advantage at its first
//     step, a_s: the product of its gamma * lambda * m). A values row is
//     loaded once: the row after a segment's last step is the next segment's
//     first row, which that segment's thread passes through shared memory.
//  2. One thread per column passes the carries from the last segment to the
//     first, one step per segment.
//  3. Each thread reruns its segment from its true carry on the values it
//     holds and stores adv and ret.
// The serial chain is L + S + L steps instead of T. Where T > S * L the block
// walks time in rounds of S * L steps from the end, carrying the advantage
// and the next values row from one round to the next. One launch, no
// atomics, the same bits on every run. Inside a segment the recurrence runs
// in the reference's order; only the segment boundaries re-associate
// (b_s + a_s * carry replaces the nested sum). The (W, S, L) plan comes from
// the caller (dcc_tpu_torch/ops/cuda_gae.py::gae_plan). No matrix product
// here, so no tensor cores.
#include <cuda_runtime.h>

constexpr int kMaxCols = 32;  // W: columns of a block's stripe
constexpr int kMaxThreads = 1024;

// Threads a block may have for CAP steps a thread: 1024 up to 8 steps
// (registers <= 64 a thread), 512 above. The kernel's launch bounds and the
// C entry's check both read it; ops/cuda_gae.py::max_block_threads mirrors it.
constexpr int max_threads(int cap) { return cap <= 8 ? 1024 : 512; }

template <int CAP>  // registers for CAP steps a thread; L <= CAP
__global__ void __launch_bounds__(max_threads(CAP))
gae_seg_kernel(const float* __restrict__ r, const float* __restrict__ v,
               const float* __restrict__ m, float* __restrict__ adv,
               float* __restrict__ ret, int T, long long B, int L, float gamma,
               float gamma_lambda) {
  __shared__ float fold_a[kMaxThreads], fold_b[kMaxThreads], carry[kMaxThreads];
  __shared__ float head[kMaxThreads];  // values row at each segment's first step
  __shared__ float round_carry[kMaxCols], round_head[kMaxCols];
  const int W = blockDim.x, S = blockDim.y, c = threadIdx.x, s = threadIdx.y;
  const int k = s * W + c;
  const long long b = (long long)blockIdx.x * W + c;
  float x[CAP], y[CAP], z[CAP];  // r then delta; v_t; m_{t+1} then gamma*lambda*m_{t+1}

  for (int t1 = T; t1 > 0; t1 -= S * L) {  // one round: steps [t0, t1)
    const int t0 = max(t1 - S * L, 0);
    const int start = t0 + s * L;
    const int n = b < B ? max(0, min(start + L, t1) - start) : 0;

    // phase 1: all loads of the segment in flight together, then the fold
    float v_end = 0.f;
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      if (i < n) {
        const long long o = (long long)(start + i) * B + b;
        x[i] = r[o];
        y[i] = v[o];
        z[i] = m[o + B];
      }
    }
    if (n > 0 && start + n == T) v_end = v[(long long)T * B + b];
    if (n > 0) head[k] = y[0];
    __syncthreads();
    if (n > 0 && start + n < T)  // the next row is another segment's first
      v_end = start + n == t1 ? round_head[c] : head[k + W];
    float fa = 1.f, fb = 0.f;
#pragma unroll
    for (int i = CAP - 1; i >= 0; --i) {
      if (i < n) {
        const float vn = i + 1 < n ? y[i + 1 < CAP ? i + 1 : i] : v_end;
        x[i] = x[i] + gamma * vn * z[i] - y[i];
        z[i] = gamma_lambda * z[i];
        fb = x[i] + z[i] * fb;
        fa *= z[i];
      }
    }
    fold_a[k] = fa;
    fold_b[k] = fb;
    __syncthreads();

    // phase 2: the carries, from the last segment to the first
    if (s == 0) {
      float A = t1 == T ? 0.f : round_carry[c];
      for (int j = S - 1; j >= 0; --j) {
        carry[j * W + c] = A;
        A = fold_b[j * W + c] + fold_a[j * W + c] * A;
      }
    }
    __syncthreads();

    // phase 3: the segment again from its true carry
    float A = carry[k];
#pragma unroll
    for (int i = CAP - 1; i >= 0; --i) {
      if (i < n) {
        A = x[i] + z[i] * A;
        const long long o = (long long)(start + i) * B + b;
        adv[o] = A;
        ret[o] = A + y[i];
      }
    }
    if (s == 0 && n > 0) {  // what the next (earlier) round starts from
      round_carry[c] = A;
      round_head[c] = y[0];
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, int,
                       long long, int, float, float);
// one instance per register capacity CAP = 4, 8, .., 32 steps a thread
static const Kernel kKernels[] = {
    gae_seg_kernel<4>,  gae_seg_kernel<8>,  gae_seg_kernel<12>, gae_seg_kernel<16>,
    gae_seg_kernel<20>, gae_seg_kernel<24>, gae_seg_kernel<28>, gae_seg_kernel<32>};

// rewards (T, B), values and masks (T + 1, B), adv and ret (T, B): f32,
// contiguous. W columns and S segments of L steps per block.
extern "C" int dcc_gae_seg(const float* r, const float* v, const float* m, float* adv,
                           float* ret, int T, long long B, int W, int S, int L,
                           float gamma, float gamma_lambda, void* stream) {
  if (W < 1 || W > kMaxCols || S < 1 || L < 1 || L > 32 ||
      W * S > max_threads((L + 3) / 4 * 4))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (B + W - 1) / W;
  if (T <= 0 || blocks <= 0) return 0;
  kKernels[(L + 3) / 4 - 1]<<<(unsigned)blocks, dim3(W, S), 0, (cudaStream_t)stream>>>(
      r, v, m, adv, ret, T, B, L, gamma, gamma_lambda);
  return (int)cudaGetLastError();
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
