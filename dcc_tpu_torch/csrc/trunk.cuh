// Shared device code of the trunk kernels: LN -> [Dense -> act -> LN] x L
// over one tile of BR rows held in shared memory, and the backward of the
// folded chain (every LayerNorm affine absorbed into the next matmul).
//
// Used by fused_mlp.cu (K2, the trunk forward) and fused_ppo.cu (K3/K4, the
// actor and critic PPO loss + gradient kernels).
//
// Numerics follow dcc_tpu/ops/fused_mlp.py and dcc_tpu/ops/fused_ppo.py:
// * LN statistics in f32 with the fast variance max(E[x^2] - E[x]^2, 0),
//   eps 1e-6;
// * f32 mode is full FP32 on the CUDA cores (no TF32 anywhere);
// * bf16 mode rounds every matmul operand to bf16 and accumulates in f32.
//   A bf16 x bf16 product is exact in f32, so plain FMA reproduces "bf16
//   operands, f32 accumulate" up to summation order. The Dense result is
//   rounded to bf16 and the bias is added in bf16; activation and LN
//   statistics run in f32 and the LN output is rounded to bf16.
//
// Layout: a tile is BR rows x width floats, row-major, in shared memory.
// Weights are row-major (d_in, H) as the JAX package stores a Dense kernel,
// so output column j of a product reads W[k * H + j]: consecutive threads
// read consecutive addresses. Weights stream from L2 (a 256 x 256 f32 matrix
// is 256 KB, more than a block's 227 KB of shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DCC_THREADS 256
#define DCC_MAX_LAYERS 8
#define DCC_MAX_OFFS (4 * DCC_MAX_LAYERS + 8)

// Offsets (in floats) of every parameter inside one packed parameter buffer;
// passed by value so the kernel needs no device-side table.
struct DccOffs {
  long long v[DCC_MAX_OFFS];
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? bf16r(x) : x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + BR) of x (R x d, f32 or bf16) into dst (BR x d); rows
// at or beyond R are zero (the ragged last tile is masked, not padded).
template <int BR>
__device__ void load_tile(const void* x, int x_bf16, long long row0,
                          long long R, int d, float* dst) {
  const long long base = row0 * d;
  const long long end = R * d;
  for (int i = threadIdx.x; i < BR * d; i += blockDim.x) {
    const long long off = base + i;
    float v = 0.f;
    if (off < end)
      v = x_bf16 ? __bfloat162float(((const __nv_bfloat16*)x)[off])
                 : ((const float*)x)[off];
    dst[i] = v;
  }
}

// Row-wise LayerNorm of src (BR x d) into dst (may alias src): one warp per
// row, warp-shuffle reductions. y = xhat (* scale + bias when scale is
// given), rounded to bf16 when round_out. Stores 1/sqrt(var + eps) per row
// in inv_out when given (the folded backward needs it).
template <int BR>
__device__ void ln_tile(const float* src, float* dst, int d,
                        const float* scale, const float* bias, bool round_out,
                        float* inv_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < BR; r += nw) {
    const float* s = src + r * d;
    float sum = 0.f, sq = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = s[k];
      sum += v;
      sq += v * v;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mu = sum / d;
    const float var = fmaxf(sq / d - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + 1e-6f);
    if (inv_out != nullptr && lane == 0) inv_out[r] = inv;
    float* o = dst + r * d;
    for (int k = lane; k < d; k += 32) {
      float y = (s[k] - mu) * inv;
      if (scale != nullptr) y = y * scale[k] + bias[k];
      o[k] = round_out ? bf16r(y) : y;
    }
  }
}

// out (BR x H) = act(in (BR x d_in) @ W (d_in x H) + b). One thread per
// output column, BR accumulators in registers; the input element is a
// shared-memory broadcast, the weight a coalesced read from L2.
template <int BR, bool BF16>
__device__ void dense_act_tile(const float* in, int d_in, const float* W,
                               const float* b, int H, bool relu, float* out) {
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float acc[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d_in; ++k) {
      const float w = rnd<BF16>(W[(long long)k * H + j]);
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = fmaf(rnd<BF16>(in[r * d_in + k]), w, acc[r]);
    }
    const float bj = rnd<BF16>(b[j]);
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float z = BF16 ? bf16r(bf16r(acc[r]) + bj) : acc[r] + bj;
      out[r * H + j] = relu ? fmaxf(z, 0.f) : rnd<BF16>(tanhf(z));
    }
  }
}

// Shared-memory cache of the folded trunk forward for one tile.
struct TrunkCache {
  float* a0;   // BR x d_in: input of layer 0 (feature-normalized obs)
  float* act;  // L x BR x H: post-activation r of each layer
  float* xhat; // L x BR x H: un-rounded LN output of each layer
  float* inv;  // L x BR: 1/sqrt(var + eps) of each layer's LN
  float* g;    // BR x H: feature cotangent / backward scratch
};

// Input of layer li: a0 for li == 0, else the previous layer's xhat (read
// through rnd<BF16>, which makes it the bf16-rounded activation).
__device__ __forceinline__ const float* layer_input(const TrunkCache& c,
                                                    int li, int BR, int H) {
  return li == 0 ? c.a0 : c.xhat + (long long)(li - 1) * BR * H;
}

// Folded forward of one tile (dcc_tpu/ops/fused_ppo.py::_fwd_chain_folded).
// Parameter offsets: V_li at offs.v[3*li], u_li at offs.v[3*li+2].
template <int BR, bool BF16>
__device__ void trunk_fwd_folded(const void* x, int x_bf16, long long row0,
                                 long long R, int d_in, int H, int L,
                                 bool use_fn, bool relu, const float* pb,
                                 const DccOffs& offs, const TrunkCache& c) {
  load_tile<BR>(x, x_bf16, row0, R, d_in, c.a0);
  __syncthreads();
  if (use_fn) {
    ln_tile<BR>(c.a0, c.a0, d_in, nullptr, nullptr, BF16, nullptr);
    __syncthreads();
  }
  for (int li = 0; li < L; ++li) {
    const float* in = layer_input(c, li, BR, H);
    const int din = li == 0 ? d_in : H;
    float* act = c.act + (long long)li * BR * H;
    dense_act_tile<BR, BF16>(in, din, pb + offs.v[3 * li], pb + offs.v[3 * li + 2],
                             H, relu, act);
    __syncthreads();
    ln_tile<BR>(act, c.xhat + (long long)li * BR * H, H, nullptr, nullptr, false,
                c.inv + li * BR);
    __syncthreads();
  }
}

// Folded backward (dcc_tpu/ops/fused_ppo.py::_trunk_bwd_folded) from the
// cotangent of the final LN output, held in c.g. Adds this tile's [dV, du]
// per layer into the block's own gradient slot (slot_v[li], slot_u[li]); a
// slot element is owned by one thread, so no atomics are needed. V_li^T
// (d_out x d_in) at offs.v[3*li+1] feeds the propagation to layer li-1.
template <int BR, bool BF16>
__device__ void trunk_bwd_folded(int d_in, int H, int L, bool relu,
                                 const float* pb, const DccOffs& offs,
                                 const TrunkCache& c, float* const* slot_v,
                                 float* const* slot_u) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* g = c.g;
  for (int li = L - 1; li >= 0; --li) {
    float* act = c.act + (long long)li * BR * H;
    const float* xh = c.xhat + (long long)li * BR * H;
    const float* inv = c.inv + li * BR;
    // LN backward without affine, then the activation's derivative
    for (int r = warp; r < BR; r += nw) {
      float* gr = g + r * H;
      const float* xr = xh + r * H;
      float s1 = 0.f, s2 = 0.f;
      for (int k = lane; k < H; k += 32) {
        s1 += gr[k];
        s2 += gr[k] * xr[k];
      }
      s1 = warp_sum(s1) / H;
      s2 = warp_sum(s2) / H;
      const float iv = inv[r];
      const float* ar = act + r * H;
      for (int k = lane; k < H; k += 32) {
        float v = iv * (gr[k] - s1 - xr[k] * s2);
        v = relu ? (ar[k] > 0.f ? v : 0.f) : v * (1.f - ar[k] * ar[k]);
        gr[k] = v;
      }
    }
    __syncthreads();
    // du = column sums of the un-rounded cotangent
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < BR; ++r) s += g[r * H + j];
      slot_u[li][j] += s;
    }
    __syncthreads();
    if (BF16) {
      for (int i = threadIdx.x; i < BR * H; i += blockDim.x) g[i] = bf16r(g[i]);
      __syncthreads();
    }
    // dV = in^T @ g: one thread per (k, j) element of the slot
    const float* in = layer_input(c, li, BR, H);
    const int din = li == 0 ? d_in : H;
    float* sv = slot_v[li];
    for (long long e = threadIdx.x; e < (long long)din * H; e += blockDim.x) {
      const int k = (int)(e / H), j = (int)(e - (long long)k * H);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < BR; ++r) s = fmaf(rnd<BF16>(in[r * din + k]), g[r * H + j], s);
      sv[e] += s;
    }
    if (li > 0) {
      // g_prev (BR x H) = g @ V^T, written over this layer's activation
      // buffer, which the backward no longer needs
      const float* Vt = pb + offs.v[3 * li + 1];  // (H, d_prev), row-major
      for (int k = threadIdx.x; k < din; k += blockDim.x) {
        float acc[BR];
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int j = 0; j < H; ++j) {
          const float w = rnd<BF16>(Vt[(long long)j * din + k]);
#pragma unroll
          for (int r = 0; r < BR; ++r) acc[r] = fmaf(g[r * H + j], w, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < BR; ++r) act[r * din + k] = acc[r];
      }
      __syncthreads();
      g = act;
    }
  }
}
