// Shared device code of the trunk kernels: LN -> [Dense -> act -> LN] x L
// over one tile of BR rows held in shared memory, and its backward, both for
// the folded chain (every LayerNorm affine absorbed into the next matmul)
// and for the unfolded one (the affines applied as written).
//
// Used by fused_mlp.cu (K2, the trunk forward), fused_mlp_bwd.cu (K2b, the
// trunk backward) and fused_ppo.cu (K3/K4 folded and K3u/K4u unfolded, the
// actor and critic PPO loss + gradient kernels).
//
// Numerics follow dcc_tpu/ops/fused_mlp.py and dcc_tpu/ops/fused_ppo.py in
// f32: LN statistics with the fast variance max(E[x^2] - E[x]^2, 0), eps
// 1e-6, and full FP32 on the CUDA cores (no TF32 anywhere). The bf16 mode
// runs on the tensor cores (trunk_mma.cuh).
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

// Parameter offsets: every kernel takes `offs`, a device table of long long
// offsets (in elements) of each parameter inside its packed buffer, built
// once per trunk shape by the wrapper (ops.cuda_build.offsets_table), so a
// trunk of any depth needs no compile-time bound.

// The folded gradient slot (floats): per layer [dV (d_li x H), du (H)], then
// the head's gradients; with dv0_apart (the chunked K3 / K4) without layer 0's
// dV, which a second kernel computes. Each part is located from the layer's
// index, so no per-layer table is held.
struct FoldedSlot {
  float* slot;
  long long d0;  // floats of layer 0's dV in the slot (0 with dv0_apart)
  long long H;

  __host__ __device__ FoldedSlot(float* s, int d_in, int h, bool dv0_apart = false)
      : slot(s), d0(dv0_apart ? 0 : (long long)d_in * h), H(h) {}
  // start of layer li's part; at li = L, the head's
  __device__ __forceinline__ long long base(int li) const {
    return li == 0 ? 0 : d0 + H + (long long)(li - 1) * (H * H + H);
  }
  __device__ __forceinline__ float* v(int li) const { return slot + base(li); }
  __device__ __forceinline__ float* u(int li) const {
    return slot + base(li) + (li == 0 ? d0 : H * H);
  }
  __device__ __forceinline__ float* head(int L) const { return slot + base(L); }
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// given). Stores 1/sqrt(var + eps) per row in inv_out when given (the
// backward needs it).
template <int BR>
__device__ void ln_tile(const float* src, float* dst, int d,
                        const float* scale, const float* bias, float* inv_out) {
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
      o[k] = y;
    }
  }
}

// out (BR x H) = act(in (BR x d_in) @ W (d_in x H) + b). One thread per
// output column, BR accumulators in registers; the input element is a
// shared-memory broadcast, the weight a coalesced read from L2.
template <int BR>
__device__ void dense_act_tile(const float* in, int d_in, const float* W,
                               const float* b, int H, bool relu, float* out) {
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float acc[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < d_in; ++k) {
      const float w = W[(long long)k * H + j];
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r] = fmaf(in[r * d_in + k], w, acc[r]);
    }
    const float bj = b[j];
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float z = acc[r] + bj;
      out[r * H + j] = relu ? fmaxf(z, 0.f) : tanhf(z);
    }
  }
}

// Shared-memory cache of the folded trunk forward for one tile.
struct TrunkCache {
  float* a0;   // BR x d_in: input of layer 0 (feature-normalized obs)
  float* act;  // L x BR x H: post-activation r of each layer
  float* xhat; // L x BR x H: LN output of each layer
  float* inv;  // L x BR: 1/sqrt(var + eps) of each layer's LN
  float* g;    // BR x H: feature cotangent / backward scratch
};

// Input of layer li: a0 for li == 0, else the previous layer's xhat.
__device__ __forceinline__ const float* layer_input(const TrunkCache& c,
                                                    int li, int BR, int H) {
  return li == 0 ? c.a0 : c.xhat + (long long)(li - 1) * BR * H;
}

// Folded forward of one tile (dcc_tpu/ops/fused_ppo.py::_fwd_chain_folded).
// Parameter offsets: V_li at offs[3*li], u_li at offs[3*li+2].
template <int BR>
__device__ void trunk_fwd_folded(const void* x, int x_bf16, long long row0,
                                 long long R, int d_in, int H, int L,
                                 bool use_fn, bool relu, const float* pb,
                                 const long long* offs, const TrunkCache& c) {
  load_tile<BR>(x, x_bf16, row0, R, d_in, c.a0);
  __syncthreads();
  if (use_fn) {
    ln_tile<BR>(c.a0, c.a0, d_in, nullptr, nullptr, nullptr);
    __syncthreads();
  }
  for (int li = 0; li < L; ++li) {
    const float* in = layer_input(c, li, BR, H);
    const int din = li == 0 ? d_in : H;
    float* act = c.act + (long long)li * BR * H;
    dense_act_tile<BR>(in, din, pb + offs[3 * li], pb + offs[3 * li + 2], H, relu, act);
    __syncthreads();
    ln_tile<BR>(act, c.xhat + (long long)li * BR * H, H, nullptr, nullptr, c.inv + li * BR);
    __syncthreads();
  }
}

// Folded backward (dcc_tpu/ops/fused_ppo.py::_trunk_bwd_folded) from the
// cotangent of the final LN output, held in c.g. Adds this tile's [dV, du]
// per layer into the block's own gradient slot (fs.v(li), fs.u(li)); a
// slot element is owned by one thread, so no atomics are needed. V_li^T
// (d_out x d_in) at offs[3*li+1] feeds the propagation to layer li-1.
template <int BR>
__device__ void trunk_bwd_folded(int d_in, int H, int L, bool relu,
                                 const float* pb, const long long* offs,
                                 const TrunkCache& c, const FoldedSlot& fs) {
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
      fs.u(li)[j] += s;
    }
    __syncthreads();
    // dV = in^T @ g: one thread per (k, j) element of the slot
    const float* in = layer_input(c, li, BR, H);
    const int din = li == 0 ? d_in : H;
    float* sv = fs.v(li);
    for (long long e = threadIdx.x; e < (long long)din * H; e += blockDim.x) {
      const int k = (int)(e / H), j = (int)(e - (long long)k * H);
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < BR; ++r) s = fmaf(in[r * din + k], g[r * H + j], s);
      sv[e] += s;
    }
    if (li > 0) {
      // g_prev (BR x H) = g @ V^T, written over this layer's activation
      // buffer, which the backward no longer needs
      const float* Vt = pb + offs[3 * li + 1];  // (H, d_prev), row-major
      for (int k = threadIdx.x; k < din; k += blockDim.x) {
        float acc[BR];
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] = 0.f;
#pragma unroll 4
        for (int j = 0; j < H; ++j) {
          const float w = Vt[(long long)j * din + k];
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

// ---------------------------------------------------------------------------
// Unfolded chain (dcc_tpu/ops/fused_mlp.py::_forward_chain / _bwd_kernel):
// the LN affines are applied as written, so the backward also yields the
// gradients of every LN scale and bias. Parameter offsets as K2's: feature
// norm scale / bias at offs[0] / offs[1], layer li's W (d_li x H), b, LN
// scale, LN bias at offs[2+4li] .. offs[5+4li]; W_li^T (H x d_li) at
// offs[2+4L+li].
// ---------------------------------------------------------------------------

// Shared-memory cache of the unfolded forward for one tile of BR rows.
struct UnfoldedCache {
  float* xf;   // BR x d_in: feature-norm xhat (use_fn only)
  float* a0;   // BR x d_in: layer-0 input; after the backward, d(x)
  float* r;    // L x BR x H: activation of each layer
  float* xh;   // L x BR x H: LN xhat of each layer
  float* y;    // (L-1) x BR x H: LN output of layer li = input of li+1
  float* g;    // BR x H: cotangent of the trunk output
  float* inv;  // (L+1) x BR: 1/sqrt(var+eps), feature norm first
};

__host__ __device__ inline size_t unfolded_smem_floats(int br, int d_in, int H, int L) {
  return (size_t)br * (2 * (size_t)d_in + 3 * (size_t)L * H + L + 1);
}

template <int BR>
__device__ UnfoldedCache carve_unfolded(float* smem, int d_in, int H, int L) {
  UnfoldedCache c;
  c.xf = smem;
  c.a0 = c.xf + BR * d_in;
  c.r = c.a0 + BR * d_in;
  c.xh = c.r + (long long)L * BR * H;
  c.y = c.xh + (long long)L * BR * H;
  c.g = c.y + (long long)(L - 1) * BR * H;
  c.inv = c.g + BR * H;
  return c;
}

// dst (BR x d) = src * scale + bias per column: the affine half of
// ln_tile, on a stored xhat.
template <int BR>
__device__ void affine_tile(const float* src, float* dst, int d, const float* scale,
                            const float* bias) {
  for (int i = threadIdx.x; i < BR * d; i += blockDim.x) {
    const int k = i % d;
    dst[i] = src[i] * scale[k] + bias[k];
  }
}

// Per-column sums over the tile's rows, added into the block's slot:
// s_gx[j] += sum_r g * xh (the LN scale's gradient; skipped when s_gx is
// null), s_g[j] += sum_r g (the LN bias's or the Dense bias's gradient).
template <int BR>
__device__ void col_sums(const float* g, const float* xh, int d, float* s_gx, float* s_g) {
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float sx = 0.f, s = 0.f;
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float v = g[r * d + j];
      if (s_gx != nullptr) sx = fmaf(v, xh[r * d + j], sx);
      s += v;
    }
    if (s_gx != nullptr) s_gx[j] += sx;
    s_g[j] += s;
  }
}

// In place, one warp per row: g <- inv * (g*s - mean(g*s) - xh * mean(g*s*xh))
// (LN backward with affine, dcc_tpu/ops/fused_mlp.py::_ln_bwd), then times
// the activation's derivative when act is given (relu: act > 0, tanh:
// 1 - act^2).
template <int BR>
__device__ void ln_bwd_tile(float* g, const float* xh, const float* inv,
                            const float* scale, int d, const float* act, bool relu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < BR; r += nw) {
    float* gr = g + r * d;
    const float* xr = xh + r * d;
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float gg = gr[k] * scale[k];
      s1 += gg;
      s2 += gg * xr[k];
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    const float iv = inv[r];
    for (int k = lane; k < d; k += 32) {
      float v = iv * (gr[k] * scale[k] - s1 - xr[k] * s2);
      if (act != nullptr) {
        const float a = act[r * d + k];
        v = relu ? (a > 0.f ? v : 0.f) : v * (1.f - a * a);
      }
      gr[k] = v;
    }
  }
}

// Unfolded forward of one tile, keeping the cache the backward needs.
template <int BR>
__device__ void trunk_fwd_unfolded(const void* x, int x_bf16, long long row0,
                                   long long R, int d_in, int H, int L, bool use_fn,
                                   bool relu, const float* pb, const long long* offs,
                                   const UnfoldedCache& c) {
  load_tile<BR>(x, x_bf16, row0, R, d_in, c.a0);
  __syncthreads();
  if (use_fn) {
    ln_tile<BR>(c.a0, c.xf, d_in, nullptr, nullptr, c.inv);
    __syncthreads();
    affine_tile<BR>(c.xf, c.a0, d_in, pb + offs[0], pb + offs[1]);
    __syncthreads();
  }
  for (int li = 0; li < L; ++li) {
    const float* in = li == 0 ? c.a0 : c.y + (long long)(li - 1) * BR * H;
    float* r = c.r + (long long)li * BR * H;
    float* xh = c.xh + (long long)li * BR * H;
    dense_act_tile<BR>(in, li == 0 ? d_in : H, pb + offs[2 + 4 * li], pb + offs[3 + 4 * li], H,
                       relu, r);
    __syncthreads();
    ln_tile<BR>(r, xh, H, nullptr, nullptr, c.inv + (li + 1) * BR);
    __syncthreads();
    if (li + 1 < L) {
      affine_tile<BR>(xh, c.y + (long long)li * BR * H, H, pb + offs[4 + 4 * li],
                      pb + offs[5 + 4 * li]);
      __syncthreads();
    }
  }
}

// Unfolded backward of one tile from the cotangent in c.g. Adds this tile's
// gradient of every parameter into the block's own slot, laid out as the
// flat parameter list (so offs[] locates each gradient too; each slot
// element has one owner thread, no atomics). Leaves d(x) (BR x d_in) in
// c.a0.
template <int BR>
__device__ void trunk_bwd_unfolded(int d_in, int H, int L, bool use_fn, bool relu,
                                   const float* pb, const long long* offs,
                                   const UnfoldedCache& c, float* slot) {
  float* g = c.g;
  for (int li = L - 1; li >= 0; --li) {
    float* r = c.r + (long long)li * BR * H;
    const float* xh = c.xh + (long long)li * BR * H;
    const long long* o = offs + 2 + 4 * li;  // W, b, LN scale, LN bias
    col_sums<BR>(g, xh, H, slot + o[2], slot + o[3]);
    __syncthreads();
    ln_bwd_tile<BR>(g, xh, c.inv + (li + 1) * BR, pb + o[2], H, r, relu);
    __syncthreads();
    col_sums<BR>(g, nullptr, H, nullptr, slot + o[1]);
    __syncthreads();
    // dW = in^T @ g: one thread per (k, j) element of the slot
    const float* in = li == 0 ? c.a0 : c.y + (long long)(li - 1) * BR * H;
    const int din = li == 0 ? d_in : H;
    float* sw = slot + o[0];
    for (long long e = threadIdx.x; e < (long long)din * H; e += blockDim.x) {
      const int k = (int)(e / H), j = (int)(e - (long long)k * H);
      float s = 0.f;
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) s = fmaf(in[rr * din + k], g[rr * H + j], s);
      sw[e] += s;
    }
    __syncthreads();  // layer 0 writes g_prev over its input a0
    // g_prev (BR x din) = g @ W^T, over this layer's activation buffer (or
    // a0 for layer 0), which the backward no longer needs
    const float* Wt = pb + offs[2 + 4 * L + li];  // (H, din), row-major
    float* gp = li == 0 ? c.a0 : r;
    for (int k = threadIdx.x; k < din; k += blockDim.x) {
      float acc[BR];
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) acc[rr] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float w = Wt[(long long)j * din + k];
#pragma unroll
        for (int rr = 0; rr < BR; ++rr) acc[rr] = fmaf(g[rr * H + j], w, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) gp[rr * din + k] = acc[rr];
    }
    __syncthreads();
    g = gp;
  }
  if (use_fn) {
    col_sums<BR>(c.a0, c.xf, d_in, slot + offs[0], slot + offs[1]);
    __syncthreads();
    ln_bwd_tile<BR>(c.a0, c.xf, c.inv, pb + offs[0], d_in, nullptr, relu);
    __syncthreads();
  }
}
