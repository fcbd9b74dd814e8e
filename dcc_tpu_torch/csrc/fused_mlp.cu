// K2: fused MLP trunk forward, feature LN -> [Dense -> act -> LN] x L.
//
// Replaces the Pallas kernel dcc_tpu/ops/fused_mlp.py::_fwd_kernel (reached
// through fused_mlp -> _make_op -> fwd_call). The rollout runs it for the
// actor on (E*A, 110) rows and for the critic on (E, 440) rows every step.
//
// What bounds it on an H100: per row the work is 2 * (d_in * H + H * H)
// multiply-adds against (d_in + H) * 4 bytes of input and output, so at the
// default widths it does ~400 operations per byte of HBM traffic and is
// compute-bound in principle. This first version runs the products on the
// CUDA cores in FP32 FMA (bf16 operands are rounded into f32 registers), so
// its bound is the 67 TFLOP/s FP32 rate, not the tensor cores.
//
// Design: one block per tile of BR rows; the tile's activations never leave
// shared memory (BR x max(d_in, H) input buffer plus a BR x H output
// buffer: 89 KB at BR = 32, d_in = 440, so dynamic shared memory). Each
// weight is read once per tile from L2, where the whole trunk stays
// resident. The ragged last tile is masked on load and store. Tensor cores
// (mma / wgmma) and a TMA weight pipeline are later work.
#include "trunk.cuh"

// Offsets in the packed parameter buffer: fn scale, fn bias at v[0], v[1];
// layer li: W at v[2+4li], b at v[3+4li], LN scale at v[4+4li], LN bias at
// v[5+4li].
template <int BR, bool BF16>
__global__ void __launch_bounds__(DCC_THREADS)
    trunk_fwd_kernel(const void* x, int x_bf16, long long R, int d_in, int H,
                     int L, int use_fn, int relu, const float* pb,
                     DccOffs offs, void* out) {
  extern __shared__ float smem[];
  const int wmax = d_in > H ? d_in : H;
  float* a = smem;             // BR x wmax
  float* z = smem + BR * wmax; // BR x H
  const long long row0 = (long long)blockIdx.x * BR;

  load_tile<BR>(x, x_bf16, row0, R, d_in, a);
  __syncthreads();
  if (use_fn) {
    ln_tile<BR>(a, a, d_in, pb + offs.v[0], pb + offs.v[1], BF16, nullptr);
    __syncthreads();
  }
  int din = d_in;
  for (int li = 0; li < L; ++li) {
    const long long* o = offs.v + 2 + 4 * li;
    dense_act_tile<BR, BF16>(a, din, pb + o[0], pb + o[1], H, relu, z);
    __syncthreads();
    ln_tile<BR>(z, a, H, pb + o[2], pb + o[3], BF16, nullptr);
    __syncthreads();
    din = H;
  }
  for (int i = threadIdx.x; i < BR * H; i += blockDim.x) {
    const long long off = row0 * H + i;
    if (off < R * H) {
      if (BF16)
        ((__nv_bfloat16*)out)[off] = __float2bfloat16_rn(a[i]);
      else
        ((float*)out)[off] = a[i];
    }
  }
}

template <int BR, bool BF16>
static int launch(const void* x, int x_bf16, long long R, int d_in, int H, int L,
                  int use_fn, int relu, const float* pb, const long long* offs,
                  int n_offs, void* out, cudaStream_t stream) {
  DccOffs o;
  for (int i = 0; i < DCC_MAX_OFFS; ++i) o.v[i] = i < n_offs ? offs[i] : 0;
  const int wmax = d_in > H ? d_in : H;
  const size_t smem = sizeof(float) * (size_t)BR * (wmax + H);
  auto k = trunk_fwd_kernel<BR, BF16>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const long long tiles = (R + BR - 1) / BR;
  if (tiles > 0)
    k<<<(unsigned)tiles, DCC_THREADS, smem, stream>>>(x, x_bf16, R, d_in, H, L,
                                                      use_fn, relu, pb, o, out);
  return (int)cudaGetLastError();
}

extern "C" int dcc_trunk_fwd(const void* x, int x_bf16, long long R, int d_in,
                             int H, int L, int use_fn, int relu, int bf16,
                             int br, const float* pb, const long long* offs,
                             int n_offs, void* out, void* stream) {
  if (L > DCC_MAX_LAYERS || n_offs > DCC_MAX_OFFS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DCC_CASE(B)                                                                \
  case B:                                                                          \
    return bf16 ? launch<B, true>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, offs, \
                                  n_offs, out, s)                                  \
                : launch<B, false>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, offs, \
                                   n_offs, out, s);
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(8)
    DCC_CASE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
