// K2b: fused MLP trunk backward. From the input rows x and the cotangent g
// of the trunk output it recomputes the forward per tile and returns d(x)
// and the f32 gradient of every W, b, LN scale and LN bias.
//
// Replaces the Pallas kernel dcc_tpu/ops/fused_mlp.py::_bwd_kernel (reached
// through fused_mlp -> _make_op -> op_bwd, the custom VJP of the trunk).
// The recurrent bf16 update runs it once per epoch for the actor on
// T*E*A x 110 rows and once for the critic on T*E*A x 440 rows (the env
// rows duplicated per agent); bf16 feed-forward training with the fused
// loss off runs it on the same row sets.
//
// What bounds it on an H100: per row the forward recompute, dW and d(input)
// each take 2 * sum_l d_l * H multiply-adds against (2 d_in + H) values of
// input and output, so it is compute-bound. This first version runs every
// product on the CUDA cores in FP32 FMA, so the 67 TFLOP/s FP32 rate bounds
// it, and each block re-reads and re-writes its gradient slot once per
// tile.
//
// Design. The Pallas kernel accumulates the gradients into one output block
// across a sequential grid, race-free only on a TPU. Here a fixed grid of
// one block per SM loops over row tiles; each block recomputes the tile's
// unfolded forward into shared memory (input, feature-norm xhat, each
// layer's activation, xhat and LN output, 1/sigma per row: 2 d_in + 3 L H
// floats a row, so 32 rows at d_in = 110 and 16 at d_in = 440), runs the
// backward chain on it and adds the tile's gradients into its OWN slot of a
// scratch buffer (each slot element has one owner thread). A second small
// kernel (slots.cuh) sums the slots in a fixed order: deterministic, no
// atomics. d(x) is written per row; the ragged last tile is masked in the
// kernel (zero rows, zero cotangent), never padded.
#include "slots.cuh"
#include "trunk.cuh"

template <int BR, bool BF16>
__global__ void __launch_bounds__(DCC_THREADS)
    trunk_bwd_kernel(const void* x, int x_bf16, const float* gout, long long R, int d_in,
                     int H, int L, int use_fn, int relu, const float* pb, DccOffs offs,
                     float* slots, long long slot_size, void* dx) {
  extern __shared__ float smem[];
  const UnfoldedCache c = carve_unfolded<BR>(smem, d_in, H, L);
  float* slot = slots + (long long)blockIdx.x * slot_size;
  for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
  __syncthreads();

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    trunk_fwd_unfolded<BR, BF16>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs, c);
    load_tile<BR>(gout, 0, row0, R, H, c.g);
    __syncthreads();
    trunk_bwd_unfolded<BR, BF16>(d_in, H, L, use_fn, relu, pb, offs, c, slot);
    for (int i = threadIdx.x; i < BR * d_in; i += blockDim.x) {
      const long long off = row0 * d_in + i;
      if (off < R * d_in) {
        if (x_bf16)
          ((__nv_bfloat16*)dx)[off] = __float2bfloat16_rn(c.a0[i]);
        else
          ((float*)dx)[off] = c.a0[i];
      }
    }
    __syncthreads();
  }
}

template <int BR, bool BF16>
static int launch(const void* x, int x_bf16, const float* g, long long R, int d_in, int H,
                  int L, int use_fn, int relu, const float* pb, const DccOffs& o,
                  float* slots, long long slot_size, int n_blocks, float* out, void* dx,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * unfolded_smem_floats(BR, d_in, H, L);
  auto k = trunk_bwd_kernel<BR, BF16>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o,
                                        slots, slot_size, dx);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" unsigned long long dcc_trunk_bwd_smem_bytes(int br, int d_in, int H, int L) {
  return sizeof(float) * unfolded_smem_floats(br, d_in, H, L);
}

// offs: [fn scale, fn bias, (W, b, LN scale, LN bias) x L, W^T x L] into pb
// (2 + 5L entries; the first 2 + 4L also locate each gradient in a slot).
// slots is n_blocks x slot_size scratch; out receives the slot_size summed
// gradients; dx has x's dtype and shape.
extern "C" int dcc_trunk_bwd(const void* x, int x_bf16, const float* g, long long R,
                             int d_in, int H, int L, int use_fn, int relu, int bf16,
                             int br, const float* pb, const long long* offs, int n_offs,
                             float* slots, long long slot_size, int n_blocks, float* out,
                             void* dx, void* stream) {
  if (L < 1 || L > DCC_MAX_LAYERS || n_offs != 2 + 5 * L || n_offs > DCC_MAX_OFFS ||
      n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DccOffs o;
  for (int i = 0; i < DCC_MAX_OFFS; ++i) o.v[i] = i < n_offs ? offs[i] : 0;
#define DCC_CASE(B)                                                                    \
  case B:                                                                              \
    return bf16 ? launch<B, true>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o,    \
                                  slots, slot_size, n_blocks, out, dx, s)              \
                : launch<B, false>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o,   \
                                   slots, slot_size, n_blocks, out, dx, s);
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(16)
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
