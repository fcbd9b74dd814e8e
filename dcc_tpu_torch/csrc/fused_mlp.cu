// K2: fused MLP trunk forward, feature LN -> [Dense -> act -> LN] x L.
//
// Replaces the Pallas kernel dcc_tpu/ops/fused_mlp.py::_fwd_kernel (reached
// through fused_mlp -> _make_op -> fwd_call). The rollout runs it for the
// actor on (E*A, 110) rows and for the critic on (E, 440) rows every step.
//
// What bounds it on an H100: per row the work is 2 * (d_in * H + H * H)
// multiply-adds against (d_in + H) * 2-4 bytes of input and output, about
// 400 operations a byte at the default widths, so it is compute-bound in
// principle; at the rollout's 16-env shapes (64 and 16 rows) it is a single
// launch's latency.
//
// Two kernels, one per mode:
// * bf16 (trunk_fwd_mma_kernel): the products run on the tensor cores
//   (trunk_mma.cuh: mma.sync m16n8k16, ldmatrix, cp.async weight ring),
//   on bf16 weight copies zero-padded to multiples of 16. A tile of BR =
//   16, 32 or 64 rows stays in shared memory as bf16 (it is exactly the
//   next product's operand); each warp holds 16 rows x a column group of
//   f32 accumulators, and the Dense epilogue, the activation and the LN run
//   in registers. Blocks are persistent (at most two per SM) and loop over
//   row tiles; the weights (at most 448 x 256 bf16 per layer) stream from
//   L2, where the trunk stays resident. The LN affine rounds each step on
//   its own (ln_affine), as the plain version and K2b's forward recompute
//   do. (K2b's relu re-sum, resum_uncertain, is not applied here: it left
//   the recurrent bf16 update's reading unchanged and cost 2.7-3.9x at
//   16,384 envs, PERF.md section 7.)
// * f32 (trunk_fwd_kernel): full FP32 on the CUDA cores (no TF32), one
//   block per tile of BR rows, one thread per output column.
// The ragged last tile is masked on load and store in both.
// * bf16 at rows too wide to stage (trunk_fwd_chunked_mma_kernel, the
//   same body, trunk_fwd_mma<BR, CH>, with CH set; the critic's
//   team-concat rows past 5,632 columns, e.g. 4 UAVs x 300 PoIs, 6,040):
//   layer 0's operand streams through one BR x MMA_KC tile in
//   256-column chunks (trunk_mma.cuh's chunked_layer0, as the chunked K2b's
//   forward recompute runs it): the feature norm's statistics first, over
//   all d_in columns (input_stats), then per chunk bf16(xhat * fs + fb),
//   each step rounded on its own, and its product with W_0's rows, the
//   chunks' products summed in f32 (round to nearest). The same tile then
//   holds each later layer's input; the layers after layer 0 run as in the
//   staged kernel.
// * bf16 at hidden widths whose operand tile fits no block (past about
//   2,800 at 440-wide rows): the column-blocked library
//   (fused_mlp_blocked.cu, DCC_BLOCKED) keeps each later layer's input and
//   the layer's activations in the block's scratch in device memory (two
//   BR x (Hp + 8) bf16 tiles, fwd_scratch_bytes) and streams the input's
//   K-slices through the weight ring (trunk_mma.cuh's gemm_stream with
//   arows), so that shared memory holds layer 0's operand (or its chunk),
//   the ring and the row sums, and does not grow with H. Same products in
//   the same order: the staged kernel's bits.
#include "trunk_mma.cuh"

// Offsets in the packed f32 parameter buffer (offs, a device table of 2 +
// 4L entries): fn scale, fn bias at offs[0], offs[1]; layer li: W at
// offs[2+4li], b at offs[3+4li], LN scale at offs[4+4li], LN bias at
// offs[5+4li].
template <int BR>
__global__ void __launch_bounds__(DCC_THREADS)
    trunk_fwd_kernel(const void* x, int x_bf16, long long R, int d_in, int H, int L,
                     int use_fn, int relu, const float* pb, const long long* offs, float* out) {
  extern __shared__ float smem[];
  const int wmax = d_in > H ? d_in : H;
  float* a = smem;             // BR x wmax
  float* z = smem + BR * wmax; // BR x H
  const long long row0 = (long long)blockIdx.x * BR;

  load_tile<BR>(x, x_bf16, row0, R, d_in, a);
  __syncthreads();
  if (use_fn) {
    ln_tile<BR>(a, a, d_in, pb + offs[0], pb + offs[1], nullptr);
    __syncthreads();
  }
  int din = d_in;
  for (int li = 0; li < L; ++li) {
    const long long* o = offs + 2 + 4 * li;
    dense_act_tile<BR>(a, din, pb + o[0], pb + o[1], H, relu, z);
    __syncthreads();
    ln_tile<BR>(z, a, H, pb + o[2], pb + o[3], nullptr);
    __syncthreads();
    din = H;
  }
  for (int i = threadIdx.x; i < BR * H; i += blockDim.x) {
    const long long off = row0 * H + i;
    if (off < R * H) out[off] = a[i];
  }
}

// Row stride of the bf16 kernels' operand tile: staged, the widest layer
// input (pad16(d_in) or pad16(H)); chunked, one MMA_KC-column chunk of layer
// 0's operand or each later layer's input, pad16(H); blocked, layer 0's
// operand (or its chunk) alone.
__host__ __device__ inline int fwd_mma_lda(int d_in, int H, bool ch) {
  const int Hp = DCC_BLOCKED ? 0 : pad16(H), k0 = ch ? MMA_KC : pad16(d_in);
  return (k0 > Hp ? k0 : Hp) + 8;
}

// Shared memory of the bf16 kernels: the BR x lda operand tile, the weight
// ring (stages of one column pass; blocked, with the streamed input's
// slices), the row-sum partials, chunked the rows' feature-norm mean and
// 1/sqrt(var + eps) (then independent of d_in) and, at hidden widths of
// more than one column pass and not blocked, the BR x (Hp + 8) bf16
// activations of the layer.
__host__ __device__ inline size_t fwd_mma_smem_bytes(int br, int d_in, int H, bool ch) {
  const int Hp = pad16(H);
  const int WN = MMA_WARPS / (br / 16);
  return 2 * ((size_t)br * fwd_mma_lda(d_in, H, ch) +
              MMA_STAGES * (size_t)(ring_stage(pass_cols(Hp), false) +
                                    (DCC_BLOCKED ? ring_a(br) : 0))) +
         4 * (size_t)WN * br * 2 + (ch ? 4 * 2 * (size_t)br : 0) +
         (Hp > MMA_HMAX && !DCC_BLOCKED ? 2 * (size_t)br * (Hp + 8) : 0);
}

// Bytes of one block's scratch in the column-blocked library: a later
// layer's input and the layer's activations, BR x (Hp + 8) bf16 each.
__host__ __device__ inline size_t fwd_scratch_bytes(int br, int H) {
  return 2 * 2 * (size_t)br * (pad16(H) + 8);
}

// bf16 trunk on the tensor cores. wb holds each layer's W as bf16, zero
// padded to pad16(d_li) x pad16(H), at woffs[li] (a device table of L
// entries); pb the f32 vectors at offs, as the f32 kernel's.
// mask: null, or the relu masks' debug output (L x R x H bytes, z > 0).
// scratch: the blocked library's (gridDim.x x fwd_scratch_bytes), else unread.
#define DCC_TRUNK_FWD_MMA_PARAMS                                                           \
  const void *x, int x_bf16, long long R, int d_in, int H, int L, int use_fn, int relu,    \
      const float *pb, const long long *offs, const bf16 *wb, const long long *woffs,      \
      bf16 *out, unsigned char *mask, unsigned char *scratch

// CH: layer 0 chunked (the rows' statistics, then chunked_layer0) instead
// of staged (load_input, then gemm_stream over the whole row). Each layer
// runs in column passes (trunk_mma.cuh): one at H <= MMA_HMAX, whose
// activations stay in registers up to the LN output; more, whose
// activations go to act before the LN sweep.
template <int BR, bool CH>
__device__ __forceinline__ void trunk_fwd_mma(unsigned char* smem_raw,
                                              DCC_TRUNK_FWD_MMA_PARAMS) {
  const int Kp0 = pad16(d_in), Hp = pad16(H), lda = fwd_mma_lda(d_in, H, CH), ldh = Hp + 8;
  const bool multi = DCC_WIDE && Hp > MMA_HMAX;
  constexpr bool blk = DCC_BLOCKED;
  bf16* A = (bf16*)smem_raw;  // BR x lda: the current layer's input (or chunk)
  bf16* ring = A + BR * lda;
  float* red = (float*)(ring + MMA_STAGES * (ring_stage(pass_cols(Hp), false) +
                                             (blk ? ring_a(BR) : 0)));
  float* fmu = red + MmaTile<BR>::WN * BR * 2;  // chunked: the rows' statistics
  float* finv = fmu + BR;
  // more than one pass: the activations; blocked, they and the later
  // layers' input (sx, streamed by the products) in the block's scratch
  bf16* scr = blk ? (bf16*)(scratch + (long long)blockIdx.x * fwd_scratch_bytes(BR, H)) : nullptr;
  bf16* sx = blk ? scr : A;
  const int ldx = blk ? ldh : lda;
  bf16* act = blk ? scr + BR * ldh : (bf16*)(fmu + (CH ? 2 * BR : 0));
  const WarpTile wt = pass_tile<BR>(Hp, 0);

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    if constexpr (CH)
      input_stats<BR>(x, x_bf16, row0, R, d_in, use_fn, fmu, finv);
    else
      load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, pb + offs[0], pb + offs[1], A, lda);
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const long long* o = offs + 2 + 4 * li;
      float acc[MmaTile<BR>::NT][4];
      float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
      unsigned char* mrow = mask != nullptr ? mask + ((long long)li * R + row0) * H : nullptr;
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        const int np = min(MMA_HMAX, Hp - n0);
        if constexpr (CH) {
          if (li == 0)
            chunked_layer0<BR, true>(x, x_bf16, row0, R, d_in, use_fn, fmu, finv,
                                     use_fn ? pb + offs[0] : nullptr,
                                     use_fn ? pb + offs[1] : nullptr, A, lda, wb + woffs[0], Hp,
                                     n0, ring, pt, acc);
          else
            gemm_stream<false>(sx, ldx, Hp, wb + woffs[li] + n0, Hp, np, ring, pt, acc,
                               blk ? BR : 0);
        } else if (li == 0) {
          gemm_stream<false>(A, lda, Kp0, wb + woffs[0] + n0, Hp, np, ring, pt, acc);
        } else {
          gemm_stream<false>(sx, ldx, Hp, wb + woffs[li] + n0, Hp, np, ring, pt, acc,
                             blk ? BR : 0);
        }
        dense_act<BR>(acc, pb + o[1], H, n0, relu, pt, s, q);
        if (mrow != nullptr) store_relu_mask<BR>(acc, H, n0, pt, mrow, R - row0);
        if (multi) store_pass<BR>(acc, act, ldh, n0, pt);
      }
      float mu[2], inv[2];
      ln_stats<BR>(s, q, H, red, wt, mu, inv);
      // LN output, bf16: the next layer's operand, or the trunk's output
      const float* sc = pb + o[2];
      const float* bi = pb + o[3];
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (multi) load_pass<BR>(acc, act, ldh, n0, pt);
#pragma unroll
        for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
          if (nt < pt.ntw) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = pt.r0 + 8 * h, c = n0 + pt.c0 + nt * 8;
              float y[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                y[e] = 0.f;
                if (c + e < H)
                  y[e] = ln_affine(acc[nt][2 * h + e], mu[h], inv[h], sc[c + e], bi[c + e]);
              }
              if (li + 1 < L) {
                store_bf16x2(sx + r * ldx + c, y[0], y[1]);
              } else if (row0 + r < R && c < H) {
                bf16* p = out + (row0 + r) * H + c;
                if (!DCC_WIDE || (H & 1) == 0) {
                  store_bf16x2(p, y[0], y[1]);
                } else {  // odd rows: one element at a time
                  p[0] = __float2bfloat16_rn(y[0]);
                  if (c + 1 < H) p[1] = __float2bfloat16_rn(y[1]);
                }
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS)
    trunk_fwd_mma_kernel(DCC_TRUNK_FWD_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_fwd_mma<BR, false>(smem_raw, x, x_bf16, R, d_in, H, L, use_fn, relu, pb, offs, wb, woffs,
                           out, mask, scratch);
}

// bf16 trunk with the chunked layer 0, for rows too wide for a staged tile.
template <int BR>
__global__ void __launch_bounds__(MMA_THREADS)
    trunk_fwd_chunked_mma_kernel(DCC_TRUNK_FWD_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_fwd_mma<BR, true>(smem_raw, x, x_bf16, R, d_in, H, L, use_fn, relu, pb, offs, wb, woffs,
                          out, mask, scratch);
}

template <int BR>
static int launch(const void* x, int x_bf16, long long R, int d_in, int H, int L, int use_fn,
                  int relu, const float* pb, const long long* o, float* out,
                  cudaStream_t stream) {
  static bool smem_set = false;
  auto k = trunk_fwd_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const int wmax = d_in > H ? d_in : H;
  const size_t smem = sizeof(float) * (size_t)BR * (wmax + H);
  const long long tiles = (R + BR - 1) / BR;
  if (tiles > 0)
    k<<<(unsigned)tiles, DCC_THREADS, smem, stream>>>(x, x_bf16, R, d_in, H, L, use_fn, relu,
                                                      pb, o, out);
  return (int)cudaGetLastError();
}

template <int BR, bool CH>
static int launch_mma(const void* x, int x_bf16, long long R, int d_in, int H, int L,
                      int use_fn, int relu, const float* pb, const long long* o, const bf16* wb,
                      const long long* wo, int n_blocks, bf16* out, unsigned char* mask,
                      unsigned char* scratch, cudaStream_t stream) {
  static bool smem_set = false;
  auto k = trunk_fwd_mma_kernel<BR>;
  if constexpr (CH) k = trunk_fwd_chunked_mma_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = fwd_mma_smem_bytes(BR, d_in, H, CH);
  if (R > 0)
    k<<<n_blocks, MMA_THREADS, smem, stream>>>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o,
                                               wb, wo, out, mask, scratch);
  return (int)cudaGetLastError();
}

// bf16 trunk, staged (br in {64, 32, 16}) or chunked (br in {32, 16});
// offs (2 + 4L entries) and woffs (L entries) are device tables.
template <bool CH>
static int trunk_fwd_mma_entry(const void* x, int x_bf16, long long R, int d_in, int H, int L,
                               int use_fn, int relu, int br, const float* pb,
                               const long long* offs, int n_offs, const void* wb,
                               const long long* woffs, int n_woffs, int n_blocks, void* out,
                               void* mask, void* scratch, void* stream) {
  if (L < 1 || n_offs != 2 + 4 * L || n_woffs != L || !mma_width_ok(H) || n_blocks < 1 ||
      d_in < 1 || (DCC_BLOCKED && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long *o = offs, *wo = woffs;
  const bf16* w = (const bf16*)wb;
  bf16* y = (bf16*)out;
  unsigned char* m = (unsigned char*)mask;
  unsigned char* sc = (unsigned char*)scratch;
  switch (br) {
    case 64:
      if constexpr (CH) return (int)cudaErrorInvalidValue;
      else
        return launch_mma<64, false>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, w, wo,
                                     n_blocks, y, m, sc, s);
    case 32:
      return launch_mma<32, CH>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, w, wo, n_blocks,
                                y, m, sc, s);
    case 16:
      return launch_mma<16, CH>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, w, wo, n_blocks,
                                y, m, sc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// f32 trunk: br in {32, 8, 1}; offs a device table of 2 + 4L entries.
extern "C" int dcc_trunk_fwd(const void* x, int x_bf16, long long R, int d_in, int H, int L,
                             int use_fn, int relu, int br, const float* pb,
                             const long long* offs, int n_offs, float* out, void* stream) {
  if (L < 1 || n_offs != 2 + 4 * L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* o = offs;
  switch (br) {
    case 32: return launch<32>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, out, s);
    case 8: return launch<8>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, out, s);
    case 1: return launch<1>(x, x_bf16, R, d_in, H, L, use_fn, relu, pb, o, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" unsigned long long dcc_trunk_fwd_mma_smem_bytes(int br, int d_in, int H) {
  return fwd_mma_smem_bytes(br, d_in, H, false);
}

extern "C" unsigned long long dcc_trunk_fwd_mma_chunked_smem_bytes(int br, int d_in, int H) {
  return fwd_mma_smem_bytes(br, d_in, H, true);
}

// bf16 trunk on the tensor cores: br in {64, 32, 16}; any H whose tile fits
// (dcc_trunk_fwd_mma_smem_bytes); n_blocks persistent blocks loop over the
// row tiles; mask null or the relu masks' debug output (L x R x H bytes);
// scratch: null, or in the blocked library (required) n_blocks x
// dcc_trunk_fwd_scratch_bytes.
extern "C" int dcc_trunk_fwd_mma(const void* x, int x_bf16, long long R, int d_in, int H,
                                 int L, int use_fn, int relu, int br, const float* pb,
                                 const long long* offs, int n_offs, const void* wb,
                                 const long long* woffs, int n_woffs, int n_blocks, void* out,
                                 void* mask, void* scratch, void* stream) {
  return trunk_fwd_mma_entry<false>(x, x_bf16, R, d_in, H, L, use_fn, relu, br, pb, offs,
                                    n_offs, wb, woffs, n_woffs, n_blocks, out, mask, scratch,
                                    stream);
}

extern "C" unsigned long long dcc_trunk_fwd_scratch_bytes(int br, int H) {
  return fwd_scratch_bytes(br, H);
}

// bf16 trunk with the chunked layer 0 (rows too wide for a staged tile): br
// in {32, 16}; otherwise as dcc_trunk_fwd_mma.
extern "C" int dcc_trunk_fwd_chunked_mma(const void* x, int x_bf16, long long R, int d_in,
                                         int H, int L, int use_fn, int relu, int br,
                                         const float* pb, const long long* offs, int n_offs,
                                         const void* wb, const long long* woffs, int n_woffs,
                                         int n_blocks, void* out, void* mask, void* scratch,
                                         void* stream) {
  return trunk_fwd_mma_entry<true>(x, x_bf16, R, d_in, H, L, use_fn, relu, br, pb, offs,
                                   n_offs, wb, woffs, n_woffs, n_blocks, out, mask, scratch,
                                   stream);
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
