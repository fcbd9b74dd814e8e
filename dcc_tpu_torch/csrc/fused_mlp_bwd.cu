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
// input and output, so it is compute-bound. Two kernels, one per mode:
// * bf16 (trunk_bwd_mma_kernel): every product on the tensor cores
//   (trunk_mma.cuh), on the same padded bf16 weight copies as K2's forward;
// * f32 (trunk_bwd_kernel): full FP32 on the CUDA cores (trunk.cuh), bound
//   by the 67 TFLOP/s FP32 rate.
// Each block re-reads and re-writes its gradient slot once per tile after
// its first, which bounds both at large batch.
//
// Design. The Pallas kernel accumulates the gradients into one output block
// across a sequential grid, race-free only on a TPU. Here a fixed grid of
// blocks loops over row tiles; each block recomputes the tile's unfolded
// forward into shared memory, runs the backward chain on it and adds the
// tile's gradients into its OWN slot of a scratch buffer, laid out as the
// flat parameter list (each slot element has one owner thread). A second
// small kernel (slots.cuh) sums the slots in a fixed order: deterministic,
// no atomics. d(x) is written per row; the ragged last tile is masked in the
// kernel (zero rows, zero cotangent), never padded.
#include "slots.cuh"
#include "trunk_mma.cuh"

// ---------------------------------------------------------------------------
// f32, on the CUDA cores: the tile's cache is f32 (input, feature-norm xhat,
// each layer's activation, xhat and LN output, 1/sigma per row: 2 d_in +
// 3 L H floats a row, so 32 rows at d_in = 110 and 16 at d_in = 440).
// ---------------------------------------------------------------------------
template <int BR>
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
    trunk_fwd_unfolded<BR>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs, c);
    load_tile<BR>(gout, 0, row0, R, H, c.g);
    __syncthreads();
    trunk_bwd_unfolded<BR>(d_in, H, L, use_fn, relu, pb, offs, c, slot);
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

// ---------------------------------------------------------------------------
// bf16, on the tensor cores. Per tile: the unfolded forward as K2's
// trunk_fwd_mma_kernel computes it, caching each layer's activation (a bf16
// value: relu of a bf16 z, or bf16(tanh)) and its LN mean and 1/sigma; then
// per layer, from the last: the LN backward with the layer's scale, the
// activation's derivative, dW = bf16(a)^T bf16(g) into the slot (grad_at_g),
// and g_prev = bf16(g) bf16(W)^T (gemm_stream over W's columns). The dW
// operand of layer li >= 1 is the previous layer's bf16 LN output,
// recomputed from the cached activation with the forward's own expression
// (ln_affine), so it has the forward's bits. Layer 0's g_prev has d_in
// columns (448 padded at d_in 440), more than one warp tiling holds
// (MMA_HMAX), so it runs in column passes of at most 256 whose f32 results
// are staged in shared memory; the feature norm's LN backward, whose row
// sums span all d_in columns, then reads them and writes d(x).
// The relu mask decides whether a whole element of the gradient flows, so
// K2b's mask must agree with the plain version's: where the sign of a
// pre-activation is within what a summation order can change (see
// relu_uncertain), the forward re-sums it on the CUDA cores in sequential
// k order, the order of the CPU's and the FMA kernel's small products. Such
// pre-activations are rare (~0.1 %); each layer of a tile lists them in
// shared memory and the block's threads re-sum them in parallel.
// Shared memory of one block (Kp0 = pad16(d_in), Hp = pad16(H), bf16 tiles
// with rows padded by 8 elements):
//   a0    BR x Kp0     layer 0's operand (the feature-norm output)
//   act   L x BR x Hp  each layer's activation
//   sx    BR x Hp      the operand of layer li >= 1 (its input's LN output)
//   stage BR x (Kp0 + 4) f32, layer 0's g_prev; over a0, act and sx, which
//         are dead by then (and beyond them where it is larger)
//   gs    BR x Hp      bf16 of the current layer's cotangent
//   ring  the stages of the weight stream
//   f32:  mu, inv (L x BR), the feature norm's mu, inv (BR), row-sum
//         partials, column sums (3 x BR/16 x Hp), the operand's row norms
//         (BR) and the weights' column norms (L x Hp, once per block), the
//         list of re-sums (a count, FLAG_CAP keys and values)
// ---------------------------------------------------------------------------
struct BwdMmaLayout {
  size_t a0, act, sx, stage, gs, ring, mu, inv, fmu, finv, red, colsum, rnorm, cnorm, flags,
      total;
};

__host__ __device__ inline BwdMmaLayout bwd_mma_layout(int br, int d_in, int H, int L) {
  const size_t Kp0 = pad16(d_in), Hp = pad16(H), ldh = Hp + 8;
  const int nk = (int)(Kp0 < MMA_HMAX ? Kp0 : MMA_HMAX);  // widest column pass of g_prev
  const int st_kn = ring_stage((int)Hp, false);
  const int st_nk = ring_stage(nk > (int)Hp ? nk : (int)Hp, true);
  BwdMmaLayout m;
  size_t o = 0;
  m.a0 = o;     o += 2 * br * (Kp0 + 8);
  m.act = o;    o += 2 * (size_t)L * br * ldh;
  m.sx = o;     o += 2 * br * ldh;
  m.stage = 0;
  const size_t stage = 4 * br * (Kp0 + 4);
  if (o < stage) o = stage;
  m.gs = o;     o += 2 * br * ldh;
  m.ring = o;   o += 2 * MMA_STAGES * (size_t)(st_kn > st_nk ? st_kn : st_nk);
  m.mu = o;     o += 4 * (size_t)L * br;
  m.inv = o;    o += 4 * (size_t)L * br;
  m.fmu = o;    o += 4 * (size_t)br;
  m.finv = o;   o += 4 * (size_t)br;
  m.red = o;    o += 4 * (size_t)(MMA_WARPS / (br / 16)) * br * 2;
  m.colsum = o; o += 4 * 3 * (size_t)(br / 16) * Hp;
  m.rnorm = o;  o += 4 * (size_t)br;
  m.cnorm = o;  o += 4 * (size_t)L * Hp;
  m.flags = o;  o += RESUM_BYTES;
  m.total = o;
  return m;
}

// Parameters: the flat list's f32 vectors in pb (fn scale / bias at
// offs.v[0] / v[1]; layer li's b, LN scale, LN bias at offs.v[3+4li] ..
// v[5+4li]; the W slots offs.v[2+4li] are not read), the same offsets
// locating each gradient in the slot; bf16 W_li (pad16(d_li) x pad16(H),
// zero padded) at wb + woffs.v[li]. gout: R x H f32; dx in x's dtype.
template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    trunk_bwd_mma_kernel(const void* x, int x_bf16, const float* gout, long long R, int d_in,
                         int H, int L, int use_fn, int relu, const float* pb, DccOffs offs,
                         const bf16* wb, DccOffs woffs, float* slots, long long slot_size,
                         void* dx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdMmaLayout m = bwd_mma_layout(BR, d_in, H, L);
  const int Kp0 = pad16(d_in), Hp = pad16(H), lda0 = Kp0 + 8, ldh = Hp + 8, ldf = Kp0 + 4;
  bf16* a0 = (bf16*)(smem_raw + m.a0);
  bf16* act = (bf16*)(smem_raw + m.act);
  bf16* sx = (bf16*)(smem_raw + m.sx);
  float* stage = (float*)(smem_raw + m.stage);
  bf16* gs = (bf16*)(smem_raw + m.gs);
  bf16* ring = (bf16*)(smem_raw + m.ring);
  float* mu_s = (float*)(smem_raw + m.mu);
  float* inv_s = (float*)(smem_raw + m.inv);
  float* fmu = (float*)(smem_raw + m.fmu);
  float* finv = (float*)(smem_raw + m.finv);
  float* red = (float*)(smem_raw + m.red);
  float* colsum = (float*)(smem_raw + m.colsum);
  float* rnorm = (float*)(smem_raw + m.rnorm);
  float* cnorm = (float*)(smem_raw + m.cnorm);
  const ResumList flags = resum_list(smem_raw + m.flags);
  constexpr int WM = MmaTile<BR>::WM;
  const WarpTile wt = warp_tile<BR>(Hp / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto xv = [&](long long i) { return load_x(x, x_bf16, i); };

  float* slot = slots + (long long)blockIdx.x * slot_size;
  const long long tiles = (R + BR - 1) / BR;
  if (blockIdx.x >= tiles) {  // no rows for this block: its slot holds zeros
    for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
    return;
  }
  if (threadIdx.x == 0) *flags.n = 0;
  if (relu) weight_col_norms(wb, woffs, L, Kp0, Hp, cnorm);  // for relu_uncertain
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    const bool first = tile == blockIdx.x;
    if (threadIdx.x < 2 && tile + gridDim.x < tiles) {
      // the next tile's rows (thread 0) and cotangent rows (thread 1), into L2
      const long long r1 = row0 + (long long)gridDim.x * BR;
      const long long n = min((long long)BR, R - r1);
      const int esz = threadIdx.x == 0 ? (x_bf16 ? 2 : 4) * d_in : 4 * H;
      const char* p = threadIdx.x == 0 ? (const char*)x : (const char*)gout;
      prefetch_l2_span(p + r1 * esz, n * esz);
    }
    // unfolded forward (dcc_tpu/ops/fused_mlp.py::_forward_chain)
    load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, pb + offs.v[0], pb + offs.v[1], a0,
                   lda0, fmu, finv);
    __syncthreads();
    float acc[MmaTile<BR>::NT][4];
    for (int li = 0; li < L; ++li) {
      const long long* o = offs.v + 2 + 4 * li;
      const bf16* in = li == 0 ? a0 : sx;
      const int lda = li == 0 ? lda0 : ldh, K = li == 0 ? d_in : H;
      if (relu)  // the operand's row norms, for relu_uncertain
        operand_row_norms<BR>(in, lda, K, rnorm);
      gemm_stream<false>(in, lda, li == 0 ? Kp0 : Hp, wb + woffs.v[li], Hp, Hp, ring, wt, acc);
      if (relu)
        resum_uncertain<BR>(acc, in, lda, K, wb + woffs.v[li], Hp, pb + o[1], H, rnorm,
                            cnorm + li * Hp, row0, R, wt, flags);
      float mu[2], inv[2];
      dense_act_stats<BR>(acc, pb + o[1], H, relu, red, wt, mu, inv);
      if (wt.wn == 0 && (lane & 3) == 0) {
        for (int h = 0; h < 2; ++h) {
          mu_s[li * BR + wt.r0 + 8 * h] = mu[h];
          inv_s[li * BR + wt.r0 + 8 * h] = inv[h];
        }
      }
      bf16* a = act + (long long)li * BR * ldh;
#pragma unroll
      for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
        if (nt < wt.ntw) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wt.r0 + 8 * h, c = wt.c0 + nt * 8;
            store_bf16x2(a + r * ldh + c, acc[nt][2 * h], acc[nt][2 * h + 1]);
            if (li + 1 < L) {  // the next layer's operand
              float y[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                y[e] = c + e < H ? ln_affine(acc[nt][2 * h + e], mu[h], inv[h],
                                             pb[o[2] + c + e], pb[o[3] + c + e])
                                 : 0.f;
              store_bf16x2(sx + r * ldh + c, y[0], y[1]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (!first && threadIdx.x == 0)  // this tile adds into the block's slot: into L2
      prefetch_l2_span((const char*)slot, slot_size * 4);
    // the cotangent of the trunk output, rows >= R zero
#pragma unroll
    for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + wt.r0 + 8 * h;
        const int c = wt.c0 + nt * 8;
        float2 v = make_float2(0.f, 0.f);
        if (nt < wt.ntw && row < R && c < H)
          v = __ldg(reinterpret_cast<const float2*>(gout + row * H + c));
        acc[nt][2 * h] = v.x;
        acc[nt][2 * h + 1] = v.y;
      }
    }
    // unfolded backward (dcc_tpu/ops/fused_mlp.py::_bwd_kernel)
    for (int li = L - 1; li >= 0; --li) {
      const long long* o = offs.v + 2 + 4 * li;  // W, b, LN scale, LN bias
      ln_affine_act_bwd<BR>(acc, act + (long long)li * BR * ldh, ldh, mu_s + li * BR,
                            inv_s + li * BR, pb + o[2], H, Hp, relu, red, wt, colsum, gs);
      if (li >= 1 && li + 1 < L) {
        // this layer's operand, the previous layer's LN output, as the
        // forward wrote it (the last layer's is still in sx)
        const long long* op = o - 4;
        const bf16* ap = act + (long long)(li - 1) * BR * ldh;
        const float* pm = mu_s + (li - 1) * BR;
        const float* pi = inv_s + (li - 1) * BR;
        for (int i = threadIdx.x; i < BR * Hp; i += blockDim.x) {
          const int r = i / Hp, c = i - r * Hp;
          const float y =
              c < H ? ln_affine(bf(ap[r * ldh + c]), pm[r], pi[r], pb[op[2] + c], pb[op[3] + c])
                    : 0.f;
          sx[r * ldh + c] = __float2bfloat16_rn(y);
        }
      }
      __syncthreads();
      // LN scale, LN bias and Dense bias gradients: column sums in warp order
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float s = 0.f;
          for (int w = 0; w < WM; ++w) s += colsum[(k * WM + w) * Hp + j];
          float* dst = slot + o[k == 2 ? 1 : 2 + k] + j;
          *dst = first ? s : *dst + s;
        }
      }
      grad_at_g<BR>(li == 0 ? a0 : sx, li == 0 ? lda0 : ldh, li == 0 ? Kp0 : Hp,
                    li == 0 ? d_in : H, gs, ldh, Hp, H, slot + o[0], first);
      if (li > 0)  // g_prev = bf16(g) @ W^T
        gemm_stream<true>(gs, ldh, Hp, wb + woffs.v[li], Hp, Hp, ring, wt, acc);
    }
    // layer 0's g_prev = bf16(g) @ W_0^T over Kp0 columns into the stage
    // (over a0, which grad_at_g has finished reading)
    gprev_layer0<BR>(gs, ldh, Hp, wb + woffs.v[0], Kp0, ring, stage, ldf);
    __syncthreads();
    if (use_fn) {
      // feature norm: its scale and bias gradients (rows >= R have g = 0)
      const float* fs = pb + offs.v[0];
      fn_affine_grads<BR>(stage, ldf, x, x_bf16, row0, R, d_in, fmu, finv, slot + offs.v[0],
                          slot + offs.v[1], first);
      // its LN backward and d(x), one warp per row
      for (int r = warp; r < BR && row0 + r < R; r += MMA_WARPS) {
        const long long base = (row0 + r) * d_in;
        const float* gr = stage + r * ldf;
        float s1 = 0.f, s2 = 0.f;
        for (int k = lane; k < d_in; k += 32) {
          const float gg = gr[k] * __ldg(fs + k);
          s1 += gg;
          s2 += gg * ((xv(base + k) - fmu[r]) * finv[r]);
        }
        s1 = warp_sum(s1) / d_in;
        s2 = warp_sum(s2) / d_in;
        for (int k = lane; k < d_in; k += 32) {
          const float xh = (xv(base + k) - fmu[r]) * finv[r];
          const float v = finv[r] * (gr[k] * __ldg(fs + k) - s1 - xh * s2);
          if (x_bf16)
            ((bf16*)dx)[base + k] = __float2bfloat16_rn(v);
          else
            ((float*)dx)[base + k] = v;
        }
      }
    } else {
      for (int i = threadIdx.x; i < BR * d_in; i += blockDim.x) {
        const int r = i / d_in, k = i - r * d_in;
        const long long off = row0 * d_in + i;
        if (row0 + r < R) {
          if (x_bf16)
            ((bf16*)dx)[off] = __float2bfloat16_rn(stage[r * ldf + k]);
          else
            ((float*)dx)[off] = stage[r * ldf + k];
        }
      }
    }
    __syncthreads();  // the next tile's forward writes over the stage
  }
}

static DccOffs to_offs(const long long* offs, int n_offs) {
  DccOffs o;
  for (int i = 0; i < DCC_MAX_OFFS; ++i) o.v[i] = i < n_offs ? offs[i] : 0;
  return o;
}

template <int BR>
static int launch(const void* x, int x_bf16, const float* g, long long R, int d_in, int H,
                  int L, int use_fn, int relu, const float* pb, const DccOffs& o,
                  float* slots, long long slot_size, int n_blocks, float* out, void* dx,
                  cudaStream_t s) {
  static bool smem_set = false;
  auto k = trunk_bwd_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = sizeof(float) * unfolded_smem_floats(BR, d_in, H, L);
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o,
                                        slots, slot_size, dx);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

template <int BR>
static int launch_mma(const void* x, int x_bf16, const float* g, long long R, int d_in, int H,
                      int L, int use_fn, int relu, const float* pb, const DccOffs& o,
                      const bf16* wb, const DccOffs& wo, float* slots, long long slot_size,
                      int n_blocks, float* out, void* dx, cudaStream_t s) {
  static bool smem_set = false;
  auto k = trunk_bwd_mma_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = bwd_mma_layout(BR, d_in, H, L).total;
  k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, wb,
                                        wo, slots, slot_size, dx);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" unsigned long long dcc_trunk_bwd_smem_bytes(int br, int d_in, int H, int L) {
  return sizeof(float) * unfolded_smem_floats(br, d_in, H, L);
}

extern "C" unsigned long long dcc_trunk_bwd_mma_smem_bytes(int br, int d_in, int H, int L) {
  return bwd_mma_layout(br, d_in, H, L).total;
}

// f32 (FMA). offs: [fn scale, fn bias, (W, b, LN scale, LN bias) x L, W^T x
// L] into pb (2 + 5L entries; the first 2 + 4L also locate each gradient in
// a slot). slots is n_blocks x slot_size scratch; out receives the
// slot_size summed gradients; dx has x's dtype and shape.
extern "C" int dcc_trunk_bwd(const void* x, int x_bf16, const float* g, long long R,
                             int d_in, int H, int L, int use_fn, int relu, int br,
                             const float* pb, const long long* offs, int n_offs, float* slots,
                             long long slot_size, int n_blocks, float* out, void* dx,
                             void* stream) {
  if (L < 1 || L > DCC_MAX_LAYERS || n_offs != 2 + 5 * L || n_offs > DCC_MAX_OFFS ||
      n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const DccOffs o = to_offs(offs, n_offs);
#define DCC_CASE(B)                                                                        \
  case B:                                                                                  \
    return launch<B>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, slots, slot_size, \
                     n_blocks, out, dx, s);
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

// bf16 on the tensor cores: br in {64, 32, 16}; H a multiple of 8, at most
// MMA_HMAX; offs: [fn scale, fn bias, (W, b, LN scale, LN bias) x L] into
// pb and into a slot (2 + 4L entries, each W's even so the slabs can store
// float2; slot_size even); woffs: the bf16 W_li in wb.
extern "C" int dcc_trunk_bwd_mma(const void* x, int x_bf16, const float* g, long long R,
                                 int d_in, int H, int L, int use_fn, int relu, int br,
                                 const float* pb, const long long* offs, int n_offs,
                                 const void* wb, const long long* woffs, int n_woffs,
                                 float* slots, long long slot_size, int n_blocks, float* out,
                                 void* dx, void* stream) {
  if (L < 1 || L > DCC_MAX_LAYERS || n_offs != 2 + 4 * L || n_woffs != L || n_blocks < 1 ||
      H % 8 != 0 || H > MMA_HMAX || slot_size % 2 != 0)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li < L; ++li)
    if (offs[2 + 4 * li] % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const DccOffs o = to_offs(offs, n_offs), wo = to_offs(woffs, n_woffs);
  const bf16* w = (const bf16*)wb;
#define DCC_CASE(B)                                                                      \
  case B:                                                                                \
    return launch_mma<B>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, w, wo, slots, \
                         slot_size, n_blocks, out, dx, s);
  switch (br) {
    DCC_CASE(64)
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
