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
// its first, which bounds both at large batch. In bf16 at rows too wide to
// stage (the 20-UAV preset's 4,840-wide critic rows), three launches take
// the staged kernel's place: trunk_bwd_chunked_mma_kernel down to layer
// 0's cotangent, the dV0 kernel for dW0 (layer0_tail.cu), and the layer-0
// input backward for the feature norm's gradients (layer0_tail.cu) or, where
// d(x) is asked for, layer0_input_bwd_mma_kernel below.
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
                     int H, int L, int use_fn, int relu, const float* pb,
                     const long long* offs, float* slots, long long slot_size, void* dx) {
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
//         are dead by then (and beyond them where it is larger); at hidden
//         widths of more than one column pass, also each layer li >= 1's
//         g_prev, BR x (Hp + 4) f32 over act[li ..] and sx, which the
//         backward no longer reads by then
//         (trunk_mma.cuh)
//   gs    BR x Hp      bf16 of the current layer's cotangent
//   ring  the stages of the weight stream
//   f32:  mu, inv (L x BR), the feature norm's mu, inv (BR), row-sum
//         partials, column sums (3 x BR/16 x Hp), the operand's row norms
//         (BR) and the weights' column norms (L x Hp, once per block), the
//         list of re-sums (a count, FLAG_CAP keys and values)
//
// Chunked (trunk_bwd_chunked_mma_kernel; ROADMAP B2's rows too wide to
// stage whole, e.g. the 20-UAV preset's 4,840-wide critic rows): layer 0's
// operand streams through a0 (BR x MMA_KC) in column chunks
// (chunked_layer0: the feature norm's affine applied and rounded step by
// step, the chunks' products summed in f32), and the backward stops at
// layer 0's cotangent: it writes each row's bf16 g0 (R x Hp) and its
// feature-norm mean and 1/sqrt(var + eps) (xstats, R x 2), and leaves the
// 4,840-wide gradients out of its slot, which starts at layer 0's bias
// (slot offset = offset in pb - offs[3]): dW0 comes from the dV0 kernel
// in its affine mode (layer0_tail.cu), the feature norm's gradients and d(x)
// from the layer-0 input backward (layer0_tail.cu without d(x) at hidden
// widths to 256, else layer0_input_bwd_mma_kernel below). A 4.96 MB dW0 in each of 132
// slots, re-read per tile, would cost more than the product. Layer 0's
// pre-activations are not re-summed (resum_uncertain needs the whole
// operand row); the layers after it are. No stage: layer 0's g_prev is
// not computed here.
//
// Depth layout (deep, staged or chunked; trunk_mma.cuh's
// DeepScratch): act holds one layer's tile, and every layer's tile, its
// mu, inv and the column norms live in the block's scratch in global
// memory, so shared memory does not grow with L. At more than one column
// pass a layer, each layer's f32 g_prev has its own stage, gst (BR x (Hp +
// 4)), since act then holds the layer being differentiated.
//
// Column-blocked layout (fused_mlp_bwd_blocked.cu, DCC_BLOCKED; hidden
// widths whose smallest tile fits no other layout): the depth layout with
// act (every layer's tile, read where it lies), sx, gs, gst, the stage
// and the column sums in the block's scratch too (trunk_mma.cuh), so that
// shared memory holds a0, the ring (with the streamed operand's slices, and
// grad_at_g_blocked's column blocks over it) and the per-row values, and
// does not grow with H.
// ---------------------------------------------------------------------------
struct BwdMmaLayout {
  size_t a0, act, sx, gst, stage, gs, ring, mu, inv, fmu, finv, red, colsum, rnorm, cnorm, flags,
      total;
};

__host__ __device__ inline BwdMmaLayout bwd_mma_layout(int br, int d_in, int H, int L,
                                                       bool chunked = false, bool deep = false) {
  const size_t Kp0 = pad16(d_in), Hp = pad16(H), ldh = Hp + 8;
  const bool blk = DCC_BLOCKED;  // the tiles H wide in the scratch
  deep = deep || blk;
  const size_t Ls = deep ? 0 : L;  // layers whose tiles and statistics stay in shared memory
  const size_t tile = blk ? 0 : 2 * br * ldh;  // a bf16 tile H wide in shared memory
  // widest column pass of layer 0's g_prev (none when chunked) and of a layer
  const int nk = chunked ? 0 : pass_cols((int)Kp0), nh = pass_cols((int)Hp);
  const int st_kn = ring_stage(nh, false);
  const int st_nk = ring_stage(nk > nh ? nk : nh, true);
  BwdMmaLayout m;
  size_t o = 0;
  m.a0 = o;     o += 2 * br * ((chunked ? MMA_KC : Kp0) + 8);
  m.act = o;    o += (deep ? 1 : (size_t)L) * tile;
  m.sx = o;     o += tile;
  m.gst = o;    o += !blk && deep && Hp > MMA_HMAX ? 4 * br * (Hp + 4) : 0;
  m.stage = 0;
  const size_t stage = chunked || blk ? 0 : 4 * br * (Kp0 + 4);
  if (o < stage) o = stage;
  m.gs = o;     o += tile;
  m.ring = o;   o += ring_bytes(br, st_kn > st_nk ? st_kn : st_nk);
  m.mu = o;     o += 4 * Ls * br;
  m.inv = o;    o += 4 * Ls * br;
  m.fmu = o;    o += 4 * (size_t)br;
  m.finv = o;   o += 4 * (size_t)br;
  m.red = o;    o += 4 * (size_t)(MMA_WARPS / (br / 16)) * br * 2;
  m.colsum = o; o += blk ? 0 : 4 * 3 * (size_t)(br / 16) * Hp;
  m.rnorm = o;  o += 4 * (size_t)br;
  m.cnorm = o;  o += 4 * Ls * Hp;
  m.flags = o;  o += RESUM_BYTES;
  m.total = o;
  return m;
}

// Parameters: the flat list's f32 vectors in pb (fn scale / bias at
// offs[0] / offs[1]; layer li's b, LN scale, LN bias at offs[3+4li] ..
// offs[5+4li]; the W slots offs[2+4li] are not read), the same offsets
// locating each gradient in the slot (chunked: less offs[3]); bf16 W_li
// (pad16(d_li) x pad16(H), zero padded) at wb + woffs[li]; offs and woffs
// are device tables. gout: R x H f32; dx in x's dtype (staged); g0, xstats
// (chunked); mask null, or the relu masks' debug output of the forward
// recompute (L x R x H bytes); deep null (the staged layout) or the depth
// layout's scratch (gridDim.x x deep_scratch_bytes(BR, H, L) bytes; the
// column-blocked library's: blocked_scratch_bytes, never null).
#define DCC_TRUNK_BWD_MMA_PARAMS                                                           \
  const void *x, int x_bf16, const float *gout, long long R, int d_in, int H, int L,       \
      int use_fn, int relu, const float *pb, const long long *offs, const bf16 *wb,        \
      const long long *woffs, float *slots, long long slot_size, unsigned char *mask,      \
      unsigned char *deep

template <int BR, bool CH>
__device__ __forceinline__ void trunk_bwd_mma(unsigned char* smem_raw,
                                              DCC_TRUNK_BWD_MMA_PARAMS, void* dx, bf16* g0,
                                              float* xstats) {
  const BwdMmaLayout m = bwd_mma_layout(BR, d_in, H, L, CH, deep != nullptr);
  const int Kp0 = pad16(d_in), Hp = pad16(H), lda0 = (CH ? MMA_KC : Kp0) + 8, ldh = Hp + 8,
            ldf = Kp0 + 4, ldgf = Hp + 4;
  const bool multi = DCC_WIDE && Hp > MMA_HMAX;  // more than one column pass a layer
  // the column-blocked layout: the tiles H wide in the scratch, every
  // layer's tile read where it lies (as staged), products over them with
  // their first operand streamed (ar rows)
  constexpr bool blk = DCC_BLOCKED;
  const int ar = blk ? BR : 0;
  const DeepScratch ds = deep_scratch<BR>(deep, d_in, H, L, CH);
  const bool dp = deep != nullptr && !blk;  // the depth layout: one layer's tile in act
  bf16* a0 = (bf16*)(smem_raw + m.a0);
  bf16* act = blk ? ds.act : (bf16*)(smem_raw + m.act);
  bf16* sx = blk ? ds.sx : (bf16*)(smem_raw + m.sx);
  float* stage = blk ? ds.stage : (float*)(smem_raw + m.stage);
  bf16* gs = blk ? ds.gs : (bf16*)(smem_raw + m.gs);
  bf16* ring = (bf16*)(smem_raw + m.ring);
  float* fmu = (float*)(smem_raw + m.fmu);
  float* finv = (float*)(smem_raw + m.finv);
  float* red = (float*)(smem_raw + m.red);
  float* colsum = blk ? ds.colsum : (float*)(smem_raw + m.colsum);
  float* rnorm = (float*)(smem_raw + m.rnorm);
  // the depth and blocked layouts: every layer's tile and statistics and the
  // column norms in the block's scratch
  float* mu_s = deep ? ds.mu : (float*)(smem_raw + m.mu);
  float* inv_s = deep ? ds.inv : (float*)(smem_raw + m.inv);
  float* cnorm = deep ? ds.cnorm : (float*)(smem_raw + m.cnorm);
  auto act_tile = [&](int li) { return dp ? act : act + (long long)li * BR * ldh; };
  // layer li's saved tile as the backward reads it to recompute an operand
  auto saved = [&](int li) -> const bf16* {
    return dp ? ds.act + (long long)li * BR * ldh : act + (long long)li * BR * ldh;
  };
  // the f32 g_prev of layer li (more than one column pass): staged over
  // act[li ..] and sx, deep in gst (blocked: the scratch's)
  auto gstage = [&](int li) {
    return blk ? ds.gst : dp ? (float*)(smem_raw + m.gst) : (float*)(act + (long long)li * BR * ldh);
  };
  // dW = in^T g into the slot: staged, grad_at_g on the shared tiles;
  // blocked, over column blocks staged over the ring
  auto dw = [&](const bf16* in, int lda, int Kp, int d, float* dst, bool first) {
    if constexpr (blk)
      grad_at_g_blocked<BR>(in, lda, in == a0, Kp, d, gs, ldh, Hp, H, dst, first, ring,
                            ring + BR * (MMA_HMAX + 8));
    else
      grad_at_g<BR>(in, lda, Kp, d, gs, ldh, Hp, H, dst, first);
  };
  const ResumList flags = resum_list(smem_raw + m.flags);
  constexpr int WM = MmaTile<BR>::WM;
  const WarpTile wt = pass_tile<BR>(Hp, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto xv = [&](long long i) { return load_x(x, x_bf16, i); };
  float acc[MmaTile<BR>::NT][4];

  float* slot = slots + (long long)blockIdx.x * slot_size;
  const long long tiles = (R + BR - 1) / BR;
  if (blockIdx.x >= tiles) {  // no rows for this block: its slot holds zeros
    for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
    return;
  }
  float* sb = CH ? slot - offs[3] : slot;  // gradient k of the flat list at sb + offs[k]
  if (threadIdx.x == 0) *flags.n = 0;
  if (relu)  // for relu_uncertain (chunked: the layers after layer 0)
    weight_col_norms(wb, woffs, L, Kp0, Hp, cnorm, CH ? 1 : 0);
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
    if constexpr (CH)
      input_stats<BR>(x, x_bf16, row0, R, d_in, use_fn, fmu, finv);
    else
      load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, pb + offs[0], pb + offs[1], a0, lda0,
                     fmu, finv);
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const long long* o = offs + 2 + 4 * li;
      const bf16* in = li == 0 ? a0 : sx;
      const int lda = li == 0 ? lda0 : ldh, K = li == 0 ? d_in : H;
      const bool resum = relu && !(CH && li == 0);
      if (resum)  // the operand's row norms, for relu_uncertain
        operand_row_norms<BR>(in, lda, K, rnorm);
      bf16* a = act_tile(li);
      unsigned char* mrow = mask != nullptr ? mask + ((long long)li * R + row0) * H : nullptr;
      float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (CH && li == 0)
          chunked_layer0<BR, true>(x, x_bf16, row0, R, d_in, use_fn, fmu, finv,
                                   use_fn ? pb + offs[0] : nullptr,
                                   use_fn ? pb + offs[1] : nullptr, a0, lda0, wb + woffs[0], Hp,
                                   n0, ring, pt, acc);
        else
          gemm_stream<false>(in, lda, li == 0 ? Kp0 : Hp, wb + woffs[li] + n0, Hp,
                             min(MMA_HMAX, Hp - n0), ring, pt, acc, li == 0 ? 0 : ar);
        if (resum)
          resum_uncertain<BR>(acc, in, lda, K, wb + woffs[li], Hp, pb + o[1], H, rnorm,
                              cnorm + li * Hp, row0, R, pt, n0, flags);
        dense_act<BR>(acc, pb + o[1], H, n0, relu, pt, s, q);
        if (mrow != nullptr) store_relu_mask<BR>(acc, H, n0, pt, mrow, R - row0);
        store_pass<BR>(acc, a, ldh, n0, pt);
        if (dp) store_pass<BR>(acc, ds.act + (long long)li * BR * ldh, ldh, n0, pt);
      }
      float mu[2], inv[2];
      ln_stats<BR>(s, q, H, red, wt, mu, inv);
      if (wt.wn == 0 && (lane & 3) == 0) {
        for (int h = 0; h < 2; ++h) {
          mu_s[li * BR + wt.r0 + 8 * h] = mu[h];
          inv_s[li * BR + wt.r0 + 8 * h] = inv[h];
        }
      }
      if (li + 1 < L) {  // the next layer's operand
        for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
          const WarpTile pt = pass_tile<BR>(Hp, n0);
          if (multi) load_pass<BR>(acc, a, ldh, n0, pt);
#pragma unroll
          for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
            if (nt < pt.ntw) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = pt.r0 + 8 * h, c = n0 + pt.c0 + nt * 8;
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
      }
      __syncthreads();
    }
    if (!first && threadIdx.x == 0)  // this tile adds into the block's slot: into L2
      prefetch_l2_span((const char*)slot, slot_size * 4);
    // the cotangent of the trunk output, rows >= R zero (odd H: one element
    // at a time)
    auto top_g = [&](int n0, const WarpTile& pt) {
#pragma unroll
      for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + pt.r0 + 8 * h;
          const int c = n0 + pt.c0 + nt * 8;
          float2 v = make_float2(0.f, 0.f);
          if (nt < pt.ntw && row < R && c < H) {
            const float* p = gout + row * H + c;
            v = !DCC_WIDE || (H & 1) == 0
                    ? __ldg(reinterpret_cast<const float2*>(p))
                    : make_float2(__ldg(p), c + 1 < H ? __ldg(p + 1) : 0.f);
          }
          acc[nt][2 * h] = v.x;
          acc[nt][2 * h + 1] = v.y;
        }
      }
    };
    if (!multi) top_g(0, wt);
    // unfolded backward (dcc_tpu/ops/fused_mlp.py::_bwd_kernel); with more
    // than one column pass, each layer's cotangent is read pass by pass: the
    // last layer's from gout, the others' from the stage gprev_passes wrote
    for (int li = L - 1; li >= 0; --li) {
      const long long* o = offs + 2 + 4 * li;  // W, b, LN scale, LN bias
      // deep: layer li's tile into act (the last layer's is there from the
      // forward); every thread is done with act since the barrier after the
      // previous layer's LN backward
      if (dp && li + 1 < L) stage_tile<BR>(act, saved(li), ldh);
      const bf16* a = act_tile(li);
      const float* gf = gstage(li + 1);
      auto load_g = [&](int n0, const WarpTile& pt) {
        if (li + 1 == L)
          top_g(n0, pt);
        else
          load_pass_f32<BR>(acc, gf, ldgf, n0, pt);
      };
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (multi) load_g(n0, pt);
        ln_bwd_sums<BR, true>(acc, a, ldh, mu_s + li * BR, inv_s + li * BR, pb + o[2], H, n0, pt,
                              s1, s2);
      }
      ln_bwd_rows<BR>(s1, s2, H, red, wt);
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (multi) load_g(n0, pt);
        ln_bwd_apply<BR, true>(acc, a, ldh, mu_s + li * BR, inv_s + li * BR, pb + o[2], H, Hp,
                               n0, relu, s1, s2, pt, colsum, gs);
      }
      if (li >= 1 && li + 1 < L) {
        // this layer's operand, the previous layer's LN output, as the
        // forward wrote it (the last layer's is still in sx); more than one
        // pass: after every thread has read the stage, which lies over sx
        if (multi) __syncthreads();
        const long long* op = o - 4;
        const bf16* ap = saved(li - 1);
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
          float* dst = sb + o[k == 2 ? 1 : 2 + k] + j;
          *dst = first ? s : *dst + s;
        }
      }
      if (CH && li == 0) {
        // layer 0's bf16 cotangent and the rows' statistics, for the dV0
        // and layer-0 input backward kernels
        const int cpr = Hp / 8;  // 16-byte chunks of a row
        for (int i = threadIdx.x; i < BR * cpr; i += blockDim.x) {
          const int r = i / cpr, c = i - r * cpr;
          if (row0 + r < R)
            *reinterpret_cast<uint4*>(g0 + (row0 + r) * Hp + c * 8) =
                *reinterpret_cast<const uint4*>(gs + r * ldh + c * 8);
        }
        if (threadIdx.x < BR && row0 + threadIdx.x < R) {
          xstats[2 * (row0 + threadIdx.x)] = fmu[threadIdx.x];
          xstats[2 * (row0 + threadIdx.x) + 1] = finv[threadIdx.x];
        }
      } else {
        dw(li == 0 ? a0 : sx, li == 0 ? lda0 : ldh, li == 0 ? Kp0 : Hp, li == 0 ? d_in : H,
           sb + o[0], first);
      }
      if (li > 0) {  // g_prev = bf16(g) @ W^T
        if (multi) {  // into the stage over act[li ..] and sx, deep gst
          gprev_passes<BR>(gs, ldh, Hp, wb + woffs[li], Hp, ring, gstage(li), ldgf, ar);
          __syncthreads();
        } else {
          gemm_stream<true>(gs, ldh, Hp, wb + woffs[li], Hp, Hp, ring, wt, acc, ar);
        }
      }
    }
    if constexpr (CH) {
      __syncthreads();  // the next tile's forward writes over gs and a0
      continue;
    }
    // layer 0's g_prev = bf16(g) @ W_0^T over Kp0 columns into the stage
    // (over a0, which grad_at_g has finished reading)
    gprev_passes<BR>(gs, ldh, Hp, wb + woffs[0], Kp0, ring, stage, ldf, ar);
    __syncthreads();
    if (use_fn) {
      // feature norm: its scale and bias gradients (rows >= R have g = 0)
      const float* fs = pb + offs[0];
      fn_affine_grads<BR>(stage, ldf, x, x_bf16, row0, R, d_in, fmu, finv, slot + offs[0],
                          slot + offs[1], first);
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

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    trunk_bwd_mma_kernel(DCC_TRUNK_BWD_MMA_PARAMS, void* dx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_bwd_mma<BR, false>(smem_raw, x, x_bf16, gout, R, d_in, H, L, use_fn, relu, pb, offs, wb,
                           woffs, slots, slot_size, mask, deep, dx, nullptr, nullptr);
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    trunk_bwd_chunked_mma_kernel(DCC_TRUNK_BWD_MMA_PARAMS, bf16* g0, float* xstats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  trunk_bwd_mma<BR, true>(smem_raw, x, x_bf16, gout, R, d_in, H, L, use_fn, relu, pb, offs, wb,
                          woffs, slots, slot_size, mask, deep, nullptr, g0, xstats);
}

// ---------------------------------------------------------------------------
// The layer-0 input backward of the chunked K2b and K4u (ROADMAP B2) where
// d(x) is asked for or the hidden width is past 256 (layer0_tail.cu takes
// the update's calls, without d(x), at hidden widths to 256): the
// part of dcc_tpu/ops/fused_mlp.py::_bwd_kernel (and, unfolded,
// fused_ppo.py::_trunk_bwd) below layer 0's cotangent, at rows too wide to
// stage. From x, the rows' statistics xstats (mu, inv), layer 0's bf16
// cotangent g0 (R x Hp) and the bf16 W_0 (Kp0 x Hp): g_prev = g0 @ W_0^T
// (f32), then the feature norm's backward (_ln_bwd with its scale fs):
//   dfs[k] = sum_r g_prev[r][k] xhat[r][k], dfb[k] = sum_r g_prev[r][k],
//   dx[r][k] = inv[r] (g_prev fs - s1[r] - xhat s2[r]),
//   s1 = mean_k g_prev fs, s2 = mean_k g_prev fs xhat,
// and without the feature norm dx = g_prev. Each block loops over BR-row
// tiles: g0's rows are staged once, then g_prev is computed on the tensor
// cores in L0_KC-column chunks (gemm_stream over column slices of W_0),
// each chunk's x normalized into an f32 stage (its next chunk's rows load
// during the product). The first pass adds each chunk's column sums of
// g_prev xhat and g_prev into the block's slot [dfs (d_in), dfb (d_in)]
// (stored by its first tile, else added; summed over the blocks by
// slots.cuh's fixed-order reduction, no atomics) and keeps each row's
// partial s1 and s2 in registers, summed over the warps in a fixed order
// at the end. dx, whose row sums span all d_in columns, takes a second pass
// that computes g_prev again, and only where the caller reads dx (MAPPO's
// update does not: its rows are observations). Every sum is in f32 on the
// CUDA cores, round to nearest; g_prev's own products (K = H) accumulate
// on the tensor cores as the staged K2b's gprev_passes does. Bound: the
// products (2 or 4 R Kp0 Hp operations) against the bytes of x, g0 and,
// with dx, dx. In the column-blocked library (DCC_BLOCKED; hidden widths
// whose gs fits no block, past about 4,700) g0's rows are not staged: the
// products stream them from g0 through the ring (gemm_stream's arows, rows
// past R zero), in the same order.
// ---------------------------------------------------------------------------
#define L0_KC MMA_HMAX  // columns of a chunk of g_prev (one warp tiling's width)

struct L0Layout {
  size_t gs, ring, xh, colsum, red, mu, inv, total;
};

__host__ __device__ inline L0Layout l0_layout(int br, int H) {
  const size_t ldh = pad16(H) + 8;
  L0Layout m;
  size_t o = 0;
  m.gs = o;     o += DCC_BLOCKED ? 0 : 2 * br * ldh;
  m.ring = o;   o += ring_bytes(br, ring_stage(L0_KC, true));
  m.xh = o;     o += 4 * (size_t)br * (L0_KC + 4);
  m.colsum = o; o += 4 * 2 * (size_t)(br / 16) * L0_KC;
  m.red = o;    o += 4 * (size_t)(MMA_WARPS / (br / 16)) * br * 2;
  m.mu = o;     o += 4 * (size_t)br;
  m.inv = o;    o += 4 * (size_t)br;
  m.total = o;
  return m;
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    layer0_input_bwd_mma_kernel(const void* x, int x_bf16, long long R, int d_in,
                                const float* xstats, const bf16* g0, int H, const bf16* w0,
                                const float* fs, int use_fn, float* slots, void* dx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const L0Layout m = l0_layout(BR, H);
  const int Kp0 = pad16(d_in), Hp = pad16(H), ldh = Hp + 8, ldx = L0_KC + 4;
  bf16* gs = (bf16*)(smem_raw + m.gs);
  bf16* ring = (bf16*)(smem_raw + m.ring);
  float* xh = (float*)(smem_raw + m.xh);
  float* colsum = (float*)(smem_raw + m.colsum);
  float* red = (float*)(smem_raw + m.red);
  float* mu_s = (float*)(smem_raw + m.mu);
  float* inv_s = (float*)(smem_raw + m.inv);
  constexpr int WM = MmaTile<BR>::WM, NT = MmaTile<BR>::NT, RW = BR / MMA_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const WarpTile wt = warp_tile<BR>(L0_KC / 8);  // rows and column group: any chunk's
  float* slot = slots + (long long)blockIdx.x * 2 * d_in;  // [dfs, dfb]
  const long long tiles = (R + BR - 1) / BR;
  if (blockIdx.x >= tiles) {  // no rows for this block: its slot holds zeros
    if (use_fn)
      for (int i = threadIdx.x; i < 2 * d_in; i += blockDim.x) slot[i] = 0.f;
    return;
  }
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    const bool first = tile == blockIdx.x;
    // g0's rows (rows >= R zero; blocked: streamed by the products) and the
    // rows' statistics (0, 1 past R)
    const int cpr = DCC_BLOCKED ? 0 : Hp / 8;
    for (int i = threadIdx.x; i < BR * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - r * cpr;
      bf16* dst = gs + r * ldh + c * 8;
      if (row0 + r < R)
        cp_async16(dst, g0 + (row0 + r) * Hp + c * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    if (threadIdx.x < BR) {
      const bool in = row0 + threadIdx.x < R;
      mu_s[threadIdx.x] = in ? xstats[2 * (row0 + threadIdx.x)] : 0.f;
      inv_s[threadIdx.x] = in ? xstats[2 * (row0 + threadIdx.x) + 1] : 1.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};  // rows wt.r0, wt.r0 + 8
    // pass 0: the column sums and the row sums (with the feature norm);
    // pass 1: dx (where the caller reads it)
    for (int pass = use_fn ? 0 : 1; pass < (dx != nullptr ? 2 : 1); ++pass) {
      float xv[RW][8];
      if (use_fn) fetch_chunk<BR>(x, x_bf16, row0, R, d_in, 0, xv);
      for (int k0 = 0; k0 < Kp0; k0 += L0_KC) {
        const int nc = min(L0_KC, Kp0 - k0);
        if (use_fn) {
          // xhat of the chunk, f32: xh[r][8 lane + e]
#pragma unroll
          for (int j = 0; j < RW; ++j) {
            const int r = warp + j * MMA_WARPS;
            float4 v[2];
            float* f = reinterpret_cast<float*>(v);
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = (xv[j][e] - mu_s[r]) * inv_s[r];
            *reinterpret_cast<float4*>(xh + r * ldx + 8 * lane) = v[0];
            *reinterpret_cast<float4*>(xh + r * ldx + 8 * lane + 4) = v[1];
          }
          if (k0 + L0_KC < Kp0)  // in flight during this chunk's product
            fetch_chunk<BR>(x, x_bf16, row0, R, d_in, k0 + L0_KC, xv);
        }
        const WarpTile pt = warp_tile<BR>(nc / 8);
        float acc[NT][4];
        // g_prev of the chunk; its first barrier publishes xh
        if (DCC_BLOCKED)
          gemm_stream<true>(g0 + row0 * Hp, Hp, Hp, w0 + (long long)k0 * Hp, Hp, nc, ring, pt,
                            acc, BR, (int)min((long long)BR, R - row0));
        else
          gemm_stream<true>(gs, ldh, Hp, w0 + (long long)k0 * Hp, Hp, nc, ring, pt, acc);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= pt.ntw) continue;
          float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // g xhat, g: columns c, c + 1
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1, r = pt.r0 + 8 * h, c = pt.c0 + nt * 8 + (i & 1), k = k0 + c;
            if (k >= d_in || row0 + r >= R) continue;
            const float g = acc[nt][i];
            if (!use_fn) {
              if (x_bf16)
                ((bf16*)dx)[(row0 + r) * d_in + k] = __float2bfloat16_rn(g);
              else
                ((float*)dx)[(row0 + r) * d_in + k] = g;
              continue;
            }
            const float xhat = xh[r * ldx + c], gg = g * __ldg(fs + k);
            if (pass == 0) {
              s1[h] += gg;
              s2[h] += gg * xhat;
              cs[0][i & 1] += g * xhat;
              cs[1][i & 1] += g;
            } else {
              const float v = inv_s[r] * (gg - s1[h] - xhat * s2[h]);
              if (x_bf16)
                ((bf16*)dx)[(row0 + r) * d_in + k] = __float2bfloat16_rn(v);
              else
                ((float*)dx)[(row0 + r) * d_in + k] = v;
            }
          }
          if (pass == 0) {  // over the warp's 16 rows: lanes with one lane & 3
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int o = 4; o < 32; o <<= 1)
                  cs[q][e] += __shfl_xor_sync(0xffffffffu, cs[q][e], o);
            const int c = pt.c0 + nt * 8;
            if (lane < 4) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                colsum[(q * WM + pt.wm) * L0_KC + c] = cs[q][0];
                colsum[(q * WM + pt.wm) * L0_KC + c + 1] = cs[q][1];
              }
            }
          }
        }
        __syncthreads();  // colsum written; xh read
        if (pass == 0) {
          // the chunk's column sums over the tile, warps in order, into the slot
          for (int j = threadIdx.x; j < nc && k0 + j < d_in; j += blockDim.x) {
            float sx = 0.f, sg = 0.f;
            for (int w = 0; w < WM; ++w) {
              sx += colsum[w * L0_KC + j];
              sg += colsum[(WM + w) * L0_KC + j];
            }
            float* ds = slot + k0 + j;
            float* db = slot + d_in + k0 + j;
            *ds = first ? sx : *ds + sx;
            *db = first ? sg : *db + sg;
          }
        }
      }
      if (pass == 0) {
        row_sums<BR>(s1, s2, red, wt);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s1[h] /= d_in;
          s2[h] /= d_in;
        }
      }
    }
    __syncthreads();  // the next tile writes over gs and the statistics
  }
}

template <int BR>
static int launch(const void* x, int x_bf16, const float* g, long long R, int d_in, int H,
                  int L, int use_fn, int relu, const float* pb, const long long* o,
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
                      int L, int use_fn, int relu, const float* pb, const long long* o,
                      const bf16* wb, const long long* wo, float* slots, long long slot_size,
                      int n_blocks, float* out, void* dx, unsigned char* mask,
                      unsigned char* deep, cudaStream_t s) {
  static bool smem_set = false;
  auto k = trunk_bwd_mma_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = bwd_mma_layout(BR, d_in, H, L, false, deep != nullptr).total;
  k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, wb,
                                        wo, slots, slot_size, mask, deep, dx);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

template <int BR>
static int launch_chunked_mma(const void* x, int x_bf16, const float* g, long long R, int d_in,
                              int H, int L, int use_fn, int relu, const float* pb,
                              const long long* o, const bf16* wb, const long long* wo,
                              float* slots, long long slot_size, int n_blocks, float* out,
                              bf16* g0, float* xstats, unsigned char* mask, unsigned char* deep,
                              cudaStream_t s) {
  static bool smem_set = false;
  auto k = trunk_bwd_chunked_mma_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = bwd_mma_layout(BR, d_in, H, L, true, deep != nullptr).total;
  k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, wb,
                                        wo, slots, slot_size, mask, deep, g0, xstats);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

template <int BR>
static int launch_layer0(const void* x, int x_bf16, long long R, int d_in, const float* xstats,
                         const bf16* g0, int H, const bf16* w0, const float* fs, int use_fn,
                         float* slots, int n_blocks, float* out, void* dx, cudaStream_t s) {
  static bool smem_set = false;
  auto k = layer0_input_bwd_mma_kernel<BR>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  k<<<n_blocks, MMA_THREADS, l0_layout(BR, H).total, s>>>(x, x_bf16, R, d_in, xstats, g0, H,
                                                          w0, fs, use_fn, slots, dx);
  const int err = (int)cudaGetLastError();
  if (err || !use_fn) return err;
  return reduce(slots, n_blocks, 2LL * d_in, out, s);
}

extern "C" unsigned long long dcc_trunk_bwd_smem_bytes(int br, int d_in, int H, int L) {
  return sizeof(float) * unfolded_smem_floats(br, d_in, H, L);
}

extern "C" unsigned long long dcc_trunk_bwd_mma_smem_bytes(int br, int d_in, int H, int L,
                                                           int deep) {
  return bwd_mma_layout(br, d_in, H, L, false, deep).total;
}

// Bytes of one block's scratch in the depth layout of every bf16 gradient
// kernel (K2b here, K3 / K4 and K3u / K4u in fused_ppo.cu, which share
// trunk_mma.cuh's deep_scratch_bytes).
extern "C" unsigned long long dcc_deep_scratch_bytes(int br, int H, int L) {
  return deep_scratch_bytes(br, H, L);
}

// Bytes of one block's scratch in the column-blocked layout (the blocked
// libraries' gradient kernels; chunked: their chunked layout).
extern "C" unsigned long long dcc_blocked_scratch_bytes(int br, int d_in, int H, int L,
                                                        int chunked) {
  return blocked_scratch_bytes(br, d_in, H, L, chunked);
}

// f32 (FMA). offs: a device table of [fn scale, fn bias, (W, b, LN scale,
// LN bias) x L, W^T x L] into pb (2 + 5L entries; the first 2 + 4L also
// locate each gradient in a slot). slots is n_blocks x slot_size scratch;
// out receives the slot_size summed gradients; dx has x's dtype and shape.
extern "C" int dcc_trunk_bwd(const void* x, int x_bf16, const float* g, long long R,
                             int d_in, int H, int L, int use_fn, int relu, int br,
                             const float* pb, const long long* offs, int n_offs, float* slots,
                             long long slot_size, int n_blocks, float* out, void* dx,
                             void* stream) {
  if (L < 1 || n_offs != 2 + 5 * L || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* o = offs;
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

// bf16 on the tensor cores: br in {64, 32, 16}; any H whose tile fits
// (dcc_trunk_bwd_mma_smem_bytes); offs: a device table of [fn scale, fn
// bias, (W, b, LN scale, LN bias) x L] into pb and into a slot (2 + 4L
// entries); woffs: a device table of the bf16 W_li in wb; mask null or the
// relu masks' debug output (L x R x H bytes); deep null (the staged
// layout) or the depth layout's scratch, n_blocks x dcc_deep_scratch_bytes
// (the blocked library: n_blocks x dcc_blocked_scratch_bytes, required).
extern "C" int dcc_trunk_bwd_mma(const void* x, int x_bf16, const float* g, long long R,
                                 int d_in, int H, int L, int use_fn, int relu, int br,
                                 const float* pb, const long long* offs, int n_offs,
                                 const void* wb, const long long* woffs, int n_woffs,
                                 float* slots, long long slot_size, int n_blocks, float* out,
                                 void* dx, void* mask, void* deep, void* stream) {
  if (L < 1 || n_offs != 2 + 4 * L || n_woffs != L || n_blocks < 1 || !mma_width_ok(H) ||
      (DCC_BLOCKED && deep == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long *o = offs, *wo = woffs;
  const bf16* w = (const bf16*)wb;
  unsigned char* m = (unsigned char*)mask;
  unsigned char* dp = (unsigned char*)deep;
#define DCC_CASE(B)                                                                      \
  case B:                                                                                \
    return launch_mma<B>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, w, wo, slots, \
                         slot_size, n_blocks, out, dx, m, dp, s);
  switch (br) {
    DCC_CASE(64)
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
}

// bf16 K2b with the chunked layer 0 (rows too wide for a staged tile): br
// in {32, 16}; as dcc_trunk_bwd_mma, but slots and out hold the slot from
// layer 0's bias on (slot_size floats: every offset less offs[3]), and the
// kernel writes g0 (R x pad16(H) bf16) and xstats (R x 2 f32) for
// dcc_dv0_wgmma and dcc_layer0_input_bwd_wgmma (layer0_tail.cu) or
// dcc_layer0_input_bwd_mma; no dx.
extern "C" int dcc_trunk_bwd_chunked_mma(const void* x, int x_bf16, const float* g, long long R,
                                         int d_in, int H, int L, int use_fn, int relu, int br,
                                         const float* pb, const long long* offs, int n_offs,
                                         const void* wb, const long long* woffs, int n_woffs,
                                         float* slots, long long slot_size, int n_blocks,
                                         float* out, void* g0, float* xstats, void* mask,
                                         void* deep, void* stream) {
  if (L < 1 || n_offs != 2 + 4 * L || n_woffs != L || n_blocks < 1 || !mma_width_ok(H) ||
      (DCC_BLOCKED && deep == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long *o = offs, *wo = woffs;
  const bf16* w = (const bf16*)wb;
  unsigned char* m = (unsigned char*)mask;
  unsigned char* dp = (unsigned char*)deep;
#define DCC_CASE(B)                                                                        \
  case B:                                                                                  \
    return launch_chunked_mma<B>(x, x_bf16, g, R, d_in, H, L, use_fn, relu, pb, o, w, wo,  \
                                 slots, slot_size, n_blocks, out, (bf16*)g0, xstats, m, dp, \
                                 s);
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
}

extern "C" unsigned long long dcc_trunk_bwd_mma_chunked_smem_bytes(int br, int d_in, int H,
                                                                   int L, int deep) {
  return bwd_mma_layout(br, d_in, H, L, true, deep).total;
}

// The layer-0 input backward: br in {64, 32, 16}; g0 R x pad16(H) bf16, w0
// the bf16 W_0 (pad16(d_in) x pad16(H)); with use_fn, fs (d_in f32) and
// slots (n_blocks x 2 d_in scratch) give out = [dfs, dfb] (2 d_in f32);
// dx (x's dtype) is written where not null; one of the two at least.
extern "C" int dcc_layer0_input_bwd_mma(const void* x, int x_bf16, long long R, int d_in,
                                        const float* xstats, const void* g0, int H,
                                        const void* w0, const float* fs, int use_fn, int br,
                                        float* slots, int n_blocks, float* out, void* dx,
                                        void* stream) {
  if (H < 1 || n_blocks < 1 || d_in < 1 || (!use_fn && dx == nullptr) ||
      (use_fn && (fs == nullptr || slots == nullptr || out == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* g = (const bf16*)g0;
  const bf16* w = (const bf16*)w0;
#define DCC_CASE(B)                                                                        \
  case B:                                                                                  \
    return launch_layer0<B>(x, x_bf16, R, d_in, xstats, g, H, w, fs, use_fn, slots,        \
                            n_blocks, out, dx, s);
  switch (br) {
    DCC_CASE(64)
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
}

extern "C" unsigned long long dcc_layer0_input_bwd_smem_bytes(int br, int H) {
  return l0_layout(br, H).total;
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
