// K3 / K4: fused PPO loss + parameter-gradient kernels for the actor and the
// critic, in two modes: folded (every LN affine absorbed into the next
// matmul, dcc_tpu/ops/fused_ppo.py::fold_trunk) and unfolded (K3u / K4u: the
// LN affines applied inside the kernel as the trunk writes them,
// dcc_tpu/ops/fused_mlp.py::_forward_chain, and every LN scale and bias
// gradient accumulated directly, fused_ppo.py::_trunk_bwd).
//
// Replace the Pallas kernels dcc_tpu/ops/fused_ppo.py::_actor_kernel
// (actor_ppo_grads_packed -> _make_actor_op) and ::_critic_kernel
// (critic_value_grads_packed -> _make_critic_op), folded=True and
// folded=False. Every PPO epoch runs each once over all T*E*A actor rows /
// T*E critic rows, or once per minibatch over its gathered rows.
//
// What bounds them on an H100: per row, the forward and the backward do
// ~3 * 2 * (d_in * H + H * H) operations against d_in * (2 or 4) bytes of
// input, so the work is compute-bound. In bf16 all four
// (actor_grads_mma_kernel, critic_grads_mma_kernel and their unfolded
// twins) run every product on the tensor cores; in f32 they run them on the
// CUDA cores in FP32 FMA (67 TFLOP/s). Every kernel re-reads and re-writes
// its block's gradient slot once per tile after its first, which bounds the
// bf16 kernels at large batch.
//
// Design. The Pallas kernels accumulate the weight gradients into one output
// block across a sequential grid, which is race-free only on a TPU. Here a
// fixed grid of blocks loops over row tiles; each block
// keeps the tile's forward cache (input, activations, LN outputs and
// 1/sigma per layer) in shared memory, runs the loss head and the full
// backward on it, and adds the tile's gradients into its OWN slot of
// a scratch buffer (each slot element has one owner thread). A second small
// kernel sums the slots in a fixed order. The result is deterministic and
// uses no atomics. bf16 K3, K4, K3u and K4u at rows too wide to stage (the
// 20-UAV preset's 4,840-wide critic rows; 4 UAVs x 300 PoIs, whose actor
// rows are 1,510 wide) stream layer 0 in column chunks and hand layer 0's
// weight gradient to dv0_wgmma_kernel (layer0_tail.cu), whose (d_in x H)
// sum would not fit a slot that every tile re-reads (see there). The ragged last tile is masked in
// the kernel, so rows are never padded. Loss and backward elementwise math
// is f32 with JAX's autodiff tie rules: min / max split the cotangent 50/50
// on ties, clip composes the two.
#include "slots.cuh"
#include "trunk_mma.cuh"

#define DCC_LOG_SQRT_2PI 0.91893853320467274178f

// d min(x, y) / dx under JAX's balanced-tie convention.
__device__ __forceinline__ float balanced_lt(float x, float y) {
  return x < y ? 1.f : (x > y ? 0.f : 0.5f);
}

// d clip(x, lo, hi) / dx with clip = min(max(x, lo), hi), balanced ties.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float gmax = x > lo ? 1.f : (x < lo ? 0.f : 0.5f);
  const float m = fmaxf(x, lo);
  const float gmin = m < hi ? 1.f : (m > hi ? 0.f : 0.5f);
  return gmax * gmin;
}

__device__ __forceinline__ float huber_fn(float e, float delta, int use_huber) {
  if (!use_huber) return e * e / 2.f;
  const float a = fabsf(e) <= delta ? 1.f : 0.f;
  const float b = e > delta ? 1.f : 0.f;  // one-sided, as the reference
  return a * e * e / 2.f + b * delta * (fabsf(e) - delta / 2.f);
}

__device__ __forceinline__ float huber_grad(float e, float delta, int use_huber) {
  if (!use_huber) return e;
  const float a = fabsf(e) <= delta ? 1.f : 0.f;
  const float b = e > delta ? 1.f : 0.f;
  return a * e + b * delta;
}

// Shared-memory layout of one f32 block: the trunk cache plus per-row head
// values (2 * A + 2 floats a row); unfolded, also the trunk output (H
// floats a row), the last layer's LN affine, which the unfolded cache does
// not keep.
template <int BR>
__device__ TrunkCache carve(float* smem, int d_in, int H, int L) {
  TrunkCache c;
  c.a0 = smem;
  c.act = c.a0 + BR * d_in;
  c.xhat = c.act + (long long)L * BR * H;
  c.g = c.xhat + (long long)L * BR * H;
  c.inv = c.g + BR * H;
  return c;
}

__host__ __device__ inline size_t ppo_smem_floats(int br, int d_in, int H, int L, int A) {
  return (size_t)br * (d_in + 2 * (size_t)L * H + H + L + 2 * A + 2);
}

__host__ __device__ inline size_t ppo_unfolded_smem_floats(int br, int d_in, int H, int L,
                                                           int A) {
  return unfolded_smem_floats(br, d_in, H, L) + (size_t)br * (H + 2 * A + 2);
}

// Folded gradient slot layout: trunk.cuh's FoldedSlot (per layer [dV, du]),
// then the head [dW (H x A), db (A)], then per-kind extras (actor: dlog_std
// (A) and [loss_sum, ratio_sum]; critic: [value_loss_sum]). Unfolded, the
// slot starts with the flat trunk list's gradients at the parameter
// offsets (fn scale, fn bias, then W, b, LN scale, LN bias per layer) and
// the head follows at offs[2 + 4L].

// The f32 trunk of one tile for the loss kernels: the folded chain
// (trunk.cuh's trunk_fwd_folded / trunk_bwd_folded on c) or the unfolded
// one (trunk_fwd_unfolded / trunk_bwd_unfolded on u, plus the trunk output's
// LN affine into feat). Parameter offsets (a device table): folded, V_li at
// offs[3 li], V_li^T at offs[3 li + 1], u_li at offs[3 li + 2], the head at
// offs[3L]; unfolded, the flat trunk list (offs[0 .. 2 + 4L)), W_li^T at
// offs[2 + 4L + li], the head at offs[2 + 5L].
template <int BR, bool UNF>
struct F32Trunk {
  TrunkCache c;
  UnfoldedCache u;
  float* feat;  // BR x H: the trunk output (the head's input)
  float* g;     // BR x H: its cotangent
  float* rest;  // the per-row head values
  FoldedSlot fslot;  // folded: each layer's [dV, du]
  float* head;  // the head's part of the slot
  int hoff;     // offs index of the head's weights

  __device__ F32Trunk(float* smem, float* slot, int d_in, int H, int L, int A,
                      const long long* offs)
      : fslot(slot, d_in, H) {
    if constexpr (UNF) {
      u = carve_unfolded<BR>(smem, d_in, H, L);
      feat = u.inv + (L + 1) * BR;
      g = u.g;
      rest = feat + BR * H;
      head = slot + offs[2 + 4 * L];
      hoff = 2 + 5 * L;
    } else {
      c = carve<BR>(smem, d_in, H, L);
      feat = c.xhat + (long long)(L - 1) * BR * H;
      g = c.g;
      rest = c.inv + BR * L;
      head = fslot.head(L);
      hoff = 3 * L;
    }
  }

  __device__ void forward(const void* x, int x_bf16, long long row0, long long R, int d_in,
                          int H, int L, int use_fn, int relu, const float* pb,
                          const long long* offs) {
    if constexpr (UNF) {
      trunk_fwd_unfolded<BR>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs, u);
      affine_tile<BR>(u.xh + (long long)(L - 1) * BR * H, feat, H, pb + offs[4 * L],
                      pb + offs[4 * L + 1]);
      __syncthreads();
    } else {
      trunk_fwd_folded<BR>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs, c);
    }
  }

  __device__ void backward(int d_in, int H, int L, int use_fn, int relu, const float* pb,
                           const long long* offs, float* slot) {
    if constexpr (UNF)
      trunk_bwd_unfolded<BR>(d_in, H, L, use_fn, relu, pb, offs, u, slot);
    else
      trunk_bwd_folded<BR>(d_in, H, L, relu, pb, offs, c, fslot);
  }
};

// ---------------------------------------------------------------------------
// K3 / K3u: actor, f32 (the bf16 actor is actor_grads_mma_kernel below).
// aux rows: [action (A), old_log_prob, advantage, valid]. Head: Wh (H x A),
// bh, log_std at the head's offsets.
// ---------------------------------------------------------------------------
template <int BR, bool UNF>
__global__ void __launch_bounds__(DCC_THREADS)
    actor_grads_kernel(const void* x, int x_bf16, const float* aux, long long R,
                       int d_in, int H, int L, int A, int use_fn, int relu,
                       float clip, const float* pb, const long long* offs, float* slots,
                       long long slot_size) {
  extern __shared__ float smem[];
  float* slot = slots + (long long)blockIdx.x * slot_size;
  F32Trunk<BR, UNF> t(smem, slot, d_in, H, L, A, offs);
  float* dmean = t.rest;  // BR x A
  float* row_dls = dmean + BR * A; // BR x A
  float* row_loss = row_dls + BR * A;
  float* row_ratio = row_loss + BR;

  for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
  float* s_wh = t.head;
  float* s_bh = s_wh + H * A;
  float* s_ls = s_bh + A;
  float* s_met = s_ls + A;
  const float* Wh = pb + offs[t.hoff];
  const float* bh = pb + offs[t.hoff + 1];
  const float* log_std = pb + offs[t.hoff + 2];
  const float* feat = t.feat;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    t.forward(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs);
    // head + loss, one warp per row
    for (int r = warp; r < BR; r += nw) {
      const long long row = row0 + r;
      float lp = 0.f;
      float zd[4];
      float isd[4];
      for (int d = 0; d < A; ++d) {
        float s = 0.f;
        for (int h = lane; h < H; h += 32)
          s = fmaf(feat[r * H + h], Wh[h * A + d], s);
        s = warp_sum(s);
        const float mean = s + bh[d];
        const float ls = log_std[d];
        isd[d] = expf(-ls);
        const float act = row < R ? aux[row * (A + 3) + d] : 0.f;
        zd[d] = (act - mean) * isd[d];
        lp += -0.5f * zd[d] * zd[d] - ls - DCC_LOG_SQRT_2PI;
      }
      if (lane == 0) {
        float loss = 0.f, rv = 0.f, dlp = 0.f;
        if (row < R) {
          const float* ar = aux + row * (A + 3);
          const float old_lp = ar[A], adv = ar[A + 1], valid = ar[A + 2];
          const float ratio = expf(lp - old_lp);
          const float clipped = fminf(fmaxf(ratio, 1.f - clip), 1.f + clip);
          const float s1 = ratio * adv, s2 = clipped * adv;
          loss = -fminf(s1, s2);
          rv = ratio * valid;
          const float w1 = balanced_lt(s1, s2);
          const float dratio =
              -(w1 * adv + (1.f - w1) * adv * clip_grad(ratio, 1.f - clip, 1.f + clip));
          dlp = dratio * ratio;
        }
        row_loss[r] = loss;
        row_ratio[r] = rv;
        for (int d = 0; d < A; ++d) {
          dmean[r * A + d] = dlp * zd[d] * isd[d];
          row_dls[r * A + d] = dlp * (zd[d] * zd[d] - 1.f);
        }
      }
    }
    __syncthreads();
    // head gradients (fixed row order)
    for (int e = threadIdx.x; e < H * A; e += blockDim.x) {
      const int h = e / A, d = e - h * A;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < BR; ++r)
        s = fmaf(feat[r * H + h], dmean[r * A + d], s);
      s_wh[e] += s;
    }
    if (threadIdx.x < A) {
      const int d = threadIdx.x;
      float sb = 0.f, sl = 0.f;
      for (int r = 0; r < BR; ++r) {
        sb += dmean[r * A + d];
        sl += row_dls[r * A + d];
      }
      s_bh[d] += sb;
      s_ls[d] += sl;
    } else if (threadIdx.x == A) {
      float sl = 0.f, sr = 0.f;
      for (int r = 0; r < BR; ++r) {
        sl += row_loss[r];
        sr += row_ratio[r];
      }
      s_met[0] += sl;
      s_met[1] += sr;
    }
    // feature cotangent g = dmean @ Wh^T
    for (int i = threadIdx.x; i < BR * H; i += blockDim.x) {
      const int r = i / H, h = i - r * H;
      float s = 0.f;
      for (int d = 0; d < A; ++d)
        s = fmaf(dmean[r * A + d], Wh[h * A + d], s);
      t.g[i] = s;
    }
    __syncthreads();
    t.backward(d_in, H, L, use_fn, relu, pb, offs, slot);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4 / K4u: critic, f32 (the bf16 critic is critic_grads_mma_kernel below).
// aux rows: [vpred, ret_raw, valid]; norm = [shift, scale]
// applies the value normalizer in-kernel: target = (ret_raw - shift) / scale.
// Head: wv (H), bv at the head's offsets.
// ---------------------------------------------------------------------------
template <int BR, bool UNF>
__global__ void __launch_bounds__(DCC_THREADS)
    critic_grads_kernel(const void* x, int x_bf16, const float* aux,
                        const float* norm, long long R, int d_in, int H, int L,
                        int use_fn, int relu, float clip, float delta,
                        int use_huber, int use_clipped, const float* pb,
                        const long long* offs, float* slots, long long slot_size) {
  extern __shared__ float smem[];
  float* slot = slots + (long long)blockIdx.x * slot_size;
  F32Trunk<BR, UNF> t(smem, slot, d_in, H, L, 1, offs);
  float* dv = t.rest;  // BR
  float* row_loss = dv + BR;

  for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
  float* s_wv = t.head;
  float* s_bv = s_wv + H;
  float* s_met = s_bv + 1;
  const float* wv = pb + offs[t.hoff];
  const float bv = pb[offs[t.hoff + 1]];
  const float shift = norm[0], scale = norm[1];
  const float* feat = t.feat;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    t.forward(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb, offs);
    for (int r = warp; r < BR; r += nw) {
      const long long row = row0 + r;
      float s = 0.f;
      for (int h = lane; h < H; h += 32)
        s = fmaf(feat[r * H + h], wv[h], s);
      s = warp_sum(s);
      if (lane == 0) {
        float loss = 0.f, g = 0.f;
        if (row < R) {
          const float v = s + bv;
          const float* ar = aux + row * 3;
          const float vpred = ar[0], valid = ar[2];
          const float ret = (ar[1] - shift) / scale;
          const float err = ret - v;
          float dl;
          if (use_clipped) {
            const float dv_raw = v - vpred;
            const float v_clip = vpred + fminf(fmaxf(dv_raw, -clip), clip);
            const float err_c = ret - v_clip;
            const float h1 = huber_fn(err, delta, use_huber);
            const float h2 = huber_fn(err_c, delta, use_huber);
            loss = fmaxf(h1, h2) * valid;
            const float w1 = balanced_lt(h2, h1);
            dl = -(w1 * huber_grad(err, delta, use_huber) +
                   (1.f - w1) * huber_grad(err_c, delta, use_huber) *
                       clip_grad(dv_raw, -clip, clip));
          } else {
            loss = huber_fn(err, delta, use_huber) * valid;
            dl = -huber_grad(err, delta, use_huber);
          }
          g = dl * valid;
        }
        dv[r] = g;
        row_loss[r] = loss;
      }
    }
    __syncthreads();
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < BR; ++r) s = fmaf(feat[r * H + h], dv[r], s);
      s_wv[h] += s;
    }
    if (threadIdx.x == 0) {
      float sb = 0.f, sl = 0.f;
      for (int r = 0; r < BR; ++r) {
        sb += dv[r];
        sl += row_loss[r];
      }
      s_bv[0] += sb;
      s_met[0] += sl;
    }
    for (int i = threadIdx.x; i < BR * H; i += blockDim.x) {
      const int r = i / H, h = i - r * H;
      t.g[i] = dv[r] * wv[h];
    }
    __syncthreads();
    t.backward(d_in, H, L, use_fn, relu, pb, offs, slot);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K3 / K4 and K3u / K4u in bf16, on the tensor cores (trunk_mma.cuh): one
// kernel body, ppo_grads_mma<BR, UNF>, shared by the actor and the critic
// and by both chains; only the head's loss (ActorLoss, CriticLoss below)
// and the chain (UNF) differ. Every product of the forward and backward is
// an mma.sync bf16 product with f32 accumulation: the forward's a @ W, the
// backward's g_prev = bf16(g) W^T and dW = bf16(in)^T bf16(g). The head
// (A <= 4 outputs) and the loss stay on the CUDA cores. The forward cache
// is bf16, which holds it exactly: every activation is a bf16 value (relu
// of a bf16 z, or bf16(tanh)), and each layer's LN output is recomputed
// from it with the forward's expression.
//
// Folded (dcc_tpu/ops/fused_ppo.py::_fwd_chain_folded): the operands are
// bf16(xhat) and the weights V = diag(s) W. Unfolded (_forward_chain /
// _trunk_bwd), as K2b runs the chain: the operands are the LN affine
// outputs bf16(xhat * s + c) (ln_affine), the feature norm's affine is
// applied when the input tile is loaded, the LN backward takes the scale
// (ln_bwd_apply) and gives the LN scale and bias gradients, and layer
// 0's g_prev (over d_in columns, in passes staged over the dead activation
// tiles) gives the feature norm's. The unfolded forward re-sums the
// pre-activations whose relu side a summation order can change
// (resum_uncertain), as K2b does.
// Shared memory of one block (BR rows, Kp0 = pad16(d_in), Hp = pad16(H);
// bf16 tiles with rows padded by 8 elements):
//   a0    BR x Kp0   layer 0's operand; chunked, BR x MMA_KC, one column
//         chunk of it at a time
//   act   L x BR x Hp  each layer's activation
//   sx    BR x Hp    the operand of layer li >= 1
//   stage BR x (Kp0 + 4) f32, unfolded and staged only: layer 0's g_prev,
//         over a0, act and sx (and beyond them where it is larger); at
//         hidden widths of more than one column pass, each layer li >= 1's
//         g_prev, BR x (Hp + 4) f32 over act[li ..] and sx (trunk_mma.cuh)
//   gs    BR x Hp    bf16 of the current layer's cotangent
//   ring  the stages of the weight stream
//   f32:  mu, inv (L x BR), unfolded and chunked the feature norm's mu,
//         inv (BR),
//         row-sum partials, column sums (BR/16 x Hp; unfolded 3 x),
//         bf16 of the head's weights (H x A), folded the biases u (L x H),
//         both loaded once per block, per-row head values (the outputs'
//         cotangents and extra gradients, BR x A each; two metrics),
//         unfolded the operand's row norms (BR), the weights' column norms
//         (L x Hp) and the list of re-sums
// Each tile's gradients go into the block's own slot, stored by the
// block's first tile and added by the others; every slot element has one
// owner thread. dW is accumulated per tile in 32 x 64 register slabs. At
// d_in 440 a 64-row tile needs more than a block's shared memory, so the
// critic takes 32- or 16-row tiles (unfolded, the actor 32 at d_in 110).
// Depth layout (deep; trunk_mma.cuh's DeepScratch), as K2b's:
// act holds one layer's tile (after the forward, the last layer's: the
// head's input), the layers' tiles, mu, inv and (unfolded) the column norms
// live in the block's scratch, the folded biases u are read from pb, and at
// more than one column pass a layer the f32 g_prev has its own stage gst;
// shared memory then does not grow with L.
// Column-blocked layout (fused_ppo_blocked.cu, DCC_BLOCKED; hidden widths
// whose smallest tile fits no other layout), as K2b's: the depth layout
// with act (every layer's tile, read where it lies), sx, gs, gst, the
// stage, the column sums and the head's weights in the block's scratch
// (trunk_mma.cuh), so that shared memory does not grow with H.
// ---------------------------------------------------------------------------
struct PpoMmaLayout {
  size_t a0, act, sx, gst, stage, gs, ring, mu, inv, fmu, finv, red, colsum, wh, u, dout, ext,
      met, rnorm, cnorm, flags, total;
};

__host__ __device__ inline PpoMmaLayout ppo_mma_layout(int br, int d_in, int H, int L, int A,
                                                       bool unf, bool chunked = false,
                                                       bool deep = false) {
  const size_t Kp0 = pad16(d_in), Hp = pad16(H), ldh = Hp + 8;
  const bool blk = DCC_BLOCKED;  // the tiles H wide in the scratch
  deep = deep || blk;
  const size_t Ls = deep ? 0 : L;  // layers whose tiles and statistics stay in shared memory
  const size_t tile = blk ? 0 : 2 * br * ldh;  // a bf16 tile H wide in shared memory
  const bool fn_stats = unf || chunked;
  // unfolded and staged: the widest column pass of layer 0's g_prev
  const bool gprev0 = unf && !chunked;
  const int nk = gprev0 ? pass_cols((int)Kp0) : 0, nh = pass_cols((int)Hp);
  const int st_kn = ring_stage(nh, false);
  const int st_nk = ring_stage(nk > nh ? nk : nh, true);
  PpoMmaLayout m;
  size_t o = 0;
  m.a0 = o;     o += 2 * br * (chunked ? MMA_KC + 8 : Kp0 + 8);
  m.act = o;    o += (deep ? 1 : (size_t)L) * tile;
  m.sx = o;     o += tile;
  m.gst = o;    o += !blk && deep && Hp > MMA_HMAX ? 4 * br * (Hp + 4) : 0;
  m.stage = 0;
  if (gprev0 && !blk && o < 4 * br * (Kp0 + 4)) o = 4 * br * (Kp0 + 4);
  m.gs = o;     o += tile;
  m.ring = o;   o += ring_bytes(br, st_kn > st_nk ? st_kn : st_nk);
  m.mu = o;     o += 4 * Ls * br;
  m.inv = o;    o += 4 * Ls * br;
  m.fmu = o;    o += fn_stats ? 4 * (size_t)br : 0;
  m.finv = o;   o += fn_stats ? 4 * (size_t)br : 0;
  m.red = o;    o += 4 * (size_t)(MMA_WARPS / (br / 16)) * br * 2;
  m.colsum = o; o += blk ? 0 : 4 * (unf ? 3 : 1) * (size_t)(br / 16) * Hp;
  m.wh = o;     o += blk ? 0 : 4 * (size_t)H * A;
  m.u = o;      o += unf ? 0 : 4 * Ls * H;
  m.dout = o;   o += 4 * (size_t)br * A;
  m.ext = o;    o += 4 * (size_t)br * A;
  m.met = o;    o += 4 * 2 * (size_t)br;
  m.rnorm = o;  o += unf ? 4 * (size_t)br : 0;
  m.cnorm = o;  o += unf ? 4 * Ls * Hp : 0;
  m.flags = o;  o += unf ? RESUM_BYTES : 0;
  m.total = o;
  return m;
}

// The loss heads. row() takes one row's head dot products s[d] = sum_h
// bf16(feat_h) bf16(W_hd) (d < A, f32) and gives each output's cotangent
// dout[d], its extra gradient ext[d] (when EXT) and the row's NMET metrics.
// Rows at or beyond R give zeros.
struct ActorLoss {  // Gaussian head, clipped surrogate; aux [action (A), old_lp, adv, valid]
  static constexpr int NMET = 2;     // loss, ratio * valid
  static constexpr bool EXT = true;  // d log_std
  const float* aux;
  const float* bh;
  const float* log_std;
  float clip;
  int A;

  __device__ void row(long long row, long long R, const float (&s)[4], float (&dout)[4],
                      float (&ext)[4], float (&met)[NMET]) const {
    float lp = 0.f, zd[4], isd[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      zd[d] = isd[d] = 0.f;
      if (d < A) {
        const float mean = bf16r(bf16r(s[d]) + bf16r(bh[d]));
        const float ls = log_std[d];
        isd[d] = expf(-ls);
        const float a = row < R ? aux[row * (A + 3) + d] : 0.f;
        zd[d] = (a - mean) * isd[d];
        lp += -0.5f * zd[d] * zd[d] - ls - DCC_LOG_SQRT_2PI;
      }
    }
    float loss = 0.f, rv = 0.f, dlp = 0.f;
    if (row < R) {
      const float* ar = aux + row * (A + 3);
      const float old_lp = ar[A], adv = ar[A + 1], valid = ar[A + 2];
      const float ratio = expf(lp - old_lp);
      const float clipped = fminf(fmaxf(ratio, 1.f - clip), 1.f + clip);
      const float s1 = ratio * adv, s2 = clipped * adv;
      loss = -fminf(s1, s2);
      rv = ratio * valid;
      const float w1 = balanced_lt(s1, s2);
      const float dratio =
          -(w1 * adv + (1.f - w1) * adv * clip_grad(ratio, 1.f - clip, 1.f + clip));
      dlp = dratio * ratio;
    }
    met[0] = loss;
    met[1] = rv;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      dout[d] = dlp * zd[d] * isd[d];
      ext[d] = dlp * (zd[d] * zd[d] - 1.f);
    }
  }
};

struct CriticLoss {  // value head, clipped / Huber value loss; aux [vpred, ret_raw, valid]
  static constexpr int NMET = 1;  // value loss
  static constexpr bool EXT = false;
  const float* aux;
  float bv, shift, scale, clip, delta;
  int use_huber, use_clipped;
  int A;

  __device__ void row(long long row, long long R, const float (&s)[4], float (&dout)[4],
                      float (&ext)[4], float (&met)[NMET]) const {
    float loss = 0.f, g = 0.f;
    if (row < R) {
      const float v = bf16r(bf16r(s[0]) + bf16r(bv));
      const float* ar = aux + row * 3;
      const float vpred = ar[0], valid = ar[2];
      const float ret = (ar[1] - shift) / scale;
      const float err = ret - v;
      float dl;
      if (use_clipped) {
        const float dv_raw = v - vpred;
        const float v_clip = vpred + fminf(fmaxf(dv_raw, -clip), clip);
        const float err_c = ret - v_clip;
        const float h1 = huber_fn(err, delta, use_huber);
        const float h2 = huber_fn(err_c, delta, use_huber);
        loss = fmaxf(h1, h2) * valid;
        const float w1 = balanced_lt(h2, h1);
        dl = -(w1 * huber_grad(err, delta, use_huber) +
               (1.f - w1) * huber_grad(err_c, delta, use_huber) *
                   clip_grad(dv_raw, -clip, clip));
      } else {
        loss = huber_fn(err, delta, use_huber) * valid;
        dl = -huber_grad(err, delta, use_huber);
      }
      g = dl * valid;
    }
    met[0] = loss;
#pragma unroll
    for (int d = 0; d < 4; ++d) dout[d] = ext[d] = 0.f;
    dout[0] = g;
  }
};

// Parameters (offs and woffs are device tables). Folded: f32 vectors in pb
// (u_li at offs[3*li+2], the head's weights (H x A) at offs[3L], then its
// other vectors; the V slots may be empty), bf16 V_li (pad16(d_li) x
// pad16(H), zero padded) at wb + woffs[li]. Unfolded: the flat trunk list
// in pb at offs[0 .. 2 + 4L) (fn scale, fn bias, then W (not read), b, LN
// scale, LN bias per layer), the head at offs[2 + 4L], bf16 W_li at wb +
// woffs[li]. aux rows are aux_w floats wide. Slot: folded per layer [dV,
// du] (FoldedSlot), unfolded the trunk list's gradients at its offsets;
// then the head's [dW (H x A), db (A), ext (A, when EXT), metrics (NMET)].
// deep: null (the staged layout) or the depth layout's scratch, gridDim.x x
// deep_scratch_bytes(BR, H, L) bytes (the column-blocked library's:
// blocked_scratch_bytes, never null).
// Chunked (CH; ROADMAP B2's rows too wide to stage whole): layer 0's
// operand streams through a0 in MMA_KC-column chunks (chunked_layer0), each
// normalized from x as it is loaded (unfolded, with the feature norm's
// affine), and the backward leaves layer 0's weight gradient out of the
// slot: it writes each row's bf16 cotangent of layer 0 (R x Hp) to g0 and
// its feature-norm mean and 1/sqrt(var + eps) to xstats (R x 2), from
// which dv0_wgmma_kernel (layer0_tail.cu) computes dV0 = bf16(xhat)^T g0
// (unfolded, dW0 = bf16(xhat * fs + fb)^T g0) and, unfolded,
// layer0_input_bwd_wgmma_kernel (the same file) the feature norm's scale
// and bias gradients. Unfolded
// chunked, the slot starts at layer 0's bias (slot offset = offset in pb -
// offs[3]): the feature norm's and W_0's 4,840-wide gradients are not in
// it. Layer 0's pre-activations are not re-summed (resum_uncertain needs
// the whole operand row); the layers after it are.
template <int BR, bool UNF, class Loss, bool CH = false>
__device__ __forceinline__ void ppo_grads_mma(unsigned char* smem_raw, const void* x,
                                              int x_bf16, const float* aux, int aux_w,
                                              long long R, int d_in, int H, int L, int A,
                                              int use_fn, int relu, const float* pb,
                                              const long long* offs, const bf16* wb,
                                              const long long* woffs, float* slots,
                                              long long slot_size, const Loss& loss,
                                              unsigned char* mask, unsigned char* deep,
                                              bf16* g0 = nullptr, float* xstats = nullptr) {
  const PpoMmaLayout m = ppo_mma_layout(BR, d_in, H, L, A, UNF, CH, deep != nullptr);
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
  float* fnmu = (float*)(smem_raw + m.fmu);
  float* fninv = (float*)(smem_raw + m.finv);
  float* red = (float*)(smem_raw + m.red);
  float* colsum = blk ? ds.colsum : (float*)(smem_raw + m.colsum);
  float* whs = blk ? ds.wh : (float*)(smem_raw + m.wh);
  float* us = (float*)(smem_raw + m.u);
  float* dout = (float*)(smem_raw + m.dout);
  float* ext = (float*)(smem_raw + m.ext);
  float* met = (float*)(smem_raw + m.met);
  float* rnorm = (float*)(smem_raw + m.rnorm);
  const ResumList flags = resum_list(smem_raw + m.flags);
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

  float* slot = slots + (long long)blockIdx.x * slot_size;
  const long long tiles = (R + BR - 1) / BR;
  if (blockIdx.x >= tiles) {  // no rows for this block: its slot holds zeros
    for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
    return;
  }
  // unfolded: gradient k of the flat list at sb + offs[k]
  float* sb = UNF && CH ? slot - offs[3] : slot;
  const FoldedSlot fslot(slot, d_in, H, CH);  // folded: [dV, du] of each layer
  float* head = UNF ? sb + offs[2 + 4 * L] : fslot.head(L);
  float* s_w = head;
  float* s_b = s_w + H * A;
  float* s_e = s_b + A;
  float* s_met = s_e + (Loss::EXT ? A : 0);
  const float* Wh = pb + offs[UNF ? 2 + 4 * L : 3 * L];
  const bf16* feat = act_tile(L - 1);  // the last layer's activation
  const float* lmu = mu_s + (L - 1) * BR;
  const float* linv = inv_s + (L - 1) * BR;
  // unfolded: the last LN's affine (the folded table ends before 4L)
  const float* lscale = UNF ? pb + offs[4 * L] : nullptr;
  const float* lbias = UNF ? pb + offs[4 * L + 1] : nullptr;
  // the trunk output, the head's input: bf16(xhat), unfolded bf16(xhat * s + c)
  auto feat_at = [&](int r, int h) {
    const float a = bf(feat[r * ldh + h]);
    if constexpr (UNF)
      return bf16r(ln_affine(a, lmu[r], linv[r], lscale[h], lbias[h]));
    else
      return bf16r((a - lmu[r]) * linv[r]);
  };
  const WarpTile wt = pass_tile<BR>(Hp, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int WM = MmaTile<BR>::WM;
  float acc[MmaTile<BR>::NT][4];
  for (int i = threadIdx.x; i < H * A; i += blockDim.x) whs[i] = bf16r(Wh[i]);
  if constexpr (UNF) {
    if (threadIdx.x == 0) *flags.n = 0;
    if (relu)  // for relu_uncertain (chunked: the layers after layer 0)
      weight_col_norms(wb, woffs, L, Kp0, Hp, cnorm, CH ? 1 : 0);
  } else if (!deep) {
    for (int i = threadIdx.x; i < L * H; i += blockDim.x)
      us[i] = pb[offs[3 * (i / H) + 2] + i % H];
  }

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    const bool first = tile == blockIdx.x;
    if (threadIdx.x < 2 && tile + gridDim.x < tiles) {
      // the next tile's rows (thread 0) and aux rows (thread 1), into L2
      const long long r1 = row0 + (long long)gridDim.x * BR;
      const long long n = min((long long)BR, R - r1);
      const int esz = threadIdx.x == 0 ? (x_bf16 ? 2 : 4) * d_in : 4 * aux_w;
      const char* p = threadIdx.x == 0 ? (const char*)x : (const char*)aux;
      prefetch_l2_span(p + r1 * esz, n * esz);
    }
    // forward (dcc_tpu/ops/fused_ppo.py::_fwd_chain_folded, or unfolded
    // dcc_tpu/ops/fused_mlp.py::_forward_chain)
    if constexpr (CH)
      input_stats<BR>(x, x_bf16, row0, R, d_in, use_fn, fnmu, fninv);
    else if constexpr (UNF)
      load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, pb + offs[0], pb + offs[1], a0, lda0,
                     fnmu, fninv);
    else
      load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, nullptr, nullptr, a0, lda0);
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const long long* o = offs + 2 + 4 * li;  // unfolded: W, b, LN scale, LN bias
      const bf16* in = li == 0 ? a0 : sx;
      const int lda = li == 0 ? lda0 : ldh, K = li == 0 ? d_in : H;
      const bool resum = UNF && relu && !(CH && li == 0);
      if (resum)  // the operand's row norms, for relu_uncertain
        operand_row_norms<BR>(in, lda, K, rnorm);
      const float* bias = UNF ? pb + o[1] : deep ? pb + offs[3 * li + 2] : us + li * H;
      bf16* a = act_tile(li);
      unsigned char* mrow = mask != nullptr ? mask + ((long long)li * R + row0) * H : nullptr;
      float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (CH && li == 0)
          chunked_layer0<BR, UNF>(x, x_bf16, row0, R, d_in, use_fn, fnmu, fninv,
                                  use_fn ? pb + offs[0] : nullptr,
                                  use_fn ? pb + offs[1] : nullptr, a0, lda0, wb + woffs[0], Hp,
                                  n0, ring, pt, acc);
        else
          gemm_stream<false>(in, lda, li == 0 ? Kp0 : Hp, wb + woffs[li] + n0, Hp,
                             min(MMA_HMAX, Hp - n0), ring, pt, acc, li == 0 ? 0 : ar);
        if (resum)
          resum_uncertain<BR>(acc, in, lda, K, wb + woffs[li], Hp, pb + o[1], H, rnorm,
                              cnorm + li * Hp, row0, R, pt, n0, flags);
        dense_act<BR>(acc, bias, H, n0, relu, pt, s, q);
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
                for (int e = 0; e < 2; ++e) {
                  y[e] = 0.f;
                  if (c + e < H) {
                    if constexpr (UNF)
                      y[e] = ln_affine(acc[nt][2 * h + e], mu[h], inv[h], pb[o[2] + c + e],
                                       pb[o[3] + c + e]);
                    else
                      y[e] = (acc[nt][2 * h + e] - mu[h]) * inv[h];
                  }
                }
                store_bf16x2(sx + r * ldh + c, y[0], y[1]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (!first && threadIdx.x == 0)  // this tile adds into the block's slot: into L2
      prefetch_l2_span((const char*)slot, (long long)(head - slot) * 4);
    // head + loss: warp w takes rows w, w + 8, ..., four at a time; their dot
    // products run together, then lane j finishes the group's row j
    for (int j0 = 0; j0 < BR / MMA_WARPS; j0 += 4) {
      constexpr int RG = BR / MMA_WARPS < 4 ? BR / MMA_WARPS : 4;
      float s[RG][4];
#pragma unroll
      for (int j = 0; j < RG; ++j)
#pragma unroll
        for (int d = 0; d < 4; ++d) s[j][d] = 0.f;
      for (int h = lane; h < H; h += 32) {
#pragma unroll
        for (int j = 0; j < RG; ++j) {
          const float f = feat_at(warp + (j0 + j) * MMA_WARPS, h);
#pragma unroll
          for (int d = 0; d < 4; ++d)
            if (d < A) s[j][d] = fmaf(f, whs[h * A + d], s[j][d]);
        }
      }
      float mine[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < RG; ++j)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float t = d < A ? warp_sum(s[j][d]) : 0.f;
          if (lane == j) mine[d] = t;
        }
      if (lane < RG) {
        const int r = warp + (j0 + lane) * MMA_WARPS;
        float dv[4], ev[4], mv[Loss::NMET];
        loss.row(row0 + r, R, mine, dv, ev, mv);
#pragma unroll
        for (int k = 0; k < Loss::NMET; ++k) met[k * BR + r] = mv[k];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d < A) {
            dout[r * A + d] = dv[d];
            ext[r * A + d] = ev[d];
          }
        }
      }
    }
    __syncthreads();
    // head gradients (fixed row order), each feature once for all A outputs
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < BR; ++r) {
        const float f = feat_at(r, h);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (d < A) s[d] = fmaf(f, bf16r(dout[r * A + d]), s[d]);
      }
      for (int d = 0; d < A; ++d) s_w[h * A + d] = first ? s[d] : s_w[h * A + d] + s[d];
    }
    if (threadIdx.x < A) {
      const int d = threadIdx.x;
      float sb = 0.f, se = 0.f;
      for (int r = 0; r < BR; ++r) {
        sb += dout[r * A + d];
        if (Loss::EXT) se += ext[r * A + d];
      }
      s_b[d] = first ? sb : s_b[d] + sb;
      if (Loss::EXT) s_e[d] = first ? se : s_e[d] + se;
    } else if (threadIdx.x == A) {
      for (int k = 0; k < Loss::NMET; ++k) {
        float sm = 0.f;
        for (int r = 0; r < BR; ++r) sm += met[k * BR + r];
        s_met[k] = first ? sm : s_met[k] + sm;
      }
    }
    // cotangent of the trunk output: g = bf16(dout) @ bf16(W_head)^T, for
    // the pass of columns from n0
    float dm[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int d = 0; d < 4; ++d)
        dm[h][d] = d < A ? bf16r(dout[(wt.r0 + 8 * h) * A + d]) : 0.f;
    auto top_g = [&](int n0, const WarpTile& pt) {
#pragma unroll
      for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + pt.c0 + nt * 8 + (i & 1);
          float g = 0.f;
          if (nt < pt.ntw && col < H) {
#pragma unroll
            for (int d = 0; d < 4; ++d)
              if (d < A) g = fmaf(dm[i >> 1][d], whs[col * A + d], g);
          }
          acc[nt][i] = g;
        }
      }
    };
    if (!multi) top_g(0, wt);
    // backward (dcc_tpu/ops/fused_ppo.py::_trunk_bwd_folded, or unfolded
    // ::_trunk_bwd); with more than one column pass, each layer's cotangent
    // is read pass by pass: the last layer's from the head, the others' from
    // the stage gprev_passes wrote
    for (int li = L - 1; li >= 0; --li) {
      const long long* o = offs + 2 + 4 * li;  // unfolded: W, b, LN scale, LN bias
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
        ln_bwd_sums<BR, UNF>(acc, a, ldh, mu_s + li * BR, inv_s + li * BR, pb + o[2], H, n0, pt,
                             s1, s2);
      }
      ln_bwd_rows<BR>(s1, s2, H, red, wt);
      for (int n0 = 0; n0 < pass_end(Hp); n0 += MMA_HMAX) {
        const WarpTile pt = pass_tile<BR>(Hp, n0);
        if (multi) load_g(n0, pt);
        ln_bwd_apply<BR, UNF>(acc, a, ldh, mu_s + li * BR, inv_s + li * BR, pb + o[2], H, Hp, n0,
                              relu, s1, s2, pt, colsum, gs);
      }
      if (li >= 1 && li + 1 < L) {
        // this layer's operand, the previous layer's LN output, as the
        // forward wrote it (the last layer's is still in sx); more than one
        // pass: after every thread has read the stage, which lies over sx
        if (multi) __syncthreads();
        const bf16* ap = saved(li - 1);
        const float* pm = mu_s + (li - 1) * BR;
        const float* pi = inv_s + (li - 1) * BR;
        for (int i = threadIdx.x; i < BR * Hp; i += blockDim.x) {
          const int r = i / Hp, c = i - r * Hp;
          float y = 0.f;
          if (c < H) {
            if constexpr (UNF)  // the previous layer's LN scale and bias: o[-2], o[-1]
              y = ln_affine(bf(ap[r * ldh + c]), pm[r], pi[r], pb[o[-2] + c], pb[o[-1] + c]);
            else
              y = (bf(ap[r * ldh + c]) - pm[r]) * pi[r];
          }
          sx[r * ldh + c] = __float2bfloat16_rn(y);
        }
      }
      __syncthreads();
      // bias gradients (unfolded: also the LN scale and bias gradients):
      // column sums of the un-rounded cotangents in warp order
      for (int j = threadIdx.x; j < H; j += blockDim.x) {
        if constexpr (UNF) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float s = 0.f;
            for (int w = 0; w < WM; ++w) s += colsum[(k * WM + w) * Hp + j];
            float* dst = sb + o[k == 2 ? 1 : 2 + k] + j;
            *dst = first ? s : *dst + s;
          }
        } else {
          float s = 0.f;
          for (int w = 0; w < WM; ++w) s += colsum[w * Hp + j];
          float* du = fslot.u(li) + j;
          *du = first ? s : *du + s;
        }
      }
      if (CH && li == 0) {
        // layer 0's bf16 cotangent and the rows' statistics, for dv0_wgmma_kernel
        const int cpr = Hp / 8;  // 16-byte chunks of a row
        for (int i = threadIdx.x; i < BR * cpr; i += blockDim.x) {
          const int r = i / cpr, c = i - r * cpr;
          if (row0 + r < R)
            *reinterpret_cast<uint4*>(g0 + (row0 + r) * Hp + c * 8) =
                *reinterpret_cast<const uint4*>(gs + r * ldh + c * 8);
        }
        if (threadIdx.x < BR && row0 + threadIdx.x < R) {
          xstats[2 * (row0 + threadIdx.x)] = fnmu[threadIdx.x];
          xstats[2 * (row0 + threadIdx.x) + 1] = fninv[threadIdx.x];
        }
      } else {
        dw(li == 0 ? a0 : sx, li == 0 ? lda0 : ldh, li == 0 ? Kp0 : Hp, li == 0 ? d_in : H,
           UNF ? sb + o[0] : fslot.v(li), first);
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
    if (UNF && !CH && use_fn) {
      // the feature norm's scale and bias gradients from layer 0's g_prev
      gprev_passes<BR>(gs, ldh, Hp, wb + woffs[0], Kp0, ring, stage, ldf, ar);
      __syncthreads();
      fn_affine_grads<BR>(stage, ldf, x, x_bf16, row0, R, d_in, fnmu, fninv, slot + offs[0],
                          slot + offs[1], first);
    }
    __syncthreads();  // the next tile's forward writes over a0 (and the stage)
  }
}

// K3 / K3u in bf16. Head: Wh (H x A), bh, log_std at offs[h], offs[h + 1],
// offs[h + 2]: h = 3L folded, 2 + 4L unfolded. CH: the chunked layer 0, as
// for K4 / K4u (its head's A columns follow the slot's trunk part, which
// starts after layer 0's dV, unfolded at layer 0's bias).
template <int BR, bool UNF, bool CH = false>
__device__ __forceinline__ void actor_mma(unsigned char* smem_raw, const void* x, int x_bf16,
                                          const float* aux, long long R, int d_in, int H,
                                          int L, int A, int use_fn, int relu, float clip,
                                          const float* pb, const long long* offs,
                                          const bf16* wb, const long long* woffs, float* slots,
                                          long long slot_size, unsigned char* mask,
                                          unsigned char* deep, bf16* g0 = nullptr,
                                          float* xstats = nullptr) {
  const int h = UNF ? 2 + 4 * L : 3 * L;
  const ActorLoss loss{aux, pb + offs[h + 1], pb + offs[h + 2], clip, A};
  ppo_grads_mma<BR, UNF, ActorLoss, CH>(smem_raw, x, x_bf16, aux, A + 3, R, d_in, H, L, A,
                                        use_fn, relu, pb, offs, wb, woffs, slots, slot_size,
                                        loss, mask, deep, g0, xstats);
}

// K4 / K4u in bf16. Head: wv (H), bv at offs[h], offs[h + 1]; norm = [shift,
// scale] of the value normalizer, applied to the raw returns in the kernel.
template <int BR, bool UNF, bool CH = false>
__device__ __forceinline__ void critic_mma(unsigned char* smem_raw, const void* x, int x_bf16,
                                           const float* aux, const float* norm, long long R,
                                           int d_in, int H, int L, int use_fn, int relu,
                                           float clip, float delta, int use_huber,
                                           int use_clipped, const float* pb,
                                           const long long* offs, const bf16* wb,
                                           const long long* woffs, float* slots,
                                           long long slot_size, unsigned char* mask,
                                           unsigned char* deep, bf16* g0 = nullptr,
                                           float* xstats = nullptr) {
  const int h = UNF ? 2 + 4 * L : 3 * L;
  const CriticLoss loss{aux, pb[offs[h + 1]], norm[0], norm[1], clip, delta,
                        use_huber, use_clipped, 1};
  ppo_grads_mma<BR, UNF, CriticLoss, CH>(smem_raw, x, x_bf16, aux, 3, R, d_in, H, L, 1, use_fn,
                                         relu, pb, offs, wb, woffs, slots, slot_size, loss, mask,
                                         deep, g0, xstats);
}

#define DCC_ACTOR_MMA_PARAMS                                                                \
  const void *x, int x_bf16, const float *aux, long long R, int d_in, int H, int L, int A,  \
      int use_fn, int relu, float clip, const float *pb, const long long *offs,             \
      const bf16 *wb, const long long *woffs, float *slots, long long slot_size,            \
      unsigned char *mask, unsigned char *deep
#define DCC_CRITIC_MMA_PARAMS                                                               \
  const void *x, int x_bf16, const float *aux, const float *norm, long long R, int d_in,    \
      int H, int L, int use_fn, int relu, float clip, float delta, int use_huber,           \
      int use_clipped, const float *pb, const long long *offs, const bf16 *wb,              \
      const long long *woffs, float *slots, long long slot_size, unsigned char *mask,       \
      unsigned char *deep

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1) actor_grads_mma_kernel(DCC_ACTOR_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  actor_mma<BR, false>(smem_raw, x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,
                       offs, wb, woffs, slots, slot_size, mask, deep);
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    actor_grads_unfolded_mma_kernel(DCC_ACTOR_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  actor_mma<BR, true>(smem_raw, x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,
                      offs, wb, woffs, slots, slot_size, mask, deep);
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    critic_grads_mma_kernel(DCC_CRITIC_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  critic_mma<BR, false>(smem_raw, x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,
                        delta, use_huber, use_clipped, pb, offs, wb, woffs, slots, slot_size,
                        mask, deep);
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    critic_grads_unfolded_mma_kernel(DCC_CRITIC_MMA_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  critic_mma<BR, true>(smem_raw, x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,
                       delta, use_huber, use_clipped, pb, offs, wb, woffs, slots, slot_size,
                       mask, deep);
}

// K4 with the chunked layer 0 (ppo_grads_mma's CH): rows too wide for a
// staged tile, e.g. the 20-UAV preset's 4,840-wide team-concat rows.
template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    critic_grads_chunked_mma_kernel(DCC_CRITIC_MMA_PARAMS, bf16* g0, float* xstats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  critic_mma<BR, false, true>(smem_raw, x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,
                              delta, use_huber, use_clipped, pb, offs, wb, woffs, slots,
                              slot_size, mask, deep, g0, xstats);
}

// K4u with the chunked layer 0: the same rows; its feature norm's scale and
// bias gradients come from layer0_input_bwd_mma_kernel, dW0 from the dV0
// kernel in its affine mode.
template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    critic_grads_unfolded_chunked_mma_kernel(DCC_CRITIC_MMA_PARAMS, bf16* g0, float* xstats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  critic_mma<BR, true, true>(smem_raw, x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,
                             delta, use_huber, use_clipped, pb, offs, wb, woffs, slots,
                             slot_size, mask, deep, g0, xstats);
}

// K3 and K3u with the chunked layer 0: actor rows too wide for a staged
// tile (more than 1,472 columns folded, 1,088 unfolded; e.g. 4 UAVs x 300
// PoIs, 1,510). dW0 / dV0 then comes from the dV0 kernel, and K3u's
// feature-norm gradients from layer0_input_bwd_mma_kernel, as for K4 / K4u.
template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    actor_grads_chunked_mma_kernel(DCC_ACTOR_MMA_PARAMS, bf16* g0, float* xstats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  actor_mma<BR, false, true>(smem_raw, x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,
                             offs, wb, woffs, slots, slot_size, mask, deep, g0, xstats);
}

template <int BR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    actor_grads_unfolded_chunked_mma_kernel(DCC_ACTOR_MMA_PARAMS, bf16* g0, float* xstats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  actor_mma<BR, true, true>(smem_raw, x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,
                            offs, wb, woffs, slots, slot_size, mask, deep, g0, xstats);
}

// Each launcher sets its kernel's shared-memory limit once, launches, and
// returns cudaGetLastError().
template <int BR, bool UNF>
static int launch_actor(const void* x, int x_bf16, const float* aux, long long R,
                        int d_in, int H, int L, int A, int use_fn, int relu,
                        float clip, const float* pb, const long long* o, float* slots,
                        long long slot_size, int n_blocks, cudaStream_t s) {
  static bool smem_set = false;
  auto k = actor_grads_kernel<BR, UNF>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = sizeof(float) * (UNF ? ppo_unfolded_smem_floats(BR, d_in, H, L, A)
                                           : ppo_smem_floats(BR, d_in, H, L, A));
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, aux, R, d_in, H, L, A, use_fn,
                                        relu, clip, pb, o, slots, slot_size);
  return (int)cudaGetLastError();
}

// The bf16 actor kernel of a chain (UNF) and layout (CH).
template <int BR, bool UNF, bool CH>
static void actor_mma_kernel(const void* x, int x_bf16, const float* aux, long long R,
                             int d_in, int H, int L, int A, int use_fn, int relu, float clip,
                             const float* pb, const long long* o, const bf16* wb,
                             const long long* wo, float* slots, long long slot_size,
                             int n_blocks, bf16* g0, float* xstats, unsigned char* mask,
                             unsigned char* deep, cudaStream_t s) {
  static bool smem_set = false;
  const size_t smem = ppo_mma_layout(BR, d_in, H, L, A, UNF, CH, deep != nullptr).total;
  if constexpr (CH) {
    auto k = UNF ? actor_grads_unfolded_chunked_mma_kernel<BR> : actor_grads_chunked_mma_kernel<BR>;
    if (!smem_set) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
      smem_set = true;
    }
    k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip,
                                          pb, o, wb, wo, slots, slot_size, mask, deep, g0,
                                          xstats);
  } else {
    auto k = UNF ? actor_grads_unfolded_mma_kernel<BR> : actor_grads_mma_kernel<BR>;
    if (!smem_set) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
      smem_set = true;
    }
    k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip,
                                          pb, o, wb, wo, slots, slot_size, mask, deep);
  }
}

template <int BR, bool UNF>
static int launch_critic(const void* x, int x_bf16, const float* aux,
                         const float* norm, long long R, int d_in, int H, int L,
                         int use_fn, int relu, float clip, float delta,
                         int use_huber, int use_clipped, const float* pb,
                         const long long* o, float* slots, long long slot_size,
                         int n_blocks, cudaStream_t s) {
  static bool smem_set = false;
  auto k = critic_grads_kernel<BR, UNF>;
  if (!smem_set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
    smem_set = true;
  }
  const size_t smem = sizeof(float) * (UNF ? ppo_unfolded_smem_floats(BR, d_in, H, L, 1)
                                           : ppo_smem_floats(BR, d_in, H, L, 1));
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn,
                                        relu, clip, delta, use_huber, use_clipped,
                                        pb, o, slots, slot_size);
  return (int)cudaGetLastError();
}

// The bf16 critic kernel of a chain (UNF) and layout (CH).
template <int BR, bool UNF, bool CH>
static void critic_mma_kernel(const void* x, int x_bf16, const float* aux, const float* norm,
                              long long R, int d_in, int H, int L, int use_fn, int relu,
                              float clip, float delta, int use_huber, int use_clipped,
                              const float* pb, const long long* o, const bf16* wb,
                              const long long* wo, float* slots, long long slot_size,
                              int n_blocks, bf16* g0, float* xstats, unsigned char* mask,
                              unsigned char* deep, cudaStream_t s) {
  static bool smem_set = false;
  const size_t smem = ppo_mma_layout(BR, d_in, H, L, 1, UNF, CH, deep != nullptr).total;
  if constexpr (CH) {
    auto k = UNF ? critic_grads_unfolded_chunked_mma_kernel<BR>
                 : critic_grads_chunked_mma_kernel<BR>;
    if (!smem_set) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
      smem_set = true;
    }
    k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu,
                                          clip, delta, use_huber, use_clipped, pb, o, wb, wo,
                                          slots, slot_size, mask, deep, g0, xstats);
  } else {
    auto k = UNF ? critic_grads_unfolded_mma_kernel<BR> : critic_grads_mma_kernel<BR>;
    if (!smem_set) {
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_MAX);
      smem_set = true;
    }
    k<<<n_blocks, MMA_THREADS, smem, s>>>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu,
                                          clip, delta, use_huber, use_clipped, pb, o, wb, wo,
                                          slots, slot_size, mask, deep);
  }
}

extern "C" unsigned long long dcc_ppo_smem_bytes(int br, int d_in, int H, int L,
                                                 int A) {
  return sizeof(float) * ppo_smem_floats(br, d_in, H, L, A);
}

extern "C" unsigned long long dcc_ppo_mma_smem_bytes(int br, int d_in, int H, int L, int A,
                                                     int deep) {
  return ppo_mma_layout(br, d_in, H, L, A, false, false, deep).total;
}

extern "C" unsigned long long dcc_ppo_mma_chunked_smem_bytes(int br, int d_in, int H, int L,
                                                             int A, int deep) {
  return ppo_mma_layout(br, d_in, H, L, A, false, true, deep).total;
}

extern "C" unsigned long long dcc_ppo_unfolded_smem_bytes(int br, int d_in, int H, int L,
                                                          int A) {
  return sizeof(float) * ppo_unfolded_smem_floats(br, d_in, H, L, A);
}

extern "C" unsigned long long dcc_ppo_unfolded_mma_smem_bytes(int br, int d_in, int H, int L,
                                                              int A, int deep) {
  return ppo_mma_layout(br, d_in, H, L, A, true, false, deep).total;
}

extern "C" unsigned long long dcc_ppo_unfolded_mma_chunked_smem_bytes(int br, int d_in, int H,
                                                                      int L, int A, int deep) {
  return ppo_mma_layout(br, d_in, H, L, A, true, true, deep).total;
}

// The checks of the offsets tables (device arrays of n_offs entries).
// Folded: per layer [V, V^T, u], then the head's n_head vectors. Unfolded:
// the flat trunk list's offsets (fn scale, fn bias, then W, b, LN scale, LN
// bias per layer) come first, then (f32) each W^T, then the head's n_head
// vectors. The tensor-core kernels' woffs holds one entry a layer.
static bool offs_ok(int n_offs, int L, bool unf, bool mma, int n_head) {
  return L >= 1 && n_offs == (unf ? 2 + (mma ? 4 : 5) * L : 3 * L) + n_head;
}

// The f32 (FMA) loss kernels, K3 / K4 (UNF false) and K3u / K4u: slots is
// n_blocks x slot_size scratch, out receives slot_size floats. Actor br in
// {32, 8, 1} folded, {32, 16, 8, 1} unfolded.
template <bool UNF>
static int actor_grads_f32(const void* x, int x_bf16, const float* aux, long long R, int d_in,
                           int H, int L, int A, int use_fn, int relu, float clip, int br,
                           const float* pb, const long long* offs, int n_offs, float* slots,
                           long long slot_size, int n_blocks, float* out, void* stream) {
  if (A > 4 || n_blocks < 1 || !offs_ok(n_offs, L, UNF, false, 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
#define DCC_CASE(B)                                                                          \
  case B:                                                                                    \
    err = launch_actor<B, UNF>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,     \
                               offs, slots, slot_size, n_blocks, s);                         \
    break;
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(8)
    DCC_CASE(1)
    case 16:  // the unfolded kernel's only
      if constexpr (!UNF) return (int)cudaErrorInvalidValue;
      else err = launch_actor<16, true>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip,
                                        pb, offs, slots, slot_size, n_blocks, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" int dcc_actor_grads(const void* x, int x_bf16, const float* aux,
                               long long R, int d_in, int H, int L, int A,
                               int use_fn, int relu, float clip,
                               int br, const float* pb, const long long* offs,
                               int n_offs, float* slots, long long slot_size,
                               int n_blocks, float* out, void* stream) {
  return actor_grads_f32<false>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br, pb,
                                offs, n_offs, slots, slot_size, n_blocks, out, stream);
}

extern "C" int dcc_actor_grads_unfolded(const void* x, int x_bf16, const float* aux,
                                        long long R, int d_in, int H, int L, int A, int use_fn,
                                        int relu, float clip, int br, const float* pb,
                                        const long long* offs, int n_offs, float* slots,
                                        long long slot_size, int n_blocks, float* out,
                                        void* stream) {
  return actor_grads_f32<true>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br, pb,
                               offs, n_offs, slots, slot_size, n_blocks, out, stream);
}

// The bf16 actor on the tensor cores, K3 (UNF false) or K3u, staged (CH
// false: br in {64, 32, 16}, 16 where no larger tile fits, ops.tiles) or
// with the chunked layer 0 (br in {32, 16}; slots and out then hold the
// slot without layer 0's dV, unfolded from layer 0's bias on, every offset
// less offs[3], and the kernel writes g0 (R x pad16(H) bf16) and xstats (R
// x 2 f32) for dcc_dv0_wgmma and, unfolded, dcc_layer0_input_bwd_wgmma);
// any H whose tile fits (dcc_ppo_*mma*_smem_bytes); mask null or the relu
// masks' debug output (L x R x H bytes); deep null (the staged layout) or
// the depth layout's scratch, n_blocks x dcc_deep_scratch_bytes (the blocked
// library: n_blocks x dcc_blocked_scratch_bytes, required).
template <bool UNF, bool CH>
static int actor_grads_mma(const void* x, int x_bf16, const float* aux, long long R, int d_in,
                           int H, int L, int A, int use_fn, int relu, float clip, int br,
                           const float* pb, const long long* offs, int n_offs, const void* wb,
                           const long long* woffs, int n_woffs, float* slots,
                           long long slot_size, int n_blocks, void* g0, float* xstats,
                           float* out, void* mask, void* deep, void* stream) {
  if (A > 4 || n_blocks < 1 || !mma_width_ok(H) || n_woffs != L ||
      !offs_ok(n_offs, L, UNF, true, 3) || (DCC_BLOCKED && deep == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* w = (const bf16*)wb;
  unsigned char* m = (unsigned char*)mask;
  unsigned char* dp = (unsigned char*)deep;
#define DCC_CASE(B)                                                                            \
  case B:                                                                                      \
    actor_mma_kernel<B, UNF, CH>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,     \
                                 offs, w, woffs, slots, slot_size, n_blocks, (bf16*)g0, xstats, \
                                 m, dp, s);                                                    \
    break;
  switch (br) {
    case 64:
      if (CH) return (int)cudaErrorInvalidValue;
      actor_mma_kernel<64, UNF, false>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, pb,
                                       offs, w, woffs, slots, slot_size, n_blocks, nullptr,
                                       nullptr, m, dp, s);
      break;
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" int dcc_actor_grads_mma(const void* x, int x_bf16, const float* aux, long long R,
                                   int d_in, int H, int L, int A, int use_fn, int relu,
                                   float clip, int br, const float* pb, const long long* offs,
                                   int n_offs, const void* wb, const long long* woffs,
                                   int n_woffs, float* slots, long long slot_size,
                                   int n_blocks, float* out, void* mask, void* deep,
                                   void* stream) {
  return actor_grads_mma<false, false>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br,
                                       pb, offs, n_offs, wb, woffs, n_woffs, slots, slot_size,
                                       n_blocks, nullptr, nullptr, out, mask, deep, stream);
}

extern "C" int dcc_actor_grads_unfolded_mma(const void* x, int x_bf16, const float* aux,
                                            long long R, int d_in, int H, int L, int A,
                                            int use_fn, int relu, float clip, int br,
                                            const float* pb, const long long* offs, int n_offs,
                                            const void* wb, const long long* woffs,
                                            int n_woffs, float* slots, long long slot_size,
                                            int n_blocks, float* out, void* mask, void* deep,
                                            void* stream) {
  return actor_grads_mma<true, false>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br,
                                      pb, offs, n_offs, wb, woffs, n_woffs, slots, slot_size,
                                      n_blocks, nullptr, nullptr, out, mask, deep, stream);
}

extern "C" int dcc_actor_grads_chunked_mma(const void* x, int x_bf16, const float* aux,
                                           long long R, int d_in, int H, int L, int A,
                                           int use_fn, int relu, float clip, int br,
                                           const float* pb, const long long* offs, int n_offs,
                                           const void* wb, const long long* woffs, int n_woffs,
                                           float* slots, long long slot_size, int n_blocks,
                                           void* g0, float* xstats, float* out, void* mask,
                                           void* deep, void* stream) {
  return actor_grads_mma<false, true>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br,
                                      pb, offs, n_offs, wb, woffs, n_woffs, slots, slot_size,
                                      n_blocks, g0, xstats, out, mask, deep, stream);
}

extern "C" int dcc_actor_grads_unfolded_chunked_mma(
    const void* x, int x_bf16, const float* aux, long long R, int d_in, int H, int L, int A,
    int use_fn, int relu, float clip, int br, const float* pb, const long long* offs,
    int n_offs, const void* wb, const long long* woffs, int n_woffs, float* slots,
    long long slot_size, int n_blocks, void* g0, float* xstats, float* out, void* mask,
    void* deep, void* stream) {
  return actor_grads_mma<true, true>(x, x_bf16, aux, R, d_in, H, L, A, use_fn, relu, clip, br,
                                     pb, offs, n_offs, wb, woffs, n_woffs, slots, slot_size,
                                     n_blocks, g0, xstats, out, mask, deep, stream);
}

// The f32 critic (FMA), K4 or K4u; norm = [shift, scale] on the device. br
// in {32, 8, 1} folded, {32, 16, 8, 1} unfolded.
template <bool UNF>
static int critic_grads_f32(const void* x, int x_bf16, const float* aux, const float* norm,
                            long long R, int d_in, int H, int L, int use_fn, int relu,
                            float clip, float delta, int use_huber, int use_clipped, int br,
                            const float* pb, const long long* offs, int n_offs, float* slots,
                            long long slot_size, int n_blocks, float* out, void* stream) {
  if (n_blocks < 1 || !offs_ok(n_offs, L, UNF, false, 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
#define DCC_CASE(B)                                                                       \
  case B:                                                                                 \
    err = launch_critic<B, UNF>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,  \
                                delta, use_huber, use_clipped, pb, offs, slots, slot_size, \
                                n_blocks, s);                                             \
    break;
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(8)
    DCC_CASE(1)
    case 16:  // the unfolded kernel's only
      if constexpr (!UNF) return (int)cudaErrorInvalidValue;
      else err = launch_critic<16, true>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu,
                                         clip, delta, use_huber, use_clipped, pb, offs, slots,
                                         slot_size, n_blocks, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" int dcc_critic_grads(const void* x, int x_bf16, const float* aux,
                                const float* norm, long long R, int d_in, int H,
                                int L, int use_fn, int relu, float clip,
                                float delta, int use_huber, int use_clipped,
                                int br, const float* pb, const long long* offs,
                                int n_offs, float* slots, long long slot_size,
                                int n_blocks, float* out, void* stream) {
  return critic_grads_f32<false>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip, delta,
                                 use_huber, use_clipped, br, pb, offs, n_offs, slots, slot_size,
                                 n_blocks, out, stream);
}

extern "C" int dcc_critic_grads_unfolded(const void* x, int x_bf16, const float* aux,
                                         const float* norm, long long R, int d_in, int H,
                                         int L, int use_fn, int relu, float clip, float delta,
                                         int use_huber, int use_clipped, int br,
                                         const float* pb, const long long* offs, int n_offs,
                                         float* slots, long long slot_size, int n_blocks,
                                         float* out, void* stream) {
  return critic_grads_f32<true>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip, delta,
                                use_huber, use_clipped, br, pb, offs, n_offs, slots, slot_size,
                                n_blocks, out, stream);
}

// The bf16 critic on the tensor cores, K4 (UNF false) or K4u, staged or
// with the chunked layer 0 (CH), br in {32, 16}; as actor_grads_mma.
template <bool UNF, bool CH>
static int critic_grads_mma(const void* x, int x_bf16, const float* aux, const float* norm,
                            long long R, int d_in, int H, int L, int use_fn, int relu,
                            float clip, float delta, int use_huber, int use_clipped, int br,
                            const float* pb, const long long* offs, int n_offs, const void* wb,
                            const long long* woffs, int n_woffs, float* slots,
                            long long slot_size, int n_blocks, void* g0, float* xstats,
                            float* out, void* mask, void* deep, void* stream) {
  if (n_blocks < 1 || !mma_width_ok(H) || n_woffs != L || !offs_ok(n_offs, L, UNF, true, 2) ||
      (DCC_BLOCKED && deep == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* w = (const bf16*)wb;
  unsigned char* m = (unsigned char*)mask;
  unsigned char* dp = (unsigned char*)deep;
#define DCC_CASE(B)                                                                          \
  case B:                                                                                    \
    critic_mma_kernel<B, UNF, CH>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip,   \
                                  delta, use_huber, use_clipped, pb, offs, w, woffs, slots,  \
                                  slot_size, n_blocks, (bf16*)g0, xstats, m, dp, s);         \
    break;
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

#define DCC_CRITIC_ENTRY_PARAMS                                                               \
  const void *x, int x_bf16, const float *aux, const float *norm, long long R, int d_in,     \
      int H, int L, int use_fn, int relu, float clip, float delta, int use_huber,            \
      int use_clipped, int br, const float *pb, const long long *offs, int n_offs,           \
      const void *wb, const long long *woffs, int n_woffs, float *slots, long long slot_size, \
      int n_blocks
#define DCC_CRITIC_ENTRY_ARGS                                                                  \
  x, x_bf16, aux, norm, R, d_in, H, L, use_fn, relu, clip, delta, use_huber, use_clipped, br, \
      pb, offs, n_offs, wb, woffs, n_woffs, slots, slot_size, n_blocks

extern "C" int dcc_critic_grads_mma(DCC_CRITIC_ENTRY_PARAMS, float* out, void* mask, void* deep,
                                    void* stream) {
  return critic_grads_mma<false, false>(DCC_CRITIC_ENTRY_ARGS, nullptr, nullptr, out, mask,
                                        deep, stream);
}

extern "C" int dcc_critic_grads_unfolded_mma(DCC_CRITIC_ENTRY_PARAMS, float* out, void* mask,
                                             void* deep, void* stream) {
  return critic_grads_mma<true, false>(DCC_CRITIC_ENTRY_ARGS, nullptr, nullptr, out, mask,
                                       deep, stream);
}

extern "C" int dcc_critic_grads_chunked_mma(DCC_CRITIC_ENTRY_PARAMS, void* g0, float* xstats,
                                            float* out, void* mask, void* deep, void* stream) {
  return critic_grads_mma<false, true>(DCC_CRITIC_ENTRY_ARGS, g0, xstats, out, mask, deep,
                                       stream);
}

extern "C" int dcc_critic_grads_unfolded_chunked_mma(DCC_CRITIC_ENTRY_PARAMS, void* g0,
                                                     float* xstats, float* out, void* mask,
                                                     void* deep, void* stream) {
  return critic_grads_mma<true, true>(DCC_CRITIC_ENTRY_ARGS, g0, xstats, out, mask, deep,
                                      stream);
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
