// K3 / K4: fused PPO loss + parameter-gradient kernels for the actor and the
// critic, on the folded trunk (every LN affine absorbed into the next
// matmul, dcc_tpu/ops/fused_ppo.py::fold_trunk).
//
// Replace the Pallas kernels dcc_tpu/ops/fused_ppo.py::_actor_kernel
// (actor_ppo_grads_packed -> _make_actor_op) and ::_critic_kernel
// (critic_value_grads_packed -> _make_critic_op). Every PPO epoch runs each
// once over all T*E*A actor rows / T*E critic rows.
//
// What bounds them on an H100: per row, the forward and the backward do
// ~3 * 2 * (d_in * H + H * H) operations against d_in * (2 or 4) bytes of
// input, so the work is compute-bound. This first version runs every product
// on the CUDA cores in FP32 FMA, so the 67 TFLOP/s FP32 rate bounds it, and
// it also re-reads and re-writes each block's gradient slot once per tile.
//
// Design. The Pallas kernels accumulate the weight gradients into one output
// block across a sequential grid, which is race-free only on a TPU. Here a
// fixed grid of one block per SM (the forward cache of a 32-row tile takes
// most of an SM's shared memory) loops over row tiles; each block
// keeps the tile's forward cache (input, activations, LN outputs and
// 1/sigma per layer) in shared memory, runs the loss head and the full
// folded backward on it, and adds the tile's gradients into its OWN slot of
// a scratch buffer (each slot element has one owner thread). A second small
// kernel sums the slots in a fixed order. The result is deterministic and
// uses no atomics. The ragged last tile is masked in the kernel, so rows are
// never padded. Loss and backward elementwise math is f32 with JAX's
// autodiff tie rules: min / max split the cotangent 50/50 on ties, clip
// composes the two.
#include "trunk.cuh"

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

// Shared-memory layout of one block: the trunk cache plus per-row head
// values (2 * A + 2 floats a row).
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

// Gradient slot layout (floats): per layer [dV (d_li x H), du (H)], then
// head [dW (H x A), db (A)], then per-kind extras (actor: dlog_std (A) and
// [loss_sum, ratio_sum]; critic: [value_loss_sum]).
__device__ void slot_ptrs(float* slot, int d_in, int H, int L, int A,
                          float** sv, float** su, float** head) {
  long long o = 0;
  for (int li = 0; li < L; ++li) {
    sv[li] = slot + o;
    o += (long long)(li == 0 ? d_in : H) * H;
    su[li] = slot + o;
    o += H;
  }
  *head = slot + o;
}

// ---------------------------------------------------------------------------
// K3: actor. aux rows: [action (A), old_log_prob, advantage, valid].
// Parameter offsets: trunk as trunk_fwd_folded, then Wh (H x A) at v[3L],
// bh at v[3L+1], log_std at v[3L+2].
// ---------------------------------------------------------------------------
template <int BR, bool BF16>
__global__ void __launch_bounds__(DCC_THREADS)
    actor_grads_kernel(const void* x, int x_bf16, const float* aux, long long R,
                       int d_in, int H, int L, int A, int use_fn, int relu,
                       float clip, const float* pb, DccOffs offs, float* slots,
                       long long slot_size) {
  extern __shared__ float smem[];
  TrunkCache c = carve<BR>(smem, d_in, H, L);
  float* dmean = c.inv + BR * L;  // BR x A
  float* row_dls = dmean + BR * A; // BR x A
  float* row_loss = row_dls + BR * A;
  float* row_ratio = row_loss + BR;

  float* slot = slots + (long long)blockIdx.x * slot_size;
  for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
  float* sv[DCC_MAX_LAYERS];
  float* su[DCC_MAX_LAYERS];
  float* head;
  slot_ptrs(slot, d_in, H, L, A, sv, su, &head);
  float* s_wh = head;
  float* s_bh = s_wh + H * A;
  float* s_ls = s_bh + A;
  float* s_met = s_ls + A;
  const float* Wh = pb + offs.v[3 * L];
  const float* bh = pb + offs.v[3 * L + 1];
  const float* log_std = pb + offs.v[3 * L + 2];
  const float* feat = c.xhat + (long long)(L - 1) * BR * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    trunk_fwd_folded<BR, BF16>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb,
                               offs, c);
    // head + loss, one warp per row
    for (int r = warp; r < BR; r += nw) {
      const long long row = row0 + r;
      float lp = 0.f;
      float zd[4];
      float isd[4];
      for (int d = 0; d < A; ++d) {
        float s = 0.f;
        for (int h = lane; h < H; h += 32)
          s = fmaf(rnd<BF16>(feat[r * H + h]), rnd<BF16>(Wh[h * A + d]), s);
        s = warp_sum(s);
        const float mean = BF16 ? bf16r(bf16r(s) + bf16r(bh[d])) : s + bh[d];
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
        s = fmaf(rnd<BF16>(feat[r * H + h]), rnd<BF16>(dmean[r * A + d]), s);
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
        s = fmaf(rnd<BF16>(dmean[r * A + d]), rnd<BF16>(Wh[h * A + d]), s);
      c.g[i] = s;
    }
    __syncthreads();
    trunk_bwd_folded<BR, BF16>(d_in, H, L, relu, pb, offs, c, sv, su);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4: critic. aux rows: [vpred, ret_raw, valid]; norm = [shift, scale]
// applies the value normalizer in-kernel: target = (ret_raw - shift) / scale.
// Parameter offsets: trunk, then wv (H) at v[3L], bv at v[3L+1].
// ---------------------------------------------------------------------------
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

template <int BR, bool BF16>
__global__ void __launch_bounds__(DCC_THREADS)
    critic_grads_kernel(const void* x, int x_bf16, const float* aux,
                        const float* norm, long long R, int d_in, int H, int L,
                        int use_fn, int relu, float clip, float delta,
                        int use_huber, int use_clipped, const float* pb,
                        DccOffs offs, float* slots, long long slot_size) {
  extern __shared__ float smem[];
  TrunkCache c = carve<BR>(smem, d_in, H, L);
  float* dv = c.inv + BR * L;  // BR
  float* row_loss = dv + BR;

  float* slot = slots + (long long)blockIdx.x * slot_size;
  for (long long i = threadIdx.x; i < slot_size; i += blockDim.x) slot[i] = 0.f;
  float* sv[DCC_MAX_LAYERS];
  float* su[DCC_MAX_LAYERS];
  float* head;
  slot_ptrs(slot, d_in, H, L, 1, sv, su, &head);
  float* s_wv = head;
  float* s_bv = s_wv + H;
  float* s_met = s_bv + 1;
  const float* wv = pb + offs.v[3 * L];
  const float bv = pb[offs.v[3 * L + 1]];
  const float shift = norm[0], scale = norm[1];
  const float* feat = c.xhat + (long long)(L - 1) * BR * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();

  const long long tiles = (R + BR - 1) / BR;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * BR;
    trunk_fwd_folded<BR, BF16>(x, x_bf16, row0, R, d_in, H, L, use_fn, relu, pb,
                               offs, c);
    for (int r = warp; r < BR; r += nw) {
      const long long row = row0 + r;
      float s = 0.f;
      for (int h = lane; h < H; h += 32)
        s = fmaf(rnd<BF16>(feat[r * H + h]), rnd<BF16>(wv[h]), s);
      s = warp_sum(s);
      if (lane == 0) {
        float loss = 0.f, g = 0.f;
        if (row < R) {
          const float v = BF16 ? bf16r(bf16r(s) + bf16r(bv)) : s + bv;
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
      for (int r = 0; r < BR; ++r) s = fmaf(rnd<BF16>(feat[r * H + h]), rnd<BF16>(dv[r]), s);
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
      c.g[i] = rnd<BF16>(dv[r]) * rnd<BF16>(wv[h]);
    }
    __syncthreads();
    trunk_bwd_folded<BR, BF16>(d_in, H, L, relu, pb, offs, c, sv, su);
    __syncthreads();
  }
}

// out[e] = sum over blocks b (in order) of slots[b][e].
__global__ void reduce_slots_kernel(const float* slots, int n_slots,
                                    long long slot_size, float* out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= slot_size) return;
  float s = 0.f;
  for (int b = 0; b < n_slots; ++b) s += slots[(long long)b * slot_size + e];
  out[e] = s;
}

static DccOffs to_offs(const long long* offs, int n_offs) {
  DccOffs o;
  for (int i = 0; i < DCC_MAX_OFFS; ++i) o.v[i] = i < n_offs ? offs[i] : 0;
  return o;
}

static int reduce(const float* slots, int n_blocks, long long slot_size, float* out,
                  cudaStream_t s) {
  const unsigned grid = (unsigned)((slot_size + 255) / 256);
  reduce_slots_kernel<<<grid, 256, 0, s>>>(slots, n_blocks, slot_size, out);
  return (int)cudaGetLastError();
}

template <int BR, bool BF16>
static int launch_actor(const void* x, int x_bf16, const float* aux, long long R,
                        int d_in, int H, int L, int A, int use_fn, int relu,
                        float clip, const float* pb, DccOffs o, float* slots,
                        long long slot_size, int n_blocks, cudaStream_t s) {
  const size_t smem = sizeof(float) * ppo_smem_floats(BR, d_in, H, L, A);
  auto k = actor_grads_kernel<BR, BF16>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, aux, R, d_in, H, L, A, use_fn,
                                        relu, clip, pb, o, slots, slot_size);
  return (int)cudaGetLastError();
}

template <int BR, bool BF16>
static int launch_critic(const void* x, int x_bf16, const float* aux,
                         const float* norm, long long R, int d_in, int H, int L,
                         int use_fn, int relu, float clip, float delta,
                         int use_huber, int use_clipped, const float* pb,
                         DccOffs o, float* slots, long long slot_size,
                         int n_blocks, cudaStream_t s) {
  const size_t smem = sizeof(float) * ppo_smem_floats(BR, d_in, H, L, 1);
  auto k = critic_grads_kernel<BR, BF16>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k<<<n_blocks, DCC_THREADS, smem, s>>>(x, x_bf16, aux, norm, R, d_in, H, L, use_fn,
                                        relu, clip, delta, use_huber, use_clipped,
                                        pb, o, slots, slot_size);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long dcc_ppo_smem_bytes(int br, int d_in, int H, int L,
                                                 int A) {
  return sizeof(float) * ppo_smem_floats(br, d_in, H, L, A);
}

// Actor: slots is n_blocks x slot_size scratch, out receives slot_size floats.
extern "C" int dcc_actor_grads(const void* x, int x_bf16, const float* aux,
                               long long R, int d_in, int H, int L, int A,
                               int use_fn, int relu, int bf16, float clip,
                               int br, const float* pb, const long long* offs,
                               int n_offs, float* slots, long long slot_size,
                               int n_blocks, float* out, void* stream) {
  if (L > DCC_MAX_LAYERS || n_offs > DCC_MAX_OFFS || A > 4 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const DccOffs o = to_offs(offs, n_offs);
  int err;
#define DCC_CASE(B)                                                                 \
  case B:                                                                           \
    err = bf16 ? launch_actor<B, true>(x, x_bf16, aux, R, d_in, H, L, A, use_fn,   \
                                       relu, clip, pb, o, slots, slot_size,         \
                                       n_blocks, s)                                 \
               : launch_actor<B, false>(x, x_bf16, aux, R, d_in, H, L, A, use_fn,  \
                                        relu, clip, pb, o, slots, slot_size,        \
                                        n_blocks, s);                               \
    break;
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(8)
    DCC_CASE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" int dcc_critic_grads(const void* x, int x_bf16, const float* aux,
                                const float* norm, long long R, int d_in, int H,
                                int L, int use_fn, int relu, int bf16, float clip,
                                float delta, int use_huber, int use_clipped,
                                int br, const float* pb, const long long* offs,
                                int n_offs, float* slots, long long slot_size,
                                int n_blocks, float* out, void* stream) {
  if (L > DCC_MAX_LAYERS || n_offs > DCC_MAX_OFFS || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const DccOffs o = to_offs(offs, n_offs);
  int err;
#define DCC_CASE(B)                                                                \
  case B:                                                                          \
    err = bf16 ? launch_critic<B, true>(x, x_bf16, aux, norm, R, d_in, H, L,      \
                                        use_fn, relu, clip, delta, use_huber,      \
                                        use_clipped, pb, o, slots, slot_size,      \
                                        n_blocks, s)                               \
               : launch_critic<B, false>(x, x_bf16, aux, norm, R, d_in, H, L,     \
                                         use_fn, relu, clip, delta, use_huber,     \
                                         use_clipped, pb, o, slots, slot_size,     \
                                         n_blocks, s);                             \
    break;
  switch (br) {
    DCC_CASE(32)
    DCC_CASE(8)
    DCC_CASE(1)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DCC_CASE
  if (err) return err;
  return reduce(slots, n_blocks, slot_size, out, s);
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
