// Tensor-core core of the bf16 trunk kernels (K2 forward in fused_mlp.cu, K2b
// backward in fused_mlp_bwd.cu, K3 / K4 and K3u / K4u loss + gradients in
// fused_ppo.cu):
// warp-level mma.sync.m16n8k16 bf16 products with f32 accumulation on
// shared-memory tiles, operands loaded with ldmatrix, weights streamed from
// L2 through a three-stage cp.async ring.
//
// Numerics are JAX's bf16 mode (dcc_tpu/ops/fused_mlp.py, fused_ppo.py): every
// matmul operand is a bf16 value and products accumulate in f32. A bf16 x
// bf16 product is exact in f32, so only the summation order differs. The
// operands live in shared memory as bf16, rounded once when written; the
// epilogues keep JAX's rounding points (z = bf16(bf16(acc) + bf16(b)),
// relu or bf16(tanh), LN statistics in f32, LN output rounded to bf16).
//
// Layouts. An activation tile is BR rows x Kp bf16, row-major, with a row
// stride of Kp + 8 elements: Kp is a multiple of 16, so a row spans an odd
// number of 16-byte chunks and the eight row addresses of one ldmatrix hit
// eight different bank groups (no conflicts). A weight is stored as the JAX
// package's Dense kernel, W[k][n] (K x N row-major), zero-padded to
// multiples of 16 in both dimensions; the forward product streams K-slices
// of it (rows k), the backward's g W^T streams column slices of the same
// buffer, so one bf16 copy serves both.
//
// Warp tiling of a BR-row product over N columns: BR / 16 warps along the
// rows, 8 / (BR / 16) column groups, each warp holding 16 rows x up to
// MmaTile<BR>::NT n-tiles (8 columns each) of f32 accumulators in
// registers. Row reductions (LN statistics) use the quad shuffles of the
// m16n8 accumulator layout, then the column groups' partials through shared
// memory, summed in a fixed order.
//
// Hidden widths. A layer's output columns run in passes of at most MMA_HMAX
// (pass_cols): each pass streams W[:, n0 : n0 + MMA_HMAX] through the ring
// and runs the epilogue on its accumulators, adding each row's LN sums
// pass by pass; the statistics follow the last pass. A layer of one pass
// (pad16(H) <= MMA_HMAX) keeps its accumulators in registers from the
// product to the LN output, as the kernels always did. Wider layers store
// each pass's activations (bf16 values, so exactly) in shared memory and
// apply the LN in a second sweep over them; the backward sums the LN
// backward's row sums over the passes first, then forms each pass's
// cotangent, and g_prev = bf16(g) W^T runs in column passes into an f32
// stage over the activation tiles the backward no longer reads
// (gprev_passes). Columns past H (the zero padding of pad16(H), any H) are
// masked in every sum, read and store.
#pragma once

#include <stdint.h>

#include "trunk.cuh"

#define MMA_THREADS 256
#define MMA_WARPS 8
#define MMA_KS 32           // K-slice of a streamed weight
#define MMA_STAGES 3        // stages of the weight ring (two slices in flight)
#define MMA_HMAX 256        // widest column pass of a layer (one warp tiling)
#define MMA_SMEM_MAX 232448 // an H100 block's shared memory
#define MMA_KC 256          // columns of a chunk of a streamed first operand

// DCC_BLOCKED: the column-blocked layout (fused_*_blocked.cu, which also set
// DCC_WIDE). Every BR x pad16(H) tile (activations, operands, cotangents,
// f32 stages, column sums) lives in the block's scratch in device memory
// (DeepScratch below) instead of shared memory, and shared memory holds
// only what does not grow with H: layer 0's operand, the weight ring and
// the per-row values. A product whose first operand is such a tile streams
// that operand's K-slices through the ring beside the weight's (gemm_stream
// with arows), and dW = in^T g stages both in column blocks of MMA_HMAX
// (grad_at_g_blocked). The arithmetic and its order are the staged
// layout's, so both give the same bits where both fit.
#ifndef DCC_BLOCKED
#define DCC_BLOCKED 0
#endif

// DCC_WIDE: the library's kernels take any hidden width: each layer in
// column passes (widths past MMA_HMAX), odd widths writing their rows and
// gradient slots one element at a time. fused_*_wide.cu define it to 1 and
// include their base source, which builds without it (0): there every
// layer is one pass of an even width up to MMA_HMAX, a compile-time fact,
// so those kernels keep their one-pass code with paired stores. Each
// wrapper picks the library by the width.
#ifndef DCC_WIDE
#define DCC_WIDE 0
#endif

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

// Columns of the widest pass of a layer with Np (padded) output columns.
__host__ __device__ inline int pass_cols(int Np) { return Np < MMA_HMAX ? Np : MMA_HMAX; }

// The end of the column passes of a layer with Np (padded) output columns:
// one pass (from column 0) in a library built without DCC_WIDE.
__host__ __device__ inline int pass_end(int Np) { return DCC_WIDE ? Np : 1; }

// Whether this library's tensor-core kernels take hidden width H.
inline bool mma_width_ok(int H) {
  return H >= 1 && (DCC_WIDE || (pad16(H) <= MMA_HMAX && H % 2 == 0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ask the TMA unit to bring [p, p + bytes) into L2 (bytes a multiple of
// 16, p 16-byte aligned); nothing waits for it.
__device__ __forceinline__ void cp_async_prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// The same for any span: the whole 16-byte chunks that lie inside it.
__device__ __forceinline__ void prefetch_l2_span(const char* p, long long bytes) {
  const char* a = (const char*)(((unsigned long long)p + 15) & ~15ull);
  const long long n = (bytes - (a - p)) & ~15ll;
  for (long long o = 0; o < n; o += 32768)
    cp_async_prefetch_l2(a + o, (unsigned)min(32768LL, n - o));
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The warp grid of a BR-row tile and the n-tiles one warp holds at the
// widest pass (MMA_HMAX columns): 16 at BR = 64, 8 at 32, 4 at 16.
template <int BR>
struct MmaTile {
  static constexpr int WM = BR / 16, WN = MMA_WARPS / WM;
  static constexpr int NT = (MMA_HMAX / 8 + WN - 1) / WN;
};

// The accumulator element i (0..3) of n-tile nt sits at row
// 16 * wm + lane / 4 (+ 8 for i >= 2), column 8 * (nt0 + nt) + 2 * (lane % 4)
// (+ 1 for odd i).
struct WarpTile {
  int wm;   // 16-row block of the tile
  int wn;   // column group
  int nt0;  // first n-tile
  int ntw;  // n-tiles held (0..MmaTile<BR>::NT)
  int r0;   // tile row of accumulator elements 0 and 1 (elements 2, 3: r0 + 8)
  int c0;   // column of element 0 in n-tile 0
};

template <int BR>
__device__ __forceinline__ WarpTile warp_tile(int n_tiles) {
  constexpr int WM = MmaTile<BR>::WM, WN = MmaTile<BR>::WN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpTile t;
  t.wm = warp % WM;
  t.wn = warp / WM;
  const int per = (n_tiles + WN - 1) / WN;
  t.nt0 = t.wn * per;
  t.ntw = max(0, min(per, n_tiles - t.nt0));
  t.r0 = t.wm * 16 + (lane >> 2);
  t.c0 = t.nt0 * 8 + (lane & 3) * 2;
  return t;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// Elements of one stage of the weight ring (MMA_STAGES of them).
__host__ __device__ inline int ring_stage(int Np, bool nk) {
  return nk ? Np * (MMA_KS + 8) : MMA_KS * (Np + 8);
}

// Elements of one stage's copy of a streamed first operand of arows rows
// (the column-blocked layout; 0 without one).
__host__ __device__ inline int ring_a(int arows) { return arows * (MMA_KS + 8); }

// acc (the warp's 16 rows x its n-tiles) = A @ B. A: BR x Kp bf16 in shared
// memory, row stride lda. B (Kp x Np) streams from global memory in K-slices
// through the ring, two slices ahead of the one being multiplied: NK =
// false reads B stored as B[k][n], NK = true reads it stored transposed,
// Bt[n][k]; ldg is the stored row stride. With arows (the column-blocked
// layout only), A lies in device memory instead: each stage also takes A's
// K-slice (arows rows, those from avalid on zero), and the products read it
// there, in the same order. One barrier per slice: after it every thread
// is done with the stage the next load overwrites; a streamed A must be
// complete for every thread on entry. Every thread of the block calls it;
// it ends with a barrier, so A and the ring are free again on return.
template <bool NK, int NT>
__device__ __forceinline__ void gemm_stream(const bf16* A, int lda, int Kp, const bf16* Bg,
                                            int ldg, int Np, bf16* ring, const WarpTile& wt,
                                            float (&acc)[NT][4], int arows = 0,
                                            int avalid = 1 << 30) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const bool ga = DCC_BLOCKED && arows > 0;  // A streams through the ring
  const int bstage = ring_stage(Np, NK);
  const int stage = bstage + (ga ? ring_a(arows) : 0);
  const int ldb = NK ? MMA_KS + 8 : Np + 8;
  const int ns = (Kp + MMA_KS - 1) / MMA_KS;
  zero_acc(acc);
  auto load = [&](int s) {
    bf16* dst = ring + (s % MMA_STAGES) * stage;
    const int k0 = s * MMA_KS, ks = min(MMA_KS, Kp - k0);
    if (ga) {
      const int cpr = ks / 8;
      for (int i = threadIdx.x; i < arows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = i - r * cpr;
        bf16* d = dst + bstage + r * (MMA_KS + 8) + c * 8;
        if (r < avalid)
          cp_async16(d, A + (long long)r * lda + k0 + c * 8);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (NK) {
      const int cpr = ks / 8;  // 16-byte chunks per stored row
      for (int i = threadIdx.x; i < Np * cpr; i += blockDim.x) {
        const int n = i / cpr, c = i - n * cpr;
        cp_async16(dst + n * ldb + c * 8, Bg + (long long)n * ldg + k0 + c * 8);
      }
    } else {
      const int cpr = Np / 8;
      for (int i = threadIdx.x; i < ks * cpr; i += blockDim.x) {
        const int k = i / cpr, c = i - k * cpr;
        cp_async16(dst + k * ldb + c * 8, Bg + (long long)(k0 + k) * ldg + c * 8);
      }
    }
    cp_async_commit();
  };
  load(0);
  if (ns > 1) load(1);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns)
      cp_async_wait<1>();  // slice s has landed; s + 1 may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();
    if (s + 2 < ns) load(s + 2);  // into the stage of slice s - 1
    const bf16* B = ring + (s % MMA_STAGES) * stage;
    const int k0 = s * MMA_KS, ks = min(MMA_KS, Kp - k0);
    for (int kk = 0; kk < ks; kk += 16) {
      uint32_t a[4];
      if (ga)
        ldsm_x4(a, B + bstage + (wt.wm * 16 + (lane & 15)) * (MMA_KS + 8) + kk + (lane >> 4) * 8);
      else
        ldsm_x4(a, A + (wt.wm * 16 + (lane & 15)) * lda + k0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT; p += 2) {
        if (p < wt.ntw) {
          // matrices: (tile p, k 0-7), (p, k 8-15), (p+1, k 0-7), (p+1, k 8-15);
          // an odd last tile loads tile p twice and uses the first half
          const int q = p + 1 < wt.ntw ? 1 : 0;
          const int n = (wt.nt0 + p + ((mat >> 1) & q)) * 8;
          uint32_t b[4];
          if (NK)
            ldsm_x4(b, B + (n + (lane & 7)) * ldb + kk + (mat & 1) * 8);
          else
            ldsm_x4_t(b, B + (kk + (mat & 1) * 8 + (lane & 7)) * ldb + n);
          mma_bf16(acc[p], a, b[0], b[1]);
          if (q) mma_bf16(acc[p + 1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();
}

// Sums over the full row width of the thread's two rows (r0, r0 + 8): the
// quad shuffle, then the column groups' partials through `red` (WN x BR x 2
// floats), added in group order. All threads call it.
template <int BR>
__device__ __forceinline__ void row_sums(float (&a)[2], float (&b)[2], float* red,
                                         const WarpTile& wt) {
  constexpr int WN = MmaTile<BR>::WN;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      a[h] += __shfl_xor_sync(0xffffffffu, a[h], o);
      b[h] += __shfl_xor_sync(0xffffffffu, b[h], o);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      red[(wt.wn * BR + wt.r0 + 8 * h) * 2] = a[h];
      red[(wt.wn * BR + wt.r0 + 8 * h) * 2 + 1] = b[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = 0.f;
    b[h] = 0.f;
    for (int w = 0; w < WN; ++w) {
      a[h] += red[(w * BR + wt.r0 + 8 * h) * 2];
      b[h] += red[(w * BR + wt.r0 + 8 * h) * 2 + 1];
    }
  }
  __syncthreads();
}

// Dense epilogue of one pass of a layer (its columns from n0), in
// registers: acc <- act(z), z = bf16(bf16(acc) + bf16(b)), act = relu or
// bf16(tanh); columns >= H are 0. Adds each of the thread's two rows' sum
// and sum of squares into s, q.
template <int BR>
__device__ __forceinline__ void dense_act(float (&acc)[MmaTile<BR>::NT][4], const float* b, int H,
                                          int n0, bool relu, const WarpTile& wt, float (&s)[2],
                                          float (&q)[2]) {
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
    if (nt < wt.ntw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + wt.c0 + nt * 8 + (i & 1);
        float r = 0.f;
        if (col < H) {
          const float z = bf16r(bf16r(acc[nt][i]) + bf16r(b[col]));
          r = relu ? fmaxf(z, 0.f) : bf16r(tanhf(z));
        }
        acc[nt][i] = r;
        s[i >> 1] += r;
        q[i >> 1] += r * r;
      }
    }
  }
}

// The relu masks' debug output of one pass (columns from n0) of a layer,
// from its activations in acc (dense_act's: relu(z) > 0 exactly where z >
// 0): mask holds the layer's rows from the tile's first, nrows of them, H
// bytes each. Called only where the caller asked for the masks.
template <int BR>
__device__ __forceinline__ void store_relu_mask(const float (&acc)[MmaTile<BR>::NT][4], int H,
                                                int n0, const WarpTile& wt, unsigned char* mask,
                                                long long nrows) {
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
    if (nt < wt.ntw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + wt.c0 + nt * 8 + (i & 1), row = wt.r0 + 8 * (i >> 1);
        if (col < H && row < nrows) mask[(long long)row * H + col] = acc[nt][i] > 0.f;
      }
    }
  }
}

// Each of the thread's two rows' mean and 1/sqrt(var + eps) over the H real
// columns (fast variance) from its partial sums s, q. All threads call it.
template <int BR>
__device__ __forceinline__ void ln_stats(float (&s)[2], float (&q)[2], int H, float* red,
                                         const WarpTile& wt, float (&mu)[2], float (&inv)[2]) {
  row_sums<BR>(s, q, red, wt);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mu[h] = s[h] / H;
    const float var = fmaxf(q[h] / H - mu[h] * mu[h], 0.f);
    inv[h] = 1.f / sqrtf(var + 1e-6f);
  }
}

// The warp tile of the pass from column n0 of a layer with Np (padded)
// output columns.
template <int BR>
__device__ __forceinline__ WarpTile pass_tile(int Np, int n0) {
  return warp_tile<BR>(min(MMA_HMAX, Np - n0) / 8);
}

// acc (the pass's accumulators) to or from a bf16 tile (row stride ld):
// columns n0 + the warp tile's.
template <int BR>
__device__ __forceinline__ void store_pass(const float (&acc)[MmaTile<BR>::NT][4], bf16* t, int ld,
                                           int n0, const WarpTile& wt) {
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt)
    if (nt < wt.ntw)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_bf16x2(t + (wt.r0 + 8 * h) * ld + n0 + wt.c0 + nt * 8, acc[nt][2 * h],
                     acc[nt][2 * h + 1]);
}

template <int BR>
__device__ __forceinline__ void load_pass(float (&acc)[MmaTile<BR>::NT][4], const bf16* t, int ld,
                                          int n0, const WarpTile& wt) {
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt)
    if (nt < wt.ntw)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nt][i] = bf(t[(wt.r0 + 8 * (i >> 1)) * ld + n0 + wt.c0 + nt * 8 + (i & 1)]);
}

// The same from an f32 stage (row stride ld), as gprev_passes writes it.
template <int BR>
__device__ __forceinline__ void load_pass_f32(float (&acc)[MmaTile<BR>::NT][4], const float* t,
                                              int ld, int n0, const WarpTile& wt) {
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt)
    if (nt < wt.ntw)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nt][i] = t[(wt.r0 + 8 * (i >> 1)) * ld + n0 + wt.c0 + nt * 8 + (i & 1)];
}

// First operand tile of the trunk for rows [row0, row0 + BR): bf16 of the
// LayerNorm of x (times scale plus bias when scale is given) if use_fn,
// else of x. Columns d_in..Kp0 and rows >= R are 0. Warp w takes rows w,
// w + 8, ...; each step of a pass loads one element of every one of the
// warp's rows through the read-only path, so those loads are in flight
// together. With use_fn and mu_out given, each row's mean and
// 1/sqrt(var + eps) go to mu_out[r] and inv_out[r].
template <int BR>
__device__ void load_input(const void* x, int x_bf16, long long row0, long long R, int d_in,
                           int Kp0, bool use_fn, const float* scale, const float* bias,
                           bf16* a0, int lda, float* mu_out = nullptr,
                           float* inv_out = nullptr) {
  constexpr int RW = BR / MMA_WARPS;  // rows per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xf = (const float*)x;
  const unsigned short* xb = (const unsigned short*)x;
  auto xv = [&](long long i) {
    return x_bf16 ? __uint_as_float((unsigned)__ldg(xb + i) << 16) : __ldg(xf + i);
  };
  long long base[RW];
  bool ok[RW];
  float mu[RW], inv[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const long long row = row0 + warp + j * MMA_WARPS;
    ok[j] = row < R;
    base[j] = row * d_in;
    mu[j] = 0.f;
    inv[j] = 1.f;
  }
  if (use_fn) {
    float sum[RW], sq[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) sum[j] = sq[j] = 0.f;
    for (int k = lane; k < d_in; k += 32) {
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        if (ok[j]) {
          const float v = xv(base[j] + k);
          sum[j] += v;
          sq[j] += v * v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      mu[j] = warp_sum(sum[j]) / d_in;
      inv[j] = 1.f / sqrtf(fmaxf(warp_sum(sq[j]) / d_in - mu[j] * mu[j], 0.f) + 1e-6f);
      if (mu_out != nullptr && lane == 0) {
        mu_out[warp + j * MMA_WARPS] = mu[j];
        inv_out[warp + j * MMA_WARPS] = inv[j];
      }
    }
  }
  for (int k = lane; k < Kp0; k += 32) {
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      float y = 0.f;
      if (ok[j] && k < d_in) {
        y = xv(base[j] + k);
        if (use_fn) {
          y = (y - mu[j]) * inv[j];
          // each step rounded on its own, as the plain version's
          if (scale != nullptr) y = __fadd_rn(__fmul_rn(y, scale[k]), bias[k]);
        }
      }
      a0[(warp + j * MMA_WARPS) * lda + k] = __float2bfloat16_rn(y);
    }
  }
}

// slot[k][j] (+)= sum_r in[r][k] * g[r][j] for k < d, j < H (slot row
// stride H; stores when `first`, else adds). in: BR x Kp bf16 (stride
// lda), g: BR x Hp bf16 (stride ldg), both in shared memory. Each warp
// accumulates 32 x 64 slabs of the product in registers over the tile's
// rows and adds each slab into the slot once; every slot element has one
// owner thread, so there are no atomics. With the slot 8-byte aligned and H
// even it reads and writes element pairs (float2), else single elements. A
// slab's slot reads all come before its stores, so they are in flight
// together. With m_lo, n_lo (grad_at_g_blocked's column blocks) only the
// slabs of rows k in [m_lo, Kp) and columns j in [n_lo, Hp) are formed,
// in pointing at in's column m_lo and g at g's column n_lo; each slab is
// the one the whole call forms.
template <int BR>
__device__ void grad_at_g(const bf16* in, int lda, int Kp, int d, const bf16* g, int ldg,
                          int Hp, int H, float* slot, bool first, int m_lo = 0, int n_lo = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, mat = lane >> 3;
  const int ms = (Kp - m_lo + 31) / 32, ns = (Hp - n_lo + 63) / 64;
  const bool pairs = !DCC_WIDE || ((H & 1) == 0 && ((unsigned long long)slot & 7) == 0);
  for (int sl = warp; sl < ms * ns; sl += MMA_WARPS) {
    const int m0 = m_lo + (sl / ns) * 32, n0 = n_lo + (sl % ns) * 64;
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    for (int r = 0; r < BR; r += 16) {
      // A = in^T: matrices (k 0-7, r 0-7), (k 8-15, r 0-7), (k 0-7, r 8-15),
      // (k 8-15, r 8-15), read transposed from the [r][k] tile
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (m0 + mt * 16 < Kp)
          ldsm_x4_t(a[mt], in + (r + (mat >> 1) * 8 + (lane & 7)) * lda + m0 - m_lo + mt * 16 +
                               (mat & 1) * 8);
#pragma unroll
      for (int p = 0; p < 8; p += 2) {
        if (n0 + p * 8 < Hp) {
          uint32_t b[4];
          ldsm_x4_t(b, g + (r + (mat & 1) * 8 + (lane & 7)) * ldg + n0 - n_lo +
                           (p + (mat >> 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (m0 + mt * 16 < Kp) {
              mma_bf16(acc[mt][p], a[mt], b[0], b[1]);
              mma_bf16(acc[mt][p + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
    if (!first) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = m0 + mt * 16 + (lane >> 2) + 8 * h;
            const int j = n0 + nt * 8 + (lane & 3) * 2;
            if (k < d && j < H) {
              const float* p = slot + (long long)k * H + j;
              const float2 o = pairs ? *reinterpret_cast<const float2*>(p)
                                     : make_float2(p[0], j + 1 < H ? p[1] : 0.f);
              acc[mt][nt][2 * h] += o.x;
              acc[mt][nt][2 * h + 1] += o.y;
            }
          }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = m0 + mt * 16 + (lane >> 2) + 8 * h;
          const int j = n0 + nt * 8 + (lane & 3) * 2;
          if (k < d && j < H) {
            float* p = slot + (long long)k * H + j;
            if (pairs) {
              *reinterpret_cast<float2*>(p) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            } else {
              p[0] = acc[mt][nt][2 * h];
              if (j + 1 < H) p[1] = acc[mt][nt][2 * h + 1];
            }
          }
        }
  }
}

// ncols (a multiple of 8) columns of BR rows of a tile in device memory
// (row stride lds) into shared memory (row stride ldd), by cp.async; the
// caller commits and waits.
template <int BR>
__device__ __forceinline__ void stage_cols(bf16* dst, int ldd, const bf16* src, int lds,
                                           int ncols) {
  const int cpr = ncols / 8;
  for (int i = threadIdx.x; i < BR * cpr; i += blockDim.x) {
    const int r = i / cpr, c = i - r * cpr;
    cp_async16(dst + r * ldd + c * 8, src + (long long)r * lds + c * 8);
  }
}

// grad_at_g in the column-blocked layout: g (BR x Hp) in device memory and
// in (BR x Kp) there too, or in shared memory with in_smem (layer 0's
// operand). Per block of MMA_HMAX columns of g and of in, both staged into
// shared memory (sin, sg: BR x (MMA_HMAX + 8) bf16 each; in_smem: in read
// in place), grad_at_g forms the block's slabs: each slot element is one
// slab's, summed as the whole call sums it. Every thread calls it; the
// operands must be complete on entry, and it ends with a barrier.
template <int BR>
__device__ void grad_at_g_blocked(const bf16* in, int lda, bool in_smem, int Kp, int d,
                                  const bf16* g, int ldg, int Hp, int H, float* slot, bool first,
                                  bf16* sin, bf16* sg) {
  constexpr int ld = MMA_HMAX + 8;
  for (int j0 = 0; j0 < Hp; j0 += MMA_HMAX) {
    const int jn = min(MMA_HMAX, Hp - j0);
    for (int k0 = 0; k0 < Kp; k0 += MMA_HMAX) {
      const int kn = min(MMA_HMAX, Kp - k0);
      if (k0 == 0) stage_cols<BR>(sg, ld, g + j0, ldg, jn);
      if (!in_smem) stage_cols<BR>(sin, ld, in + k0, lda, kn);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      grad_at_g<BR>(in_smem ? in + k0 : sin, in_smem ? lda : ld, k0 + kn, d, sg, ld, j0 + jn, H,
                    slot, first, k0, j0);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The unfolded chain on the tensor cores (dcc_tpu/ops/fused_mlp.py::
// _forward_chain, its backward _bwd_kernel / fused_ppo.py::_trunk_bwd): the
// LN affines are applied as written, so the backward also yields every LN
// scale and bias gradient. Shared by K2b (fused_mlp_bwd.cu) and the unfolded
// K3 / K4 (fused_ppo.cu).
// ---------------------------------------------------------------------------

#define FLAG_CAP 128  // listed re-sums of one layer of one tile (more: by their owners)
#define RESUM_BYTES (16 + 8 * FLAG_CAP)

// The LN output y = xhat * s + c of an activation a, xhat = (a - mu) * inv,
// in f32 before its bf16 rounding. Every step rounds on its own (no fused
// multiply-add), so the forward's store and the backward's recompute give
// the same bits, as PyTorch's separate elementwise operations do.
__device__ __forceinline__ float ln_affine(float a, float mu, float inv, float s, float c) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a, mu), inv), s), c);
}

// Whether the relu mask of the pre-activation z = bf16(bf16(acc) + bf16(b))
// may differ between two f32 summation orders of acc = sum_k a_k w_k: z is
// within one bf16 step of the accumulator from the kink (the step can move
// bf16(acc) and z across it), or acc itself is within the bound on any
// order's rounding error, K 2^-24 sum |a_k w_k| <= 2^-14 |a| |w| for K <=
// 448, so that the order sets its sign (a sum that cancels: at init every
// bias is 0 and z = bf16(acc)).
__device__ __forceinline__ bool relu_uncertain(float acc, float b, float anorm, float wnorm) {
  int e;
  frexpf(acc, &e);
  const float z = bf16r(bf16r(acc) + bf16r(b));
  return fabsf(z) <= ldexpf(1.f, e - 8) || fabsf(acc) <= 0x1p-14f * anorm * wnorm;
}

// sum_k a[k] w[k * ldw] for k < K in sequential order, one rounding per term
// (the bf16 products are exact in f32); with sq, sum_k w[k * ldw]^2. The
// loads of 16 terms are issued before their sums, so they are in flight
// together.
__device__ __noinline__ float dot_sequential(const bf16* a, const bf16* w, int ldw, int K,
                                             bool sq = false) {
  float s = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < K; k0 += 16) {
    float av[16], wv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool in = k0 + j < K;
      wv[j] = in ? bf(w[(long long)(k0 + j) * ldw]) : 0.f;
      av[j] = in ? (sq ? wv[j] : bf(a[k0 + j])) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) s = fmaf(av[j], wv[j], s);
  }
  return s;
}

// Element i of an input row buffer x (f32, or bf16 when x_bf16), through the
// read-only path.
__device__ __forceinline__ float load_x(const void* x, int x_bf16, long long i) {
  return x_bf16 ? __uint_as_float((unsigned)__ldg((const unsigned short*)x + i) << 16)
                : __ldg((const float*)x + i);
}

// The chunked first operand, for rows too wide to stage whole (ROADMAP B2).
// input_stats is load_input's first pass: each row's feature-norm mean and
// 1/sqrt(var + eps) (mean 0 and 1 without use_fn) into mu[BR] and inv[BR],
// each lane summing columns lane, lane + 32, ... in that order, as
// load_input does, but with eight columns' loads in flight at a time.
// Then chunk by chunk of MMA_KC = 256 columns (lane l holds columns
// 8 l .. 8 l + 7 of each of its rows): fetch_chunk loads one into
// registers (one 16-byte load a row when x is bf16 with rows 16-byte
// aligned, else eight), so that it is in flight during the previous
// chunk's product, and stage_chunk writes bf16((x - mu) * inv) (bf16(x)
// without use_fn; with the feature norm's affine fs, fb given,
// bf16((x - mu) * inv * fs + fb), each step rounded on its own as in
// load_input) to dst (BR x MMA_KC, row stride ld); columns past d_in and
// rows >= R are 0.
template <int BR>
__device__ void input_stats(const void* x, int x_bf16, long long row0, long long R, int d_in,
                            bool use_fn, float* mu, float* inv) {
  constexpr int RW = BR / MMA_WARPS;  // rows per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sum[RW], sq[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) sum[j] = sq[j] = 0.f;
  if (use_fn) {
    for (int kb = 0; kb < d_in; kb += 8 * 32) {
      float v[8][RW];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kb + lane + 32 * u;
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const long long row = row0 + warp + j * MMA_WARPS;
          v[u][j] = row < R && k < d_in ? load_x(x, x_bf16, row * d_in + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          if (kb + lane + 32 * u < d_in && row0 + warp + j * MMA_WARPS < R) {
            sum[j] += v[u][j];
            sq[j] += v[u][j] * v[u][j];
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    float m = 0.f, iv = 1.f;
    if (use_fn) {
      m = warp_sum(sum[j]) / d_in;
      iv = 1.f / sqrtf(fmaxf(warp_sum(sq[j]) / d_in - m * m, 0.f) + 1e-6f);
    }
    if (lane == 0) {
      mu[warp + j * MMA_WARPS] = m;
      inv[warp + j * MMA_WARPS] = iv;
    }
  }
}

template <int BR>
__device__ __forceinline__ void fetch_chunk(const void* x, int x_bf16, long long row0,
                                            long long R, int d_in, int k0,
                                            float (&xv)[BR / MMA_WARPS][8]) {
  const int warp = threadIdx.x >> 5, col = k0 + 8 * (threadIdx.x & 31);
  const bool vec = x_bf16 && d_in % 8 == 0;
#pragma unroll
  for (int j = 0; j < BR / MMA_WARPS; ++j) {
    const long long row = row0 + warp + j * MMA_WARPS;
    const bool in = row < R;
    if (vec) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (in && col < d_in)
        u = __ldg(reinterpret_cast<const uint4*>((const bf16*)x + row * d_in + col));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xv[j][2 * e] = __uint_as_float(w[e] << 16);
        xv[j][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xv[j][e] = in && col + e < d_in ? load_x(x, x_bf16, row * d_in + col + e) : 0.f;
    }
  }
}

template <int BR, bool AFF = false>
__device__ __forceinline__ void stage_chunk(const float (&xv)[BR / MMA_WARPS][8],
                                            long long row0, long long R, int d_in, int k0,
                                            bool use_fn, const float* mu, const float* inv,
                                            bf16* dst, int ld, const float* fs = nullptr,
                                            const float* fb = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, col = k0 + 8 * lane;
  // the affine of column col + e (read where it is applied: L1 hits)
  auto affine = [&](float v, int e) {
    return col + e < d_in ? __fadd_rn(__fmul_rn(v, __ldg(fs + col + e)), __ldg(fb + col + e))
                          : 0.f;
  };
#pragma unroll
  for (int j = 0; j < BR / MMA_WARPS; ++j) {
    const int r = warp + j * MMA_WARPS;
    const bool in = row0 + r < R;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = xv[j][2 * e], b = xv[j][2 * e + 1];
      if (use_fn) {
        a = (a - mu[r]) * inv[r];
        b = (b - mu[r]) * inv[r];
        if constexpr (AFF) {
          a = affine(a, 2 * e);
          b = affine(b, 2 * e + 1);
        }
      }
      a = in && col + 2 * e < d_in ? a : 0.f;
      b = in && col + 2 * e + 1 < d_in ? b : 0.f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * lane) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Layer 0's product acc = a0 @ W_0[:, n0 : n0 + pass] (one column pass,
// warp tile wt) over a chunked first operand (rows too wide to stage
// whole, ROADMAP B2): chunk by chunk, stage_chunk writes the
// operand (folded bf16(xhat); AFF, the unfolded chain's, bf16(xhat * fs +
// fb)) into a0 (BR x MMA_KC, stride lda0), its product with W_0's rows
// k0 .. k0 + MMA_KC runs on the tensor cores, and the chunks' products are
// summed in f32 (round to nearest): the tensor cores' accumulation is not
// rounded to nearest, and a chain over all 4,840 columns would bias the
// pre-activations it rounds to bf16. The next chunk's rows load during
// this chunk's product. mu, inv: the rows' statistics (input_stats). Every
// thread calls it; it ends with gemm_stream's barrier.
template <int BR, bool AFF>
__device__ void chunked_layer0(const void* x, int x_bf16, long long row0, long long R,
                               int d_in, bool use_fn, const float* mu, const float* inv,
                               const float* fs, const float* fb, bf16* a0, int lda0,
                               const bf16* w0, int Hp, int n0, bf16* ring, const WarpTile& wt,
                               float (&acc)[MmaTile<BR>::NT][4]) {
  const int Kp0 = pad16(d_in);
  float part[MmaTile<BR>::NT][4];
  float xv[BR / MMA_WARPS][8];  // the next chunk of the tile's rows
  fetch_chunk<BR>(x, x_bf16, row0, R, d_in, 0, xv);
  for (int k0 = 0; k0 < Kp0; k0 += MMA_KC) {
    const int kc = min(MMA_KC, Kp0 - k0);
    stage_chunk<BR, AFF>(xv, row0, R, d_in, k0, use_fn, mu, inv, a0, lda0, fs, fb);
    __syncthreads();
    if (k0 + MMA_KC < Kp0)  // in flight during this chunk's product
      fetch_chunk<BR>(x, x_bf16, row0, R, d_in, k0 + MMA_KC, xv);
    gemm_stream<false>(a0, lda0, kc, w0 + (long long)k0 * Hp + n0, Hp, min(MMA_HMAX, Hp - n0),
                       ring, wt, part);
#pragma unroll
    for (int nt = 0; nt < MmaTile<BR>::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = k0 == 0 ? part[nt][i] : acc[nt][i] + part[nt][i];
  }
}

// The list of one layer's re-sums in shared memory (RESUM_BYTES at p): a
// count, FLAG_CAP keys (row << 16 | column) and their values.
struct ResumList {
  int* n;
  int* key;
  float* val;
};

__device__ __forceinline__ ResumList resum_list(unsigned char* p) {
  ResumList l;
  l.n = (int*)p;
  l.key = l.n + 4;
  l.val = (float*)(l.key + FLAG_CAP);
  return l;
}

// cnorm[li * Hp + c] = |column c of W_li| for every layer from l0 (bf16
// W_li at wb + woffs[li], Kp0 rows for layer 0, Hp for the others), once
// per block.
__device__ __forceinline__ void weight_col_norms(const bf16* wb, const long long* woffs, int L,
                                                 int Kp0, int Hp, float* cnorm, int l0 = 0) {
  for (int i = threadIdx.x + l0 * Hp; i < L * Hp; i += blockDim.x) {
    const int li = i / Hp, c = i - li * Hp;
    cnorm[i] = sqrtf(dot_sequential(nullptr, wb + woffs[li] + c, Hp, li == 0 ? Kp0 : Hp, true));
  }
}

// ---------------------------------------------------------------------------
// The depth layout of the bf16 gradient kernels (K2b, K3 / K4,
// K3u / K4u). Their staged layouts keep every layer's bf16 activations, LN
// statistics and (unfolded) weight column norms in shared memory, which
// bounds the trunk's depth (13-15 layers at hidden 256). In the depth
// layout those live in a per-block scratch in global memory, and shared
// memory holds one layer's activation tile at a time: the forward writes
// each layer's tile to the scratch as it stores it (beside the shared
// tile, which the LN sweep and the head read), and the backward stages
// layer li's tile back into the shared tile by cp.async before its LN
// backward (stage_tile). The previous layer's tile, which the backward
// reads once to recompute its operand, and the statistics are read from the
// scratch where they are used. The arithmetic and its order are the staged
// layout's, so both give the same bits. A block's scratch is its own
// (blockIdx.x's slice), so no block reads another's.
// ---------------------------------------------------------------------------
//
// The column-blocked layout (DCC_BLOCKED) extends the scratch with the
// tiles whose width is the hidden width's: the operand sx, the cotangent
// gs, the f32 g_prev stages and the column sums, and the head's weights;
// there every layer's tile is read where it lies (act[li]), never staged.
struct DeepScratch {
  bf16* act;      // L x BR x (Hp + 8): each layer's activation tile
  float* mu;      // L x BR: each layer's rows' LN mean
  float* inv;     // L x BR: and 1/sqrt(var + eps)
  float* cnorm;   // L x Hp: the weights' column norms (unfolded relu)
  bf16* sx;       // blocked: BR x (Hp + 8), the operand of layer li >= 1
  bf16* gs;       // blocked: BR x (Hp + 8), bf16 of the current cotangent
  float* gst;     // blocked: BR x (Hp + 4), a layer's f32 g_prev
  float* stage;   // blocked, staged layer 0: BR x (Kp0 + 4), layer 0's f32 g_prev
  float* colsum;  // blocked: 3 x BR/16 x Hp, the column sums
  float* wh;      // blocked: 4 x Hp, the head's weights (H x A, A <= 4)
};

// Bytes of one block's scratch; a multiple of 16, so every block's slice
// and every tile in it is 16-byte aligned.
__host__ __device__ inline size_t deep_scratch_bytes(int br, int H, int L) {
  const size_t Hp = pad16(H);
  return 2 * (size_t)L * br * (Hp + 8) + 4 * 2 * (size_t)L * br + 4 * (size_t)L * Hp;
}

// The column-blocked layout's: the depth layout's, then sx, gs, gst, the
// stage (chunked: none), colsum and wh; also a multiple of 16.
__host__ __device__ inline size_t blocked_scratch_bytes(int br, int d_in, int H, int L,
                                                        bool chunked) {
  const size_t Hp = pad16(H), Kp0 = chunked ? 0 : pad16(d_in) + 4;
  return deep_scratch_bytes(br, H, L) + 2 * 2 * (size_t)br * (Hp + 8) + 4 * (size_t)br * (Hp + 4) +
         4 * (size_t)br * Kp0 + 4 * 3 * (size_t)(br / 16) * Hp + 4 * 4 * Hp;
}

// Block blockIdx.x's slice of the scratch at base (null: the staged layout,
// every member null); the blocked members are null outside DCC_BLOCKED.
template <int BR>
__device__ __forceinline__ DeepScratch deep_scratch(unsigned char* base, int d_in, int H, int L,
                                                    bool chunked) {
  DeepScratch d{};
  if (base == nullptr) return d;
  const long long Hp = pad16(H);
  const size_t slice = DCC_BLOCKED ? blocked_scratch_bytes(BR, d_in, H, L, chunked)
                                   : deep_scratch_bytes(BR, H, L);
  unsigned char* p = base + (long long)blockIdx.x * slice;
  d.act = (bf16*)p;
  d.mu = (float*)(p + 2LL * L * BR * (Hp + 8));
  d.inv = d.mu + (long long)L * BR;
  d.cnorm = d.inv + (long long)L * BR;
  if (DCC_BLOCKED) {
    unsigned char* q = p + deep_scratch_bytes(BR, H, L);
    d.sx = (bf16*)q;
    d.gs = d.sx + BR * (Hp + 8);
    d.gst = (float*)(d.gs + BR * (Hp + 8));
    d.stage = d.gst + BR * (Hp + 4);
    d.colsum = d.stage + (chunked ? 0 : BR * (pad16(d_in) + 4));
    d.wh = d.colsum + 3 * (BR / 16) * Hp;
  }
  return d;
}

// Shared memory of the weight ring of a gradient kernel (stages of
// ring_stage(nmax, nk)), where the column-blocked layout also streams a
// BR-row first operand through it and stages grad_at_g_blocked's two column
// blocks over it.
__host__ __device__ inline size_t ring_bytes(int br, int st) {
  size_t b = 2 * MMA_STAGES * (size_t)(st + (DCC_BLOCKED ? ring_a(br) : 0));
  const size_t blocks = DCC_BLOCKED ? 2 * 2 * (size_t)br * (MMA_HMAX + 8) : 0;
  return b > blocks ? b : blocks;
}

// One layer's saved tile (BR x ldh bf16, ldh a multiple of 8) from the
// scratch into the shared tile dst, by cp.async; every thread calls it, and
// the tile is complete for every thread on return. The caller has made sure
// no thread still reads dst.
template <int BR>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int ldh) {
  for (int i = threadIdx.x; i < BR * ldh / 8; i += blockDim.x) cp_async16(dst + 8 * i, src + 8 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// rnorm[r] = |row r of the operand| over its K columns, one warp per row;
// visible after the caller's next barrier (gemm_stream's first).
template <int BR>
__device__ __forceinline__ void operand_row_norms(const bf16* in, int lda, int K,
                                                  float* rnorm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BR; r += MMA_WARPS) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s = fmaf(bf(in[r * lda + k]), bf(in[r * lda + k]), s);
    s = warp_sum(s);
    if (lane == 0) rnorm[r] = sqrtf(s);
  }
}

// The relu mask must agree with the plain version's, since it decides
// whether a whole element of the gradient flows: every pre-activation of
// acc = in @ W (bias b, column norms cnorm of this W, row norms rnorm of
// in) whose sign a summation order can change (relu_uncertain) is re-summed
// on the CUDA cores in sequential k order, the order of the CPU's and the
// FMA kernels' small products. Such pre-activations are rare (~0.1 %); each
// layer of a tile lists them in `l` and the block's threads re-sum them in
// parallel (past FLAG_CAP, by their owners). acc holds the pass of the
// layer's columns from n0 (warp tile wt). Every thread calls it.
template <int BR>
__device__ __forceinline__ void resum_uncertain(float (&acc)[MmaTile<BR>::NT][4], const bf16* in,
                                                int lda, int K, const bf16* w, int Hp,
                                                const float* b, int H, const float* rnorm,
                                                const float* cnorm, long long row0, long long R,
                                                const WarpTile& wt, int n0, const ResumList& l) {
  unsigned long long listed = 0, own = 0;  // bit 4 nt + i of acc
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wt.r0 + 8 * (i >> 1), col = n0 + wt.c0 + nt * 8 + (i & 1);
      if (nt < wt.ntw && col < H && row0 + r < R &&
          relu_uncertain(acc[nt][i], b[col], rnorm[r], cnorm[col])) {
        const int j = atomicAdd(l.n, 1);
        if (j < FLAG_CAP) {
          l.key[j] = r << 16 | col;
          listed |= 1ull << (4 * nt + i);
        } else {
          own |= 1ull << (4 * nt + i);
        }
      }
    }
  }
  if (__syncthreads_or((listed | own) != 0)) {
    const int n = min(*l.n, FLAG_CAP);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      l.val[j] = dot_sequential(in + (l.key[j] >> 16) * lda, w + (l.key[j] & 0xffff), Hp, K);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wt.r0 + 8 * (i >> 1), col = n0 + wt.c0 + nt * 8 + (i & 1);
        if ((listed >> (4 * nt + i)) & 1) {
          for (int j = 0; j < n; ++j)
            if (l.key[j] == (r << 16 | col)) acc[nt][i] = l.val[j];
        }
      }
    }
#pragma unroll 1
    for (; own != 0; own &= own - 1) {  // past the list: the owner re-sums
      const int bit = __ffsll((long long)own) - 1, r = wt.r0 + 8 * ((bit & 3) >> 1);
      const int col = n0 + wt.c0 + (bit >> 2) * 8 + (bit & 1);
      const float v = dot_sequential(in + r * lda, w + col, Hp, K);
#pragma unroll
      for (int nt = 0; nt < MmaTile<BR>::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * nt + i == bit) acc[nt][i] = v;
    }
    __syncthreads();  // the list is read: empty it for the next layer
    if (threadIdx.x == 0) *l.n = 0;
  }
}

// The LN backward of a layer (dcc_tpu/ops/fused_mlp.py::_ln_bwd) and its
// activation's, one column pass at a time: acc holds the pass (columns from
// n0, warp tile wt) of the cotangent g of the layer's LN output, y = xhat *
// scale + bias with AFF (the unfolded chain's), y = xhat without (the
// folded chain's, scale unread). act: the layer's activations (row stride
// ldh); mu, inv: its rows' LN statistics. ln_bwd_sums adds the thread's two
// rows' partial sums of g s and g s xhat (s = scale, or 1) over the pass
// into s1, s2; ln_bwd_rows completes them over the tile and takes their
// means over the H columns; ln_bwd_apply then turns acc into the cotangent
// of the layer's pre-activation (columns >= H 0), writes its bf16 rounding
// to gs and the column sums over the warp's 16 rows of it (the Dense bias's
// gradient) to colsum[wm][*] (folded) or colsum[2][wm][*], with AFF those
// of g xhat and g (the LN scale's and bias's) to colsum[0] and colsum[1].
template <int BR, bool AFF>
__device__ __forceinline__ void ln_bwd_sums(const float (&acc)[MmaTile<BR>::NT][4],
                                            const bf16* act, int ldh, const float* mu,
                                            const float* inv, const float* scale, int H, int n0,
                                            const WarpTile& wt, float (&s1)[2], float (&s2)[2]) {
  const float m[2] = {mu[wt.r0], mu[wt.r0 + 8]};
  const float iv[2] = {inv[wt.r0], inv[wt.r0 + 8]};
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
    if (nt < wt.ntw) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, col = n0 + wt.c0 + nt * 8 + (i & 1);
        if (col < H) {
          const float xh = (bf(act[(wt.r0 + 8 * h) * ldh + col]) - m[h]) * iv[h];
          if constexpr (AFF) {
            const float gg = acc[nt][i] * __ldg(scale + col);
            s1[h] += gg;
            s2[h] += gg * xh;
          } else {
            s1[h] += acc[nt][i];
            s2[h] += acc[nt][i] * xh;
          }
        }
      }
    }
  }
}

template <int BR>
__device__ __forceinline__ void ln_bwd_rows(float (&s1)[2], float (&s2)[2], int H, float* red,
                                            const WarpTile& wt) {
  row_sums<BR>(s1, s2, red, wt);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] /= H;
    s2[h] /= H;
  }
}

template <int BR, bool AFF>
__device__ __forceinline__ void ln_bwd_apply(float (&acc)[MmaTile<BR>::NT][4], const bf16* act,
                                             int ldh, const float* mu, const float* inv,
                                             const float* scale, int H, int Hp, int n0,
                                             bool relu, const float (&s1)[2],
                                             const float (&s2)[2], const WarpTile& wt,
                                             float* colsum, bf16* gs) {
  constexpr int WM = MmaTile<BR>::WM, NK = AFF ? 3 : 1;  // column sums kept
  const int lane = threadIdx.x & 31;
  const float m[2] = {mu[wt.r0], mu[wt.r0 + 8]};
  const float iv[2] = {inv[wt.r0], inv[wt.r0 + 8]};
#pragma unroll
  for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
    if (nt < wt.ntw) {
      float cs[NK][2];
#pragma unroll
      for (int k = 0; k < NK; ++k) cs[k][0] = cs[k][1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, col = n0 + wt.c0 + nt * 8 + (i & 1);
        float v = 0.f;
        if (col < H) {
          const float a = bf(act[(wt.r0 + 8 * h) * ldh + col]);
          const float xh = (a - m[h]) * iv[h];
          const float g = acc[nt][i];
          if constexpr (AFF) {
            cs[0][i & 1] += g * xh;
            cs[1][i & 1] += g;
            v = iv[h] * (g * __ldg(scale + col) - s1[h] - xh * s2[h]);
          } else {
            v = iv[h] * (g - s1[h] - xh * s2[h]);
          }
          v = relu ? (a > 0.f ? v : 0.f) : v * (1.f - a * a);
        }
        acc[nt][i] = v;
        cs[NK - 1][i & 1] += v;
      }
#pragma unroll
      for (int k = 0; k < NK; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cs[k][e] += __shfl_xor_sync(0xffffffffu, cs[k][e], o);
      const int c = n0 + wt.c0 + nt * 8;
      if (lane < 4) {
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int kk = AFF ? k : 0;
          colsum[(kk * WM + wt.wm) * Hp + c] = cs[k][0];
          colsum[(kk * WM + wt.wm) * Hp + c + 1] = cs[k][1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_bf16x2(gs + (wt.r0 + 8 * h) * ldh + c, acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// A layer's g_prev = bf16(g) @ W^T over its Kp0 input columns (layer 0's
// d_in, padded; a hidden layer's Hp), in passes of at most MMA_HMAX, into
// stage (BR x ldf f32). gs: bf16(g), BR x Hp (stride ldh); w0: the layer's
// bf16 W (Kp0 x Hp). The stage may lie over tiles that the block has
// finished reading (every thread passes gemm_stream's first barrier before
// any stage store). Every thread calls it; the stage is complete after the
// caller's next barrier. arows: gs lies in device memory (the column-blocked
// layout, gemm_stream's).
template <int BR>
__device__ __forceinline__ void gprev_passes(const bf16* gs, int ldh, int Hp, const bf16* w0,
                                             int Kp0, bf16* ring, float* stage, int ldf,
                                             int arows = 0) {
  float acc[MmaTile<BR>::NT][4];
  for (int c0 = 0; c0 < Kp0; c0 += MMA_HMAX) {
    const int nc = min(MMA_HMAX, Kp0 - c0);
    const WarpTile pt = warp_tile<BR>(nc / 8);
    gemm_stream<true>(gs, ldh, Hp, w0 + (long long)c0 * Hp, Hp, nc, ring, pt, acc, arows);
#pragma unroll
    for (int nt = 0; nt < MmaTile<BR>::NT; ++nt) {
      if (nt < pt.ntw) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + pt.c0 + nt * 8;
          *reinterpret_cast<float2*>(stage + (pt.r0 + 8 * h) * ldf + c) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        }
      }
    }
  }
}

// The feature norm's scale and bias gradients of one tile: column sums over
// its rows of g * xhat and g, g the staged layer-0 g_prev (gprev_passes) and
// xhat = (x - fmu) * finv recomputed from the input rows; rows >= R are
// skipped. Stored into ds / db by the block's first tile, else added.
template <int BR>
__device__ __forceinline__ void fn_affine_grads(const float* stage, int ldf, const void* x,
                                                int x_bf16, long long row0, long long R,
                                                int d_in, const float* fmu, const float* finv,
                                                float* ds, float* db, bool first) {
  for (int k = threadIdx.x; k < d_in; k += blockDim.x) {
    float sgx = 0.f, sg = 0.f;
    for (int r = 0; r < BR && row0 + r < R; ++r) {
      const float g = stage[r * ldf + k];
      sgx += g * ((load_x(x, x_bf16, (row0 + r) * d_in + k) - fmu[r]) * finv[r]);
      sg += g;
    }
    ds[k] = first ? sgx : ds[k] + sgx;
    db[k] = first ? sg : db[k] + sg;
  }
}
