// The layer-0 tail of the chunked bf16 K2b, K3, K4, K3u and K4u, redesigned
// for Hopper's shared memory, asynchronous copies and warpgroup tensor cores:
//
//  - dv0_wgmma_kernel: layer 0's weight gradient, dV0 = bf16(xhat)^T g0 with
//    xhat = (x - mu) * inv (the folded K3 / K4: _trunk_bwd_folded's
//    _mm(a, g, bf16, transpose_a=True) at li = 0, dcc_tpu/ops/fused_ppo.py:161,
//    reached from :575 and :667), or in its affine mode bf16(xhat * fs +
//    fb)^T g0 (the unfolded chain's dW0: dcc_tpu/ops/fused_mlp.py:194-200,
//    fused_ppo.py:253 for K3u / K4u);
//  - layer0_input_bwd_wgmma_kernel: the feature norm's scale and bias
//    gradients below layer 0's cotangent, g_prev = g0 W_0^T and then
//    _ln_bwd's dfs = sum_r g_prev xhat, dfb = sum_r g_prev
//    (dcc_tpu/ops/fused_mlp.py:208-219), without dx, which is how MAPPO's
//    update calls it (its rows are observations). The dx mode, whose row
//    sums span every column, and hidden widths past 256 keep the row-tiled
//    layer0_input_bwd_mma_kernel of fused_mlp_bwd.cu.
//
// The TPU kernels keep these (d_in x H) sums resident in VMEM across a
// sequential grid. Both functions read every row of x (R x d_in, 1.5-1.9 GB
// at the wide runs' shapes) once and do 2 R d_in H operations, so on an H100
// they sit on both bounds at H = 256 (x's bytes 0.45 ms, the products 0.39 ms
// at 153,600 x 4,840). Design:
//
//  - A block owns 128 columns of x (d_in) and one row split; the grid is
//    (column blocks [x dV0's passes over g0's columns]) x splits, the split
//    count chosen by the wrapper to fill whole waves of the 132 SMs (one
//    block an SM). Each block writes its partial once; reduce_slots_kernel
//    sums the splits in order, so results repeat bit for bit, with no
//    atomics.
//  - 384 threads: warpgroups 0 and 1 consume (wgmma), warpgroup 2 produces:
//    a ring of stages filled by asynchronous copies that complete on
//    mbarriers, freed by the consumers' warps.
//  - dV0 (M = 128 columns of x, N = 128 columns of g0 a pass, K = rows, 64
//    a step): one thread of warpgroup 2 issues every copy by TMA (x, g0, the
//    rows' statistics; see dv0_wgmma_kernel for rows that are not 16-byte
//    aligned) and gives its registers to the consumers (setmaxnreg). Each
//    consumer warpgroup normalises (and in the affine mode scales, rounding
//    step by step as the chunked forward does: __fmul_rn, __fadd_rn) its 64
//    columns of the stage's x and writes them in bf16 in the swizzled layout
//    that wgmma reads as an MN-major A operand, while its previous step's
//    products run; g0 goes from TMA straight to wgmma as the MN-major B
//    operand. A warpgroup holds its 64 x 128 part in 64 f32 registers a
//    thread. The tensor cores' accumulation truncates, so a chain over a
//    whole split would drift with its length: every 512 rows (DV0_FLUSH
//    steps) the registers are added into 64 f32 sums a thread (round to
//    nearest) and the next products start them afresh. With the sums in
//    registers the ring takes all of shared memory (3-6 stages of 64 rows).
//    H = 256 runs two passes over g0's columns on neighbouring blocks, which
//    read the same x rows together (the second from L2).
//  - layer-0 input backward (M = 64 rows a step, N = 128 columns of x, K =
//    H <= 256): the block's 128 x H slice of the bf16 W_0 stays in shared
//    memory (one TMA load); g0 comes by TMA as the K-major A operand, W_0's
//    slice is the K-major B; x and the statistics come by cp.async (16-byte
//    pieces into the swizzled layout, or each row's window of aligned
//    pieces), each producer thread arriving once its copies land. The two
//    consumer warpgroups take alternate steps, multiply g_prev by xhat from
//    the stage in f32 and keep dfs and dfb in registers over all their rows,
//    summed over lanes and warps in a fixed order at the end.
//
// Measured on the card, a first design that normalised x in warpgroup 2
// ran at a quarter of the tensor cores' rate: four warps cannot issue the
// transform as fast as the products consume it. One fused launch of the two
// (x read once on the unfolded paths) would hold W_0's 64 KB slice beside
// dV0's ring and 64 + 64 + 64 + 64 registers a thread of dV0's and g_prev's
// accumulators and sums; it is not built.
#include "hopper.cuh"
#include "slots.cuh"

#include <dlfcn.h>

typedef __nv_bfloat16 bf16;

#define TAIL_THREADS 384  // two consumer warpgroups and the producer's
#define TAIL_KB 128       // columns of x a block owns
#define DV0_RS 64         // rows a dV0 step (four K steps of 16)
#define DV0_N 128         // columns of g0 a dV0 pass
#define DV0_FLUSH 8       // steps between the flushes into the f32 sums (512 rows)
#define L0_RS 64          // rows a step of the layer-0 input backward (one M tile)
#define L0_HMAX 256       // widest hidden layer it takes

// How the layer-0 input backward's x reaches shared memory (the entry picks
// it from the pointer, the width and the dtype): bf16 rows 16-byte
// aligned, copied into the swizzled layout; bf16 otherwise, or f32, copied
// as windows of aligned 16-byte pieces (tail_win bytes a row) read back at
// each row's offset.
enum { XM_BF16 = 0, XM_BF16_WIN = 1, XM_F32_WIN = 2 };

__host__ __device__ constexpr int tail_win(int xm) {
  return xm == XM_BF16 ? 0 : xm == XM_BF16_WIN ? 272 : 528;
}
__host__ __device__ inline int tail_pad16(int n) { return (n + 15) / 16 * 16; }

// stages of the rings (dV0: by x's dtype and whether its rows come as windows)
__host__ __device__ constexpr int dv0_stages(bool xf32, bool win) {
  return xf32 ? 3 : win ? 4 : 6;
}
__host__ __device__ constexpr int l0_stages(int xm) { return xm == XM_F32_WIN ? 2 : 3; }

// Shared memory of the dV0 kernel, from a 1,024-byte aligned base (the
// swizzled operands first): per stage the bf16 operand A (2 boxes of 64
// rows x 128 bytes) and g0 (2 boxes), the raw x (windows of 272 / 528
// bytes a row, or f32 rows by TMA: 4 boxes of 32 columns), the rows' (mu,
// inv); the full / empty barriers. ``total`` includes the
// alignment slack.
struct Dv0Layout {
  size_t a, g, raw, st, bar, total;
};

__host__ __device__ inline Dv0Layout dv0_layout(bool xf32, bool win) {
  const size_t S = dv0_stages(xf32, win);
  Dv0Layout m;
  size_t o = 0;
  m.a = o;   o += S * 2 * DV0_RS * 128;
  m.g = o;   o += S * 2 * DV0_RS * 128;
  m.raw = o; o += S * DV0_RS * (size_t)(win ? (xf32 ? 528 : 272) : xf32 ? 4 * 128 : 0);
  m.st = o;  o += S * DV0_RS * 8;
  m.bar = o; o += 2 * S * 8;
  m.total = o + 1024;
  return m;
}

// Shared memory of the layer-0 input backward: W_0's slice (NB boxes of
// 128 rows x 128 bytes, NB = the 64-column boxes of pad16(H)), per stage g0
// (NB boxes of 64 rows), x (the swizzled bf16 layout, 2 boxes, or the raw
// windows), the rows' (mu, inv); the 8 warps' column sums; the barriers
// (full and empty per stage, W_0's).
struct L0Layout2 {
  size_t w, g, xa, st, red, bar, total;
};

__host__ __device__ inline L0Layout2 l0w_layout(int xm, int H) {
  const size_t S = l0_stages(xm), NB = (tail_pad16(H) + 63) / 64;
  L0Layout2 m;
  size_t o = 0;
  m.w = o;   o += NB * TAIL_KB * 128;
  m.g = o;   o += S * NB * L0_RS * 128;
  m.xa = o;  o += S * L0_RS * (size_t)(xm == XM_BF16 ? 256 : tail_win(xm));
  m.st = o;  o += S * L0_RS * 8;
  m.red = o; o += 8 * 2 * TAIL_KB * 4;
  m.bar = o; o += (2 * S + 1) * 8;
  m.total = o + 1024;
  return m;
}

// byte offset of element (r, c) of a bf16 stage in the swizzled layout: two
// boxes of 64 columns, rows of 128 bytes, 16-byte pieces XOR-ed with r % 8
__device__ __forceinline__ int swz(int rs, int r, int c) {
  return (c >> 6) * rs * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// byte offset, inside its aligned 16-byte piece, of element (row, k0) of x
__device__ __forceinline__ int win_off(const void* x, long long row, int d_in, int k0, int es) {
  return (int)(((unsigned long long)x + ((unsigned long long)row * d_in + k0) * es) & 15);
}

// elements 2 m, 2 m + 1 (m = 0 .. 3) of the 8 bf16 starting ``off`` bytes
// into a row window (off even), as the words of one uint4
__device__ __forceinline__ void win_bf16x8(const unsigned char* row, int off, uint32_t (&w)[4]) {
  const uint32_t* p = (const uint32_t*)row + (off >> 2);
  if (off & 2) {
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = __funnelshift_r(p[m], p[m + 1], 16);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = p[m];
  }
}

// One step's RS rows from row0 and the block's 128 columns from k0 of x into
// xa (XM_BF16: the swizzled layout) or as row windows, and the rows' (mu,
// inv) into st, zero past R (and past the end of x), by thread t of 128
// (cp.async)
template <int XM, int RS>
__device__ __forceinline__ void load_x_step(const void* x, long long R, int d_in,
                                            long long row0, int k0, const float* xstats,
                                            unsigned char* xa, unsigned char* st, int t) {
  if constexpr (XM == XM_BF16) {
    const bf16* xb = (const bf16*)x;
    const int c = t & 15, col = k0 + 8 * c;
#pragma unroll
    for (int q = 0; q < RS / 8; ++q) {
      const int r = (t >> 4) + 8 * q;
      const long long row = row0 + r;
      const bool ok = row < R && col < d_in;
      cp_async16z(xa + swz(RS, r, 8 * c), ok ? (const void*)(xb + row * d_in + col) : x, ok);
    }
  } else {
    constexpr int W = tail_win(XM), NQ = W / 16, ES = XM == XM_F32_WIN ? 4 : 2;
    const unsigned long long base = (unsigned long long)x;
    const unsigned long long end = base + (unsigned long long)R * d_in * ES;
    for (int i = t; i < RS * NQ; i += 128) {
      const int r = i / NQ, q = i - r * NQ;
      const long long row = row0 + r;
      const unsigned long long a0 = (base + ((unsigned long long)row * d_in + k0) * ES) & ~15ull;
      const unsigned long long src = a0 + 16ull * q;
      const int n = row < R && src < end ? (int)min(16ull, end - src) : 0;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(xa + r * W + 16 * q)),
                   "l"(n ? src : (base & ~15ull)), "r"(n)
                   : "memory");
    }
  }
  for (int r = t; r < RS; r += 128) {
    const long long row = row0 + r;
    cp_async8z(st + 8 * r, row < R ? (const void*)(xstats + 2 * row) : (const void*)xstats,
               row < R);
  }
}

// ---------------------------------------------------------------------------
// dV0: grid (passes x column blocks, splits); part[split] = this block's
// (128 x 128) part of dV0 over its split's rows (columns past d_in and H not
// written). Every operand comes by TMA: g0 (g0map), the rows' statistics
// (stmap, one dimension), and x where its rows are 16-byte aligned (xmap:
// bf16 into the operand's swizzled layout, transformed in place; f32 into a
// raw stage of the same layout). A TMA box must start on a 16-byte boundary,
// which rows 1,510 bf16 wide do not: there (WIN) xmap views x, from the
// 16-byte boundary at or before it (xoff elements), as rows of u rows of x,
// u the fewest that make a 16-byte multiple (4 at 1,510), and a box of 64 / u
// such rows, its columns from the boundary at or before j d_in + k0 and 8
// (f32: 4) columns wider, brings the windows of rows j, j + u, ... of the
// step (tail_win bytes each, read back at their offset). A step's rows then
// lie in shared memory in the order (j, g) -> row u g + j, and g0 comes
// through the same view of it; a sum over rows does not see the order. The
// last R % u rows (every row where R < u) are not in the views: the
// consumers read them from global memory themselves.
// ---------------------------------------------------------------------------
template <bool XF32, bool WIN>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
    dv0_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap g0map,
                     const __grid_constant__ CUtensorMap stmap, const void* x, long long R,
                     int d_in, int u, int xoff, const bf16* g0, int H, long long split_rows,
                     const float* fs, const float* fb, float* part) {
  constexpr int S = dv0_stages(XF32, WIN), BOX = DV0_RS * 128;
  constexpr int ES = XF32 ? 4 : 2, W = WIN ? (XF32 ? 528 : 272) : 0;
  constexpr int RAW = WIN ? DV0_RS * W : XF32 ? 4 * BOX : 0;  // bytes of a raw x stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      (unsigned char*)(((unsigned long long)smem_raw + 1023) & ~(unsigned long long)1023);
  const Dv0Layout m = dv0_layout(XF32, WIN);
  unsigned char* As = sm + m.a;    // [S][2 boxes][64 rows][128 B]
  unsigned char* Gs = sm + m.g;    // [S][2 boxes][64 rows][128 B]
  unsigned char* Raw = sm + m.raw; // [S][RAW]
  unsigned char* St = sm + m.st;   // [S][64][mu, inv]
  uint64_t* full = (uint64_t*)(sm + m.bar);
  uint64_t* empty = full + S;
  const int Hp = tail_pad16(H), P = (Hp + DV0_N - 1) / DV0_N;
  const int pass = blockIdx.x % P, k0 = (blockIdx.x / P) * TAIL_KB, n0 = pass * DV0_N;
  const long long r_begin = (long long)blockIdx.y * split_rows;
  const long long r_end = min(R, r_begin + split_rows);
  const int steps = r_end > r_begin ? (int)((r_end - r_begin + DV0_RS - 1) / DV0_RS) : 0;
  // the views hold rows [0, r_main) (WIN: u rows of x a row of the view)
  const long long r_main = R / u * u;
  const int gr = DV0_RS / u;  // rows of a view a box
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);   // the copies' expect_tx
      mbar_init(empty + s, 8);  // the consumers' warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  if (wg == 2) {
    // producer: one thread issues every copy, S steps ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + s, ((i / S) - 1) & 1);
        const long long row0 = r_begin + (long long)i * DV0_RS;
        const uint32_t xbytes = WIN ? DV0_RS * W : (XF32 ? 4 : 2) * BOX;
        mbar_arrive_tx(full + s, (r_main > 0 ? xbytes + 2 * BOX : 0) + DV0_RS * 8);
        if (r_main > 0) {
          const int c1 = (int)(row0 / u);
          for (int j = 0; j < u; ++j) {
            if (WIN) {  // the window: from the 16-byte boundary at or before the row's k0
              const int e0 = xoff + j * d_in + k0;
              tma_load_2d(Raw + s * RAW + j * gr * W, &xmap, full + s, e0 - e0 % (16 / ES), c1);
            } else {
              unsigned char* X = XF32 ? Raw + s * RAW : As + s * 2 * BOX;
              for (int b = 0; b < (XF32 ? 4 : 2); ++b)
                tma_load_2d(X + b * BOX, &xmap, full + s, k0 + (XF32 ? 32 : 64) * b, c1);
            }
            for (int b = 0; b < 2; ++b)
              tma_load_2d(Gs + (s * 2 + b) * BOX + j * gr * 128, &g0map, full + s,
                          j * Hp + n0 + 64 * b, c1);
          }
        }
        tma_load_1d(St + s * DV0_RS * 8, &stmap, full + s, (int)(2 * row0));
      }
    }
  } else {
    // consumers: warpgroup wg takes columns k0 + 64 wg .. + 64 of x. Each
    // step it writes its half of the operand (normalised, and in the affine
    // mode scaled, rounding step by step as the chunked forward does:
    // __fmul_rn, __fadd_rn) while the previous step's products run.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
    const bool affine = fs != nullptr, edge = k0 + TAIL_KB > d_in;
    // the thread's 4 pieces of a step: rows 16 ((t >> 3) & 3) + (t >> 5) + 4 q
    // of the stage (step row relq[q]), columns cw .. cw + 7 of the block; a
    // window's byte offq[q]. A warp's rows lie in the four quarters of the
    // stage, which at 1,510 columns are the four views' windows, each at its
    // own 4-byte offset: so its 32-bit reads of the windows meet no bank
    // conflict
    constexpr int NQ = DV0_RS / 16;
    const int cw = 64 * wg + 8 * (t & 7);
    float fsv[8], fbv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + cw + e;
      fsv[e] = affine && k < d_in ? fs[k] : 0.f;
      fbv[e] = affine && k < d_in ? fb[k] : 0.f;
    }
    int relq[NQ], offq[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = 16 * ((t >> 3) & 3) + (t >> 5) + 4 * q;
      relq[q] = (r % gr) * u + r / gr;
      offq[q] = WIN ? (xoff + r / gr * d_in + k0) * ES % 16 + ES * cw : 0;
    }
    float acc[64], sum[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = sum[q] = 0.f;
    // chunks of DV0_FLUSH steps (512 rows): within one the products of a
    // step run while the next step is written (one wgmma group in flight);
    // after one the registers are added into the f32 sums (round to
    // nearest) and the next chunk's products start them afresh
    for (int i0 = 0; i0 < steps; i0 += DV0_FLUSH) {
      const int i1 = min(steps, i0 + DV0_FLUSH);
      for (int i = i0; i < i1; ++i) {
        const int s = i % S;
        mbar_wait(full + s, (i / S) & 1);
        unsigned char* A = As + s * 2 * BOX;
        const unsigned char* raw = Raw + s * RAW;
        const float2* st = (const float2*)(St + s * DV0_RS * 8);
        const long long row0 = r_begin + (long long)i * DV0_RS;
        if (row0 + DV0_RS > r_main && row0 < R) {
          // g0's rows that the views do not hold, from global memory (zero
          // past R; every row where the views are empty): this warpgroup's
          // half of the step's rows, both warpgroups' barrier below
          const int lo = (int)max(0LL, r_main - row0);
          const int hi = r_main > 0 ? (int)min((long long)DV0_RS, R - row0) : DV0_RS;
          for (int e = threadIdx.x; e < (hi - lo) * 128; e += 256) {
            const int rel = lo + e / 128, col = e % 128;
            const long long row = row0 + rel;
            *(bf16*)(Gs + s * 2 * BOX + swz(DV0_RS, (rel % u) * gr + rel / u, col)) =
                row < R && n0 + col < Hp ? g0[row * Hp + n0 + col] : __float2bfloat16(0.f);
          }
          fence_proxy_async();
          asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
        // every load of the thread's pieces first, then the arithmetic, then
        // every store (the stores may not pass the loads of a later piece)
        float v[NQ][8];
        float2 ms[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = 16 * ((t >> 3) & 3) + (t >> 5) + 4 * q, rel = relq[q];
          ms[q] = st[rel];
          if (WIN) {
            const long long row = row0 + rel;
            if (row >= R) {
#pragma unroll
              for (int e = 0; e < 8; ++e) v[q][e] = 0.f;
            } else if (row >= r_main) {  // not in the views: from global memory
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int k = k0 + cw + e;
                v[q][e] = k >= d_in ? 0.f
                          : XF32 ? ((const float*)x)[row * d_in + k]
                                 : __bfloat162float(((const bf16*)x)[row * d_in + k]);
              }
            } else {
              const unsigned char* w0 = raw + r * W;
              if (XF32) {
                const float* p = (const float*)w0 + (offq[q] >> 2);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[q][e] = p[e];
              } else {
                uint32_t w[4];
                win_bf16x8(w0, offq[q], w);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  v[q][2 * e] = __uint_as_float(w[e] << 16);
                  v[q][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
                }
              }
            }
          } else if (XF32) {
            const int cc = cw >> 3;  // the piece's 8 columns: 16-byte pieces 2 cc, 2 cc + 1
            const unsigned char* rr = raw + (cc >> 2) * BOX + r * 128;
            const float4 a = *(const float4*)(rr + ((((2 * cc) & 7) ^ (r & 7)) << 4));
            const float4 b = *(const float4*)(rr + ((((2 * cc + 1) & 7) ^ (r & 7)) << 4));
            v[q][0] = a.x, v[q][1] = a.y, v[q][2] = a.z, v[q][3] = a.w;
            v[q][4] = b.x, v[q][5] = b.y, v[q][6] = b.z, v[q][7] = b.w;
          } else {
            const uint4 w4 = *(const uint4*)(A + swz(DV0_RS, r, cw));
            const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              v[q][2 * e] = __uint_as_float(w[e] << 16);
              v[q][2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float y[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int ee = 2 * e + h;
              y[h] = (v[q][ee] - ms[q].x) * ms[q].y;
              if (affine) y[h] = __fadd_rn(__fmul_rn(y[h], fsv[ee]), fbv[ee]);
              if (edge && k0 + cw + ee >= d_in) y[h] = 0.f;
            }
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(y[0], y[1]);
            w[e] = *reinterpret_cast<const uint32_t*>(&b2);
          }
          *(uint4*)(A + swz(DV0_RS, 16 * ((t >> 3) & 3) + (t >> 5) + 4 * q, cw)) = make_uint4(w[0], w[1], w[2], w[3]);
        }
        // the warpgroup's half written, for the tensor cores (async proxy)
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
        const uint64_t da = sw128_desc(As + (s * 2 + wg) * BOX, BOX, 1024);
        const uint64_t db = sw128_desc(Gs + s * 2 * BOX, BOX, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DV0_RS / 16; ++kk)
          wgmma_m64n128<1, 1>(acc, da + kk * (2048 >> 4), db + kk * (2048 >> 4), kk > 0 || i > i0);
        wgmma_commit();
        if (i > i0) {  // the previous step's products are done: free its stage
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + (i - 1) % S);
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (i1 - 1) % S);
#pragma unroll
      for (int q = 0; q < 64; ++q) sum[q] = i0 == 0 ? acc[q] : sum[q] + acc[q];
    }
    // sum[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h (x's column), column
    // 8 j + 2 (lane % 4) + e (g0's)
    const int warp = t >> 5;
    float* out = part + (long long)blockIdx.y * d_in * H;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
        const int n = n0 + 8 * j + 2 * (lane & 3);
        if (k >= d_in || n >= H) continue;
        float* p = out + (long long)k * H + n;
        if ((H & 1) == 0) {
          *reinterpret_cast<float2*>(p) =
              make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
        } else {
          p[0] = sum[4 * j + 2 * h];
          if (n + 1 < H) p[1] = sum[4 * j + 2 * h + 1];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// layer-0 input backward without dx: grid (column blocks, splits);
// slots[split] = [dfs (d_in), dfb (d_in)] over the split's rows.
// ---------------------------------------------------------------------------
template <int XM>
__global__ void __launch_bounds__(TAIL_THREADS, 1)
    layer0_input_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap g0map,
                                  const __grid_constant__ CUtensorMap w0map, const void* x,
                                  long long R, int d_in, const float* xstats, int H,
                                  long long split_rows, float* slots) {
  constexpr int S = l0_stages(XM), W = XM == XM_BF16 ? 256 : tail_win(XM);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      (unsigned char*)(((unsigned long long)smem_raw + 1023) & ~(unsigned long long)1023);
  const L0Layout2 m = l0w_layout(XM, H);
  const int Hp = tail_pad16(H), NB = (Hp + 63) / 64;
  unsigned char* Ws = sm + m.w;   // [NB][128 rows of W_0][128 B]
  unsigned char* Gs = sm + m.g;   // [S][NB][64 rows][128 B]
  unsigned char* Xa = sm + m.xa;  // [S][64 rows x W B]: swizzled bf16, or windows
  unsigned char* St = sm + m.st;  // [S][64][mu, inv]
  float* red = (float*)(sm + m.red);
  uint64_t* full = (uint64_t*)(sm + m.bar);
  uint64_t* empty = full + S;
  uint64_t* wbar = empty + S;
  const int k0 = blockIdx.x * TAIL_KB;
  const long long r_begin = (long long)blockIdx.y * split_rows;
  const long long r_end = min(R, r_begin + split_rows);
  const int steps = r_end > r_begin ? (int)((r_end - r_begin + L0_RS - 1) / L0_RS) : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 129);  // the TMA's expect_tx and the 128 copying threads
      mbar_init(empty + s, 4);  // the consuming warpgroup's warps
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, lane = t & 31;
  if (wg == 2) {
    if (t == 0) {
      mbar_arrive_tx(wbar, NB * TAIL_KB * 128);
      for (int b = 0; b < NB; ++b)
        tma_load_2d(Ws + b * TAIL_KB * 128, &w0map, wbar, 64 * b, k0);
    }
    for (int i = 0; i < steps; ++i) {
      const int s = i % S;
      if (i >= S) mbar_wait(empty + s, ((i / S) - 1) & 1);
      const long long row0 = r_begin + (long long)i * L0_RS;
      if (t == 0) {
        mbar_arrive_tx(full + s, NB * L0_RS * 128);
        for (int b = 0; b < NB; ++b)
          tma_load_2d(Gs + (s * NB + b) * L0_RS * 128, &g0map, full + s, 64 * b, (int)row0);
      }
      load_x_step<XM, L0_RS>(x, R, d_in, row0, k0, xstats, Xa + s * L0_RS * W,
                             St + s * L0_RS * 8, t);
      cp_async_arrive(full + s);  // once this thread's copies of the step have landed
    }
    return;
  }
  // consumers: warpgroup wg takes steps wg, wg + 2, ...; acc[4 j + 2 h + e]
  // is g_prev at row 16 warp + lane / 4 + 8 h of the step, column 8 j +
  // 2 (lane % 4) + e of the block
  const int warp = t >> 5;
  float acc[64], dfs[32], dfb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dfs[i] = dfb[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(wbar, 0);
  const int ksteps = Hp / 16;
  for (int i = wg; i < steps; i += 2) {
    const int s = i % S;
    mbar_wait(full + s, (i / S) & 1);
    const unsigned char* G = Gs + s * NB * L0_RS * 128;
    acc_fence(acc);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const int b = kk >> 2, ko = (kk & 3) * 32;
      const uint64_t da = sw128_desc(G + b * L0_RS * 128 + ko, 16, 1024);
      const uint64_t db = sw128_desc(Ws + b * TAIL_KB * 128 + ko, 16, 1024);
      wgmma_m64n128<0, 0>(acc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
    const unsigned char* xs = Xa + s * L0_RS * W;
    const float2* st = (const float2*)(St + s * L0_RS * 8);
    const long long row0 = r_begin + (long long)i * L0_RS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      const float2 ms = st[r];
      const int off = XM == XM_BF16 ? 0 : win_off(x, row0 + r, d_in, k0, XM == XM_F32_WIN ? 4 : 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        float x0, x1;
        if (XM == XM_F32_WIN) {
          const float* p = (const float*)(xs + r * W + off) + c;
          x0 = p[0];
          x1 = p[1];
        } else {
          uint32_t u;
          if (XM == XM_BF16) {
            u = *(const uint32_t*)(xs + swz(L0_RS, r, c));
          } else {
            const uint32_t* p = (const uint32_t*)(xs + r * W) + ((off + 2 * c) >> 2);
            u = (off & 2) ? __funnelshift_r(p[0], p[1], 16) : p[0];
          }
          x0 = __uint_as_float(u << 16);
          x1 = __uint_as_float(u & 0xffff0000u);
        }
        const float g0v = acc[4 * j + 2 * h], g1v = acc[4 * j + 2 * h + 1];
        dfs[2 * j] += g0v * ((x0 - ms.x) * ms.y);
        dfs[2 * j + 1] += g1v * ((x1 - ms.x) * ms.y);
        dfb[2 * j] += g0v;
        dfb[2 * j + 1] += g1v;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  // over the warp's rows (lanes with one lane % 4), then the 8 warps in order
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      dfs[i] += __shfl_xor_sync(0xffffffffu, dfs[i], o);
      dfb[i] += __shfl_xor_sync(0xffffffffu, dfb[i], o);
    }
  const int wid = wg * 4 + warp;
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * lane + e;
        red[wid * 2 * TAIL_KB + c] = dfs[2 * j + e];
        red[wid * 2 * TAIL_KB + TAIL_KB + c] = dfb[2 * j + e];
      }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the consumers only
  const int i = threadIdx.x, c = i & (TAIL_KB - 1), which = i >> 7;
  float v = 0.f;
  for (int w = 0; w < 8; ++w) v += red[w * 2 * TAIL_KB + which * TAIL_KB + c];
  if (k0 + c < d_in) slots[(long long)blockIdx.y * 2 * d_in + which * d_in + k0 + c] = v;
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps (cuTensorMapEncodeTiled from libcuda, which
// the CUDA runtime has loaded), the copy mode of x, the launches.
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// a (rows x cols) row-major matrix of ``es``-byte elements (bf16 or f32) at
// p (16-byte aligned, a stride of ``stride`` bytes, a multiple of 16), boxes
// of box_cols x box_rows in the 128-byte swizzle (box_cols es = 128) or
// unswizzled (``swizzle`` false), or with one dimension (rows 0) boxes of
// box_cols; zeros outside it. A box must start on a 16-byte boundary of
// its row. False where it cannot be encoded.
static bool tiled_map(CUtensorMap* map, int es, const void* p, long long rows, long long cols,
                      long long stride, int box_cols, int box_rows, bool swizzle = true) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || ((unsigned long long)p & 15) || stride % 16 || rows >= (1LL << 31) ||
      cols >= (1LL << 32))
    return false;
  const CUtensorMapDataType dt =
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, rows > 0 ? 2 : 1, const_cast<void*>(p), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            rows > 0 && swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static bool bf16_map(CUtensorMap* map, const void* p, long long rows, int cols, int box_rows) {
  return tiled_map(map, 2, p, rows, cols, 2LL * cols, 64, box_rows);
}

static int x_mode(const void* x, int x_bf16, int d_in) {
  if (!x_bf16) return XM_F32_WIN;
  return (unsigned long long)x % 16 == 0 && d_in % 8 == 0 ? XM_BF16 : XM_BF16_WIN;
}

// x's rows come by TMA where their pointer and stride are 16-byte aligned,
// else as windows
static bool dv0_window(const void* x, int x_bf16, int d_in) {
  return (unsigned long long)x % 16 || (long long)d_in * (x_bf16 ? 2 : 4) % 16;
}

extern "C" unsigned long long dcc_dv0_wgmma_smem_bytes(int x_bf16, int window) {
  return dv0_layout(x_bf16 == 0, window != 0).total;
}

extern "C" unsigned long long dcc_layer0_input_bwd_wgmma_smem_bytes(int xmode, int H) {
  return l0w_layout(xmode, H).total;
}

template <int XM>
static int launch_l0(const CUtensorMap& g0map, const CUtensorMap& w0map, dim3 grid,
                     const void* x, long long R, int d_in, const float* xstats, int H,
                     long long split_rows, float* slots, cudaStream_t s) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(layer0_input_bwd_wgmma_kernel<XM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    set = true;
  }
  layer0_input_bwd_wgmma_kernel<XM><<<grid, TAIL_THREADS, l0w_layout(XM, H).total, s>>>(
      g0map, w0map, x, R, d_in, xstats, H, split_rows, slots);
  return (int)cudaGetLastError();
}

// dV0 = bf16((x - mu) * inv)^T g0 over R rows (d_in x H f32 into out), or
// with fs and fb given (not null) bf16((x - mu) * inv * fs + fb)^T g0:
// dv0_wgmma_kernel on n_splits row splits into part (n_splits x d_in x H
// scratch), then the splits summed in order. g0: R x pad16(H) bf16, xstats
// R x 2 f32, both 16-byte aligned.
extern "C" int dcc_dv0_wgmma(const void* x, int x_bf16, long long R, int d_in,
                             const float* xstats, const void* g0, int H, int n_splits,
                             const float* fs, const float* fb, float* part, float* out,
                             void* stream) {
  if (H < 1 || n_splits < 1 || d_in < 1 || R < 1 || (fs == nullptr) != (fb == nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = x_bf16 ? 2 : 4, Hp = tail_pad16(H);
  const bool win = dv0_window(x, x_bf16, d_in), xf32 = !x_bf16;
  // windows: a row of the views holds u rows of x, the fewest that make its
  // stride a multiple of 16 bytes, from the 16-byte boundary at or before x
  int u = 1;
  while (win && (long long)u * d_in * es % 16) u *= 2;
  const unsigned long long xa = (unsigned long long)x;
  const int xoff = (int)(xa & 15) / es;
  const long long vrows = R / u > 0 ? R / u : 1;  // not read where R < u
  CUtensorMap xmap, g0map, stmap;
  const bool mapped =
      win ? tiled_map(&xmap, es, (const void*)(xa & ~15ull), vrows, (long long)u * d_in + xoff,
                      (long long)u * d_in * es, (x_bf16 ? 272 : 528) / es, DV0_RS / u, false)
          : tiled_map(&xmap, es, x, R, d_in, (long long)d_in * es, x_bf16 ? 64 : 32, DV0_RS);
  if (!mapped ||
      !tiled_map(&g0map, 2, g0, vrows, (long long)u * Hp, 2LL * u * Hp, 64, DV0_RS / u) ||
      !tiled_map(&stmap, 4, xstats, 0, 2 * R, 0, 2 * DV0_RS, 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long split_rows =
      ((R + n_splits - 1) / n_splits + DV0_RS - 1) / DV0_RS * DV0_RS;
  const int P = (Hp + DV0_N - 1) / DV0_N;
  const dim3 grid(P * ((d_in + TAIL_KB - 1) / TAIL_KB), n_splits);
  const size_t smem = dv0_layout(xf32, win).total;
  static bool set[4] = {false, false, false, false};
  auto kernel = xf32 ? (win ? dv0_wgmma_kernel<true, true> : dv0_wgmma_kernel<true, false>)
                     : (win ? dv0_wgmma_kernel<false, true> : dv0_wgmma_kernel<false, false>);
  if (!set[2 * xf32 + win]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    set[2 * xf32 + win] = true;
  }
  kernel<<<grid, TAIL_THREADS, smem, s>>>(xmap, g0map, stmap, x, R, d_in, u, xoff,
                                          (const bf16*)g0, H, split_rows, fs, fb, part);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return reduce(part, n_splits, (long long)d_in * H, out, s);
}

// The feature norm's [dfs, dfb] (2 d_in f32 into out) below layer 0's bf16
// cotangent g0 (R x pad16(H), H <= 256) and the bf16 W_0 w0 (pad16(d_in) x
// pad16(H)): layer0_input_bwd_wgmma_kernel on n_splits row splits into
// slots (n_splits x 2 d_in scratch), then the splits summed in order.
extern "C" int dcc_layer0_input_bwd_wgmma(const void* x, int x_bf16, long long R, int d_in,
                                          const float* xstats, const void* g0, int H,
                                          const void* w0, int n_splits, float* slots,
                                          float* out, void* stream) {
  if (H < 1 || tail_pad16(H) > L0_HMAX || n_splits < 1 || d_in < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap g0map, w0map;
  if (!bf16_map(&g0map, g0, R, tail_pad16(H), L0_RS) ||
      !bf16_map(&w0map, w0, tail_pad16(d_in), tail_pad16(H), TAIL_KB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long split_rows = ((R + n_splits - 1) / n_splits + L0_RS - 1) / L0_RS * L0_RS;
  const dim3 grid((d_in + TAIL_KB - 1) / TAIL_KB, n_splits);
  int err;
  switch (x_mode(x, x_bf16, d_in)) {
    case XM_BF16:
      err = launch_l0<XM_BF16>(g0map, w0map, grid, x, R, d_in, xstats, H, split_rows, slots, s);
      break;
    case XM_BF16_WIN:
      err = launch_l0<XM_BF16_WIN>(g0map, w0map, grid, x, R, d_in, xstats, H, split_rows,
                                   slots, s);
      break;
    default:
      err = launch_l0<XM_F32_WIN>(g0map, w0map, grid, x, R, d_in, xstats, H, split_rows,
                                  slots, s);
  }
  if (err) return err;
  return reduce(slots, n_splits, 2LL * d_in, out, s);
}

extern "C" const char* dcc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
