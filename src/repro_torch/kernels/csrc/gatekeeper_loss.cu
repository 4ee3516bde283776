// Fused Gatekeeper-loss statistics for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `gatekeeper_loss_tokens`
// (src/repro/kernels/gatekeeper_loss.py). For hidden states x [T, d] (fp32
// or bf16), the unembedding table [V, d] (fp32) and targets [T] int32 it
// returns per token, without ever holding the [T, V] logits in memory:
//
//   ce      = lse - l[target]
//   kl      = log V - H
//   correct = (first argmax of l == target)
//   entropy H = lse - w / s
//   lse     = m + log s          (kept for the backward pass)
//
// from the online max m, s = sum e^{l-m} and w = sum e^{l-m} * l.
//
// Bound on the card: the logits GEMM, 2*T*V*d flop (7.8e11 at T = d = 2048,
// V = 92544), against one read of the 758 MB table (0.23 ms). fp32 has no
// full-precision tensor-core form and the SIMT cores give 67 TFLOP/s
// (11.6 ms there). TF32 keeps 10 mantissa bits, and one TF32 product
// misses the 1e-3 the loss is held to (tests/test_torch_loss_tf32.py pins
// it), so each fp32 operand v is split into hi, v rounded to TF32 to
// nearest (`split_tf32`: its low 13 bits are zero, so the tensor cores read
// it exactly), and lo = v - hi, which they truncate to TF32; each logit is
// the TF32 products lo.hi + hi.lo + hi.hi with fp32 accumulation, about 21
// of fp32's 24 bits, at a third of the 495 TFLOP/s dense TF32 rate. A bf16
// x (the main path's type: fp32 weights, bf16 activations) is exact in
// TF32: its lo is exactly zero and the lo.hi product adds exactly nothing,
// so the kernels read x as bf16 and skip that product (two products, half
// the TF32 rate), with the bits of the three-product sum. The tensor cores
// add a product's terms to its accumulator with truncation, a bias of up
// to a unit in the accumulator's last place a product: chained over d (288
// products at d 768) that read 5.5e-4 at logits of std 16 on the card, so
// the products of every 4 k8 steps (2 in the mma.sync kernel) go to a
// fresh accumulator, which an fp32 add (rounded to nearest) takes into the
// running sum. Bound by operations at the main paths' shapes, by the
// table's bytes where few rows are left (the VLM's 24 loss rows, whisper's
// 128 tokens).
//
// Each call launches two kernels, a partial kernel then the merge. The
// partial kernel is one of two, by the tokens of a CTA (the wrapper's
// `token_tile`):
//   * T > 64: `gk_partial_wg_kernel`, 128 tokens a CTA, two warpgroups of
//     64 tokens by the tile's 128 vocabulary columns, `wgmma.m64n128k8`
//     TF32 products. x (A) comes from registers: each thread loads its
//     fragment from a padded x tile (a bf16 value widened exactly by a
//     shift). The table tile (B) is read by the tensor cores from shared
//     memory, K-major in the 128-byte swizzle: `cp.async` lands each row's
//     16-byte chunk c at chunk c ^ (row & 7), and once a stage has landed
//     the CTA splits it element-wise, hi in place and lo into a second
//     buffer, a stage ahead of its products, so the split of stage s + 1
//     runs while stage s's products do. x and table tiles 32 deep go
//     through a ring of 4 stages, one barrier a stage; the ring runs on
//     across tile boundaries. One CTA an SM (133 or 169 KB of shared
//     memory, about 220 registers a thread).
//   * T <= 64: `gk_partial_kernel`, 32 or 64 tokens a CTA, `mma.sync
//     .m16n8k8` TF32 products, two CTAs an SM. Warps are laid out BM/32 x
//     8/(BM/32): each owns 32 tokens and 16 or 32 columns as m16n8
//     fragments. A k8 step takes dims (2 tq, 2 tq + 1) for k indices (tq,
//     tq + 4), in x and the table alike, so a lane reads its two elements
//     of a row as one float2 (fp32) or one bf16 pair; rows are padded to 40
//     elements so these reads fall on distinct banks. x's split is made
//     once per warp and k step, the table's once per n8 tile.
//   Both fold each finished [tokens x 128] tile into per-row running (m, s,
//   w, first argmax), each lane for its rows over its columns, walked in
//   increasing order with a strict '>' so the first index of the maximum
//   is kept (`fold_row`); the lane that owns the target's column writes its
//   logit to shared memory. At the end of the split the 4 lanes of a row
//   merge with xor shuffles 1 and 2 (the mma.sync kernel then merges the
//   warps that share a row, in warp order; equal maxima keep the lower
//   index) and one partial per (token, split) is written.
//   * The merge kernel: one warp a token; lane l folds splits l, l + 32,
//     ... in order, then the lanes merge by xor shuffles 16, 8, 4, 2, 1;
//     ties keep the lower index, so the argmax is the first in the
//     vocabulary, as in JAX. No atomics and fixed orders: two calls give
//     the same bits.
//
// The TPU grid walks the vocabulary in order for each token block. Here
// the vocabulary is split across CTAs as well (`vocab_split` in the
// wrapper picks the split whose waves of CTAs finish first). blockIdx.x
// runs over token blocks, so the CTAs of one vocabulary split run side by
// side and share its table slice through the 50 MB L2. Token, vocabulary
// and depth tails are zero-filled by the copies and masked in the
// epilogue (no padding to a tile in memory); d must be a multiple of 4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // vocabulary columns per tile
constexpr int BK = 32;        // depth of one ring stage
constexpr int RS = BK + 8;    // staged row stride (elements): bank-spread
constexpr int THREADS = 256;  // 8 warps
constexpr float NEG = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

// the mma.sync kernel's tiles (BM 32 or 64 tokens a CTA, two CTAs an SM)
template <int BM, bool XB> struct Tile {
  static constexpr int WARPS_M = BM / 32;        // 32 tokens a warp
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;        // columns a warp
  static constexpr int NT = WN / 8;              // n8 tiles a warp
  static constexpr int X_STAGE = BM * RS * (XB ? 2 : 4);   // bytes
  static constexpr int T_STAGE = BN * RS * 4;
  static constexpr int STAGE = X_STAGE + T_STAGE;
  static constexpr int NST = 4 * STAGE <= 110 * 1024 ? 4 : 3;  // < 113 KB
  static constexpr size_t bytes = (size_t)NST * STAGE;
};

// k8 steps whose products one fresh accumulator sums before an fp32 add
// takes it into the running sum (the mma.sync kernel; 4 spills its 128
// registers)
constexpr int G = 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's newest groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b, the same product into a fresh accumulator
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// v -> TF32 operands hi and lo. hi is v rounded to TF32 (10 mantissa
// bits) to nearest, ties away from zero (the bits `cvt.rna.tf32.f32` gives
// for a finite v) by an integer add and a mask; its low 13 bits are zero,
// so the tensor cores read it as it is. lo = v - hi is exact in fp32; the
// tensor cores read its top 19 bits.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void merge_stats(float& m, float& s, float& w,
                                            int& idx, float m2, float s2,
                                            float w2, int idx2) {
  const float mn = fmaxf(m, m2);
  const float a = expf(m - mn), b = expf(m2 - mn);
  s = s * a + s2 * b;
  w = w * a + w2 * b;
  if (m2 > m || (m2 == m && idx2 < idx)) idx = idx2;
  m = mn;
}

// fold one row's finished logits v into its running (m, s, w, first
// argmax); v[j] is column c0 + 8 (j >> 1) + (j & 1), so the columns are
// walked in increasing order and a strict '>' keeps the first index of the
// maximum. Columns past V are masked; the lane that owns the target's
// column writes its logit to *tl.
template <int N>
__device__ __forceinline__ void fold_row(const float (&v)[N], int c0, int V,
                                         int tg, float* tl, float& m,
                                         float& s, float& w, int& idx) {
  float bm = NEG;
  int bi = NO_INDEX;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int col = c0 + 8 * (j >> 1) + (j & 1);
    if (col < V && v[j] > bm) { bm = v[j]; bi = col; }
    if (col == tg) *tl = v[j];
  }
  const float mn = fmaxf(m, bm);
  float ss = 0.f, ww = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (c0 + 8 * (j >> 1) + (j & 1) < V) {
      const float p = __expf(v[j] - mn);
      ss += p;
      ww = fmaf(p, v[j], ww);
    }
  }
  const float sc = __expf(m - mn);
  s = fmaf(s, sc, ss);
  w = fmaf(w, sc, ww);
  if (bm > m) idx = bi;
  m = mn;
}

// rows r0 .. r0+ROWS-1, depth k0 .. k0+BK-1 of a [n_rows, d] matrix of
// ESZ-byte elements -> dst [ROWS][STRIDE]; four elements a copy (16 bytes of
// fp32, 8 of bf16), rows past n_rows and columns past d zero-filled
template <int ROWS, int ESZ, int STRIDE = RS>
__device__ __forceinline__ void load_tile(unsigned char* __restrict__ dst,
                                          const unsigned char* __restrict__ src,
                                          int r0, int n_rows, int k0, int d) {
  constexpr int CPR = BK / 4;               // copies a row
  static_assert(ROWS * CPR % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CPR / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r0 + r < n_rows && k0 + c < d;
    const unsigned char* s =
        ok ? src + ((size_t)(r0 + r) * d + k0 + c) * ESZ : src;
    unsigned char* p = dst + (r * STRIDE + c) * ESZ;
    if constexpr (ESZ == 4) {
      cp_async16(p, s, ok ? 16 : 0);
    } else {
      cp_async8(p, s, ok ? 8 : 0);
    }
  }
}

// grid (ceil(T / BM), n_splits), block THREADS, dynamic smem
// Tile<BM, XB>::bytes. CTA (b, sp) takes tokens b*BM .. and vocabulary
// tiles sp*tiles_per_split .. of 128 columns; x is bf16 when XB. Writes
// the partial (m, s, w, argmax, target logit) of each of its tokens at
// [t * n_splits + sp].
template <int BM, bool XB>
__global__ void __launch_bounds__(THREADS, 2)
gk_partial_kernel(const void* __restrict__ x, const float* __restrict__ table,
                  const int* __restrict__ targets, int T, int V, int d,
                  int tiles_per_split, int n_splits, float* __restrict__ pm,
                  float* __restrict__ ps, float* __restrict__ pw,
                  int* __restrict__ pidx, float* __restrict__ ptl) {
  using L = Tile<BM, XB>;
  constexpr int NT = L::NT, WN = L::WN, WARPS_N = L::WARPS_N;
  constexpr int NST = L::NST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red_m[WARPS_N][BM], red_s[WARPS_N][BM], red_w[WARPS_N][BM];
  __shared__ int red_i[WARPS_N][BM];
  __shared__ float tl_s[BM];
  __shared__ int tgt_s[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;   // fragment row, column pair
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int t0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int v_begin = split * tiles_per_split * BN;
  const int v_end = min(V, v_begin + tiles_per_split * BN);
  const int n_tiles = (v_end - v_begin + BN - 1) / BN;
  const int n_ks = (d + BK - 1) / BK;       // ring stages a tile
  const int n_steps = n_tiles * n_ks;
  const unsigned char* xb = static_cast<const unsigned char*>(x);
  const unsigned char* tb = reinterpret_cast<const unsigned char*>(table);

  if (tid < BM) {
    tgt_s[tid] = t0 + tid < T ? targets[t0 + tid] : -1;
    tl_s[tid] = 0.f;
  }

  // step s (tile s / n_ks, depth stage s % n_ks) -> ring stage s % NST, one
  // commit group a step (empty past the last)
  auto load_step = [&](int s) {
    if (s < n_steps) {
      unsigned char* st = smem_raw + (size_t)(s % NST) * L::STAGE;
      const int k0 = (s % n_ks) * BK;
      load_tile<BM, XB ? 2 : 4>(st, xb, t0, T, k0, d);
      load_tile<BN, 4>(st + L::X_STAGE, tb, v_begin + (s / n_ks) * BN, V, k0,
                       d);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) load_step(s);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // running statistics of rows wm*32 + mt*16 + g + 8*h, i = 2 mt + h
  float m[4], s[4], w[4];
  int idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG; s[i] = 0.f; w[i] = 0.f; idx[i] = NO_INDEX;
  }

  for (int step = 0; step < n_steps; ++step) {
    // step `step` has landed for every thread, and every warp is done
    // with step - 1, whose ring stage takes step + NST - 1
    cp_async_wait<NST - 2>();
    __syncthreads();
    load_step(step + NST - 1);
    const unsigned char* st = smem_raw + (size_t)(step % NST) * L::STAGE;
    const float* ts = reinterpret_cast<const float*>(st + L::X_STAGE);

#pragma unroll
    for (int k0 = 0; k0 < BK / 8; k0 += G) {
      // x fragments of k8 steps k0 .. k0 + G - 1
      unsigned ah[G][2][4], al[G][2][4];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = wm * 32 + mt * 16 + g, kc = 8 * (k0 + j);
          if constexpr (XB) {
            // a bf16 pair (dims 2 tq, 2 tq + 1) widened exactly; lo = 0
            const unsigned* xw = reinterpret_cast<const unsigned*>(st);
            const unsigned p0 = xw[(row * RS + kc) / 2 + tq];
            const unsigned p1 = xw[((row + 8) * RS + kc) / 2 + tq];
            ah[j][mt][0] = p0 << 16;
            ah[j][mt][1] = p1 << 16;
            ah[j][mt][2] = p0 & 0xffff0000u;
            ah[j][mt][3] = p1 & 0xffff0000u;
          } else {
            const float* xs = reinterpret_cast<const float*>(st);
            const float2 v0 = *reinterpret_cast<const float2*>(
                xs + row * RS + kc + 2 * tq);
            const float2 v1 = *reinterpret_cast<const float2*>(
                xs + (row + 8) * RS + kc + 2 * tq);
            split_tf32(v0.x, ah[j][mt][0], al[j][mt][0]);
            split_tf32(v1.x, ah[j][mt][1], al[j][mt][1]);
            split_tf32(v0.y, ah[j][mt][2], al[j][mt][2]);
            split_tf32(v1.y, ah[j][mt][3], al[j][mt][3]);
          }
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned bh[G][2], bl[G][2];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              ts + (wn * WN + nt * 8 + g) * RS + 8 * (k0 + j) + 2 * tq);
          split_tf32(b.x, bh[j][0], bl[j][0]);
          split_tf32(b.y, bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // the G k8 steps' products into a fresh accumulator, the small
          // ones first (lo.hi: x's lo, absent for bf16; hi.lo), then
          // hi.hi; an fp32 add (rounded to nearest) takes it into the sum
          float p[4];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            if constexpr (!XB) {
              if (j == 0) {
                mma_tf32_new(p, al[j][mt], bh[j][0], bh[j][1]);
              } else {
                mma_tf32(p, al[j][mt], bh[j][0], bh[j][1]);
              }
              mma_tf32(p, ah[j][mt], bl[j][0], bl[j][1]);
            } else if (j == 0) {
              mma_tf32_new(p, ah[j][mt], bl[j][0], bl[j][1]);
            } else {
              mma_tf32(p, ah[j][mt], bl[j][0], bl[j][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < G; ++j)
            mma_tf32(p, ah[j][mt], bh[j][0], bh[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += p[e];
        }
      }
    }

    if (step % n_ks == n_ks - 1) {
      // fold the finished tile into the running row statistics; element
      // e of a fragment is row g + 8 (e >> 1), column 2 tq + (e & 1)
      const int c0 = v_begin + (step / n_ks) * BN + wn * WN + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          float v[2 * NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            v[2 * nt] = acc[mt][nt][2 * h];
            v[2 * nt + 1] = acc[mt][nt][2 * h + 1];
          }
          const int i = 2 * mt + h;
          fold_row(v, c0, V, tgt_s[r], &tl_s[r], m[i], s[i], w[i], idx[i]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none in flight

  // the 4 lanes of a row, then the warps that share it, in a fixed order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, w[i], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx[i], off);
      merge_stats(m[i], s[i], w[i], idx[i], m2, s2, w2, i2);
    }
    if (tq == 0) {
      const int r = wm * 32 + (i >> 1) * 16 + g + 8 * (i & 1);
      red_m[wn][r] = m[i];
      red_s[wn][r] = s[i];
      red_w[wn][r] = w[i];
      red_i[wn][r] = idx[i];
    }
  }
  __syncthreads();
  if (tid < BM && t0 + tid < T) {
    float mm = red_m[0][tid], sm = red_s[0][tid], wsum = red_w[0][tid];
    int im = red_i[0][tid];
#pragma unroll
    for (int k = 1; k < WARPS_N; ++k)
      merge_stats(mm, sm, wsum, im, red_m[k][tid], red_s[k][tid],
                  red_w[k][tid], red_i[k][tid]);
    const size_t o = (size_t)(t0 + tid) * n_splits + split;
    pm[o] = mm;
    ps[o] = sm;
    pw[o] = wsum;
    pidx[o] = im;
    ptl[o] = tl_s[tid];
  }
}

// ---------------------------------------------------------------------------
// 128-token tiles: warpgroup products (wgmma)
// ---------------------------------------------------------------------------

constexpr int WG_XRS = BK + 4;  // x row stride (elements): bank-spread reads

template <bool XB> struct WgTile {
  static constexpr int X_STAGE = 128 * WG_XRS * (XB ? 2 : 4);   // bytes
  static constexpr int T_STAGE = BN * BK * 4;   // 128 rows of 128 bytes
  static constexpr int NST = 4;
  // [table lo, 2 buffers][table ring, NST][x ring, NST]: the table
  // buffers 1024-byte aligned (the 128-byte swizzle's period), from a base
  // aligned up within the first 1024 bytes
  static constexpr size_t bytes =
      1024 + 2 * (size_t)T_STAGE + (size_t)NST * (T_STAGE + X_STAGE);
};

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address, leading offset 1 (unused by swizzled K-major
// layouts), 1024 bytes from one 8-row group to the next, swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// one wgmma.m64n128k8 with A from registers: the accumulator's 64
// registers of this thread are operands 0-63, A's four 64-67, B's
// descriptor 68, and 69 says whether d is accumulated (else overwritten)
#define GK_WGMMA_ASM                                                     \
  "{\n"                                                                  \
  ".reg .pred p;\n"                                                      \
  "setp.ne.b32 p, %69, 0;\n"                                             \
  "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"               \
  "%0, %1, %2, %3, %4, %5, %6, %7,"                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15,"                                \
  "%16, %17, %18, %19, %20, %21, %22, %23,"                              \
  "%24, %25, %26, %27, %28, %29, %30, %31,"                              \
  "%32, %33, %34, %35, %36, %37, %38, %39,"                              \
  "%40, %41, %42, %43, %44, %45, %46, %47,"                              \
  "%48, %49, %50, %51, %52, %53, %54, %55,"                              \
  "%56, %57, %58, %59, %60, %61, %62, %63"                               \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"                            \
  "}\n"
#define GK_D16(C, o) \
  C(d[o + 0]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), \
  C(d[o + 4]), C(d[o + 5]), C(d[o + 6]), C(d[o + 7]), \
  C(d[o + 8]), C(d[o + 9]), C(d[o + 10]), C(d[o + 11]), \
  C(d[o + 12]), C(d[o + 13]), C(d[o + 14]), C(d[o + 15])
#define GK_D64(C) GK_D16(C, 0), GK_D16(C, 16), GK_D16(C, 32), GK_D16(C, 48)
#define GK_READ_WRITE(r) "+f"(r)
#define GK_WRITE(r) "=f"(r)

// d (64 x 128, fp32, this thread's 64 of it) += a (64 x 8, TF32, this
// thread's 4 registers of it) . b (8 x 128, TF32, the descriptor's K-major
// tile)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const unsigned (&a)[4],
                                           uint64_t desc) {
  asm volatile(GK_WGMMA_ASM
               : GK_D64(GK_READ_WRITE)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(1));
}

// d = a . b, into a fresh accumulator (the old d is not read)
__device__ __forceinline__ void wgmma_tf32_new(float (&d)[64],
                                               const unsigned (&a)[4],
                                               uint64_t desc) {
  asm volatile(GK_WGMMA_ASM
               : GK_D64(GK_WRITE)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                 "r"(0));
}

// keeps the compiler from moving reads or writes of r across the wgmma
// fences and waits (the tensor cores own the accumulator in between)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows r0 .. r0+127 of the table, depth k0 .. k0+31 -> dst, row r at
// 128 r bytes with its 16-byte chunk c at chunk c ^ (r & 7): the layout
// the 128-byte swizzle reads. Rows past n_rows and columns past d are
// zero-filled.
__device__ __forceinline__ void load_table_sw128(unsigned char* __restrict__ dst,
                                                 const float* __restrict__ src,
                                                 int r0, int n_rows, int k0,
                                                 int d) {
#pragma unroll
  for (int j = 0; j < BN * 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < n_rows && k0 + 4 * c < d;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? src + (size_t)(r0 + r) * d + k0 + 4 * c : src,
               ok ? 16 : 0);
  }
}

// the table tile at t, in place -> its TF32 hi, and its lo -> lo (the
// same layout): element-wise, so in any order of the chunks
__device__ __forceinline__ void split_tile(unsigned char* __restrict__ t,
                                           unsigned char* __restrict__ lo) {
#pragma unroll
  for (int j = 0; j < BN * 8 / THREADS; ++j) {
    const int o = (threadIdx.x + j * THREADS) * 16;
    const float4 v = *reinterpret_cast<const float4*>(t + o);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(t + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// grid (ceil(T / 128), n_splits), block THREADS: two warpgroups, each 64
// tokens by the tile's 128 columns. The same partials as
// gk_partial_kernel. Per ring stage (32 deep): the tile's table hi / lo
// were split one stage ahead; the products go to a fresh accumulator
// (lo.hi for fp32 x, hi.lo, then hi.hi; 12 or 8 wgmmas), the next stage is
// split while they run, and an fp32 add takes the accumulator into the
// running sum.
template <bool XB>
__global__ void __launch_bounds__(THREADS, 1)
gk_partial_wg_kernel(const void* __restrict__ x,
                     const float* __restrict__ table,
                     const int* __restrict__ targets, int T, int V, int d,
                     int tiles_per_split, int n_splits,
                     float* __restrict__ pm, float* __restrict__ ps,
                     float* __restrict__ pw, int* __restrict__ pidx,
                     float* __restrict__ ptl) {
  using L = WgTile<XB>;
  constexpr int NST = L::NST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float tl_s[128];
  __shared__ int tgt_s[128];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* lo_buf = base;                       // [2][T_STAGE]
  unsigned char* t_ring = base + 2 * L::T_STAGE;      // [NST][T_STAGE]
  unsigned char* x_ring = t_ring + NST * L::T_STAGE;  // [NST][X_STAGE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // and row0 + 8
  const int t0 = blockIdx.x * 128;
  const int split = blockIdx.y;
  const int v_begin = split * tiles_per_split * BN;
  const int v_end = min(V, v_begin + tiles_per_split * BN);
  const int n_tiles = (v_end - v_begin + BN - 1) / BN;
  const int n_ks = (d + BK - 1) / BK;
  const int n_steps = n_tiles * n_ks;

  if (tid < 128) {
    tgt_s[tid] = t0 + tid < T ? targets[t0 + tid] : -1;
    tl_s[tid] = 0.f;
  }
  auto load_step = [&](int st) {
    if (st < n_steps) {
      const int k0 = (st % n_ks) * BK;
      load_tile<128, XB ? 2 : 4, WG_XRS>(x_ring + (st % NST) * L::X_STAGE,
                                         static_cast<const unsigned char*>(x),
                                         t0, T, k0, d);
      load_table_sw128(t_ring + (st % NST) * L::T_STAGE, table,
                       v_begin + (st / n_ks) * BN, V, k0, d);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < NST - 1; ++st) load_step(st);
  cp_async_wait<NST - 2>();
  __syncthreads();
  split_tile(t_ring, lo_buf);
  fence_proxy_async();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, s[2] = {0.f, 0.f}, w[2] = {0.f, 0.f};
  int idx[2] = {NO_INDEX, NO_INDEX};

  for (int step = 0; step < n_steps; ++step) {
    // step + 1 has landed for every thread, step's split is visible to
    // the tensor cores, and every warp is done with step - 1
    cp_async_wait<NST - 3>();
    __syncthreads();
    load_step(step + NST - 1);
    const int slot = step % NST;

    // x fragments of the stage's four k8 steps: rows row0 and row0 + 8,
    // k indices tq and tq + 4
    unsigned ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int k = 8 * kk + tq;
      if constexpr (XB) {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(
            x_ring + slot * L::X_STAGE);
        ah[kk][0] = (unsigned)xs[row0 * WG_XRS + k] << 16;
        ah[kk][1] = (unsigned)xs[(row0 + 8) * WG_XRS + k] << 16;
        ah[kk][2] = (unsigned)xs[row0 * WG_XRS + k + 4] << 16;
        ah[kk][3] = (unsigned)xs[(row0 + 8) * WG_XRS + k + 4] << 16;
      } else {
        const float* xs =
            reinterpret_cast<const float*>(x_ring + slot * L::X_STAGE);
        split_tf32(xs[row0 * WG_XRS + k], ah[kk][0], al[kk][0]);
        split_tf32(xs[(row0 + 8) * WG_XRS + k], ah[kk][1], al[kk][1]);
        split_tf32(xs[row0 * WG_XRS + k + 4], ah[kk][2], al[kk][2]);
        split_tf32(xs[(row0 + 8) * WG_XRS + k + 4], ah[kk][3], al[kk][3]);
      }
    }
    const unsigned th = smem_addr(t_ring + slot * L::T_STAGE);
    const unsigned tl = smem_addr(lo_buf + (step & 1) * L::T_STAGE);
    float part[64];
    wgmma_fence();
    // lo.hi (fp32 x only) and hi.lo of each k8 step, then hi.hi
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      if constexpr (!XB) {
        if (kk == 0) {
          wgmma_tf32_new(part, al[kk], sw128_desc(th));
        } else {
          wgmma_tf32(part, al[kk], sw128_desc(th + 32 * kk));
        }
        wgmma_tf32(part, ah[kk], sw128_desc(tl + 32 * kk));
      } else if (kk == 0) {
        wgmma_tf32_new(part, ah[kk], sw128_desc(tl));
      } else {
        wgmma_tf32(part, ah[kk], sw128_desc(tl + 32 * kk));
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_tf32(part, ah[kk], sw128_desc(th + 32 * kk));
    wgmma_commit();
    // the next stage's split while the products run
    if (step + 1 < n_steps) {
      split_tile(t_ring + ((step + 1) % NST) * L::T_STAGE,
                 lo_buf + ((step + 1) & 1) * L::T_STAGE);
      fence_proxy_async();
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      fence_operand(part[i]);
      acc[i] += part[i];
    }

    if (step % n_ks == n_ks - 1) {
      // element 4 j + 2 h + e of the accumulator is row row0 + 8 h,
      // column 8 j + 2 tq + e
      const int c0 = v_begin + (step / n_ks) * BN + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[32];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          v[2 * j] = acc[4 * j + 2 * h];
          v[2 * j + 1] = acc[4 * j + 2 * h + 1];
        }
        const int r = row0 + 8 * h;
        fold_row(v, c0, V, tgt_s[r], &tl_s[r], m[h], s[h], w[h], idx[h]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none in flight

  // a row lies in one warp: merge its 4 lanes
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, w[h], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx[h], off);
      merge_stats(m[h], s[h], w[h], idx[h], m2, s2, w2, i2);
    }
  __syncthreads();                          // every target logit written
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (t0 + r >= T) continue;
      const size_t o = (size_t)(t0 + r) * n_splits + split;
      pm[o] = m[h];
      ps[o] = s[h];
      pw[o] = w[h];
      pidx[o] = idx[h];
      ptl[o] = tl_s[r];
    }
  }
}

constexpr int kMergeWarps = 8;

// grid ceil(T / kMergeWarps), block 32 * kMergeWarps: one warp a token,
// from its n_splits partials at [t * n_splits ..]
__global__ void __launch_bounds__(32 * kMergeWarps)
gk_merge_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                const float* __restrict__ pw, const int* __restrict__ pidx,
                const float* __restrict__ ptl,
                const int* __restrict__ targets, int T, int V, int n_splits,
                int span, float log_v, float* __restrict__ ce,
                float* __restrict__ kl, float* __restrict__ corr,
                float* __restrict__ ent, float* __restrict__ lse) {
  const int t = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;                         // whole warps
  const size_t base = (size_t)t * n_splits;
  float m = NEG, s = 0.f, w = 0.f;
  int idx = NO_INDEX;
  for (int sp = lane; sp < n_splits; sp += 32)
    merge_stats(m, s, w, idx, pm[base + sp], ps[base + sp], pw[base + sp],
                pidx[base + sp]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float w2 = __shfl_xor_sync(0xffffffffu, w, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    merge_stats(m, s, w, idx, m2, s2, w2, i2);
  }
  if (lane != 0) return;
  const int tg = targets[t];
  const float tl = (tg >= 0 && tg < V) ? ptl[base + tg / span] : 0.f;
  const float l = m + logf(s);
  const float h = l - w / s;
  ce[t] = l - tl;
  kl[t] = log_v - h;
  corr[t] = idx == tg ? 1.f : 0.f;
  ent[t] = h;
  lse[t] = l;
}

template <int BM, bool XB>
int launch_partial(const void* x, const float* table, const int* targets,
                   int T, int V, int d, int tiles_per_split, int n_splits,
                   float* pm, float* ps, float* pw, int* pidx, float* ptl,
                   cudaStream_t st) {
  using L = Tile<BM, XB>;
  auto kernel = gk_partial_kernel<BM, XB>;
  // set once per instantiation; a failure is kept and returned by every
  // later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((T + BM - 1) / BM, n_splits);
  kernel<<<grid, THREADS, L::bytes, st>>>(x, table, targets, T, V, d,
                                          tiles_per_split, n_splits, pm, ps,
                                          pw, pidx, ptl);
  return (int)cudaGetLastError();
}

template <bool XB>
int launch_partial_bm(int bm, const void* x, const float* table,
                      const int* targets, int T, int V, int d, int per,
                      int n_splits, float* pm, float* ps, float* pw,
                      int* pidx, float* ptl, cudaStream_t st) {
  switch (bm) {
    case 32:
      return launch_partial<32, XB>(x, table, targets, T, V, d, per,
                                    n_splits, pm, ps, pw, pidx, ptl, st);
    case 64:
      return launch_partial<64, XB>(x, table, targets, T, V, d, per,
                                    n_splits, pm, ps, pw, pidx, ptl, st);
    case 128: {
      using L = WgTile<XB>;
      auto kernel = gk_partial_wg_kernel<XB>;
      static const cudaError_t attr_err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
      if (attr_err != cudaSuccess) return (int)attr_err;
      dim3 grid((T + 127) / 128, n_splits);
      kernel<<<grid, THREADS, L::bytes, st>>>(x, table, targets, T, V, d, per,
                                              n_splits, pm, ps, pw, pidx, ptl);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [T, d] fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1), table [V, d] fp32,
// d % 4 == 0, rows 16-byte (fp32) or 8-byte (bf16) aligned; bm (32, 64 or
// 128) tokens a CTA; tiles_per_split 128-column tiles in each of n_splits
// vocabulary splits. scratch: 5 * T * n_splits four-byte words (partial m,
// s, w, argmax index, target logit). Returns the CUDA error of the launches
// (0 on success).
extern "C" int gatekeeper_loss_tokens(const void* x, int x_bf16,
                                      const float* table, const int* targets,
                                      float* ce, float* kl, float* corr,
                                      float* ent, float* lse, float* scratch,
                                      int T, int V, int d, int bm,
                                      int tiles_per_split, int n_splits,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)n_splits * T;
  float* pm = scratch;
  float* ps = scratch + n;
  float* pw = scratch + 2 * n;
  int* pidx = reinterpret_cast<int*>(scratch + 3 * n);
  float* ptl = scratch + 4 * n;
  const int err =
      x_bf16 ? launch_partial_bm<true>(bm, x, table, targets, T, V, d,
                                       tiles_per_split, n_splits, pm, ps, pw,
                                       pidx, ptl, st)
             : launch_partial_bm<false>(bm, x, table, targets, T, V, d,
                                        tiles_per_split, n_splits, pm, ps, pw,
                                        pidx, ptl, st);
  if (err != 0) return err;
  const float log_v = static_cast<float>(log(static_cast<double>(V)));
  gk_merge_kernel<<<(T + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
                    st>>>(pm, ps, pw, pidx, ptl, targets, T, V, n_splits,
                          tiles_per_split * BN, log_v, ce, kl, corr, ent, lse);
  return static_cast<int>(cudaGetLastError());
}
