// Linear recurrence (RWKV6 WKV / Mamba2 SSD) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `wkv_scan` (src/repro/kernels/wkv_scan.py).
// Per (batch, head) stream, with an fp32 [K, V] state S:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t), logw_t <= 0
//   rwkv:  y_t = q_t^T (S_{t-1} + diag(u) k_t v_t^T)   (exclusive + bonus)
//   mamba: y_t = q_t^T S_t                              (inclusive)
//
// Two paths, chosen by T alone in the C entry point `wkv_scan` (both are
// kernels of this file; neither stands in for the other on failure):
// T < kChunkedMinT = 48 (decode, T = 1, and short segments) runs
// `wkv_decode_kernel`, longer T (prefill) the three chunk-parallel kernels.
// `wkv_scan_path` runs either path at any T, so the two can be timed and
// checked side by side.
//
// Bound on the card: bytes. Each token costs 4 K V flops against (3 K + 2 V)
// * 4 bytes of its own, and the state is read once and written once: at the
// rwkv6-3b decode shape (8 rows x 40 heads, K = V = 64, T = 1) that is the
// 5.2 MB state both ways, 3.3 us at 3.35 TB/s.
//
// The TPU kernel runs a (stream, chunk) grid whose chunk axis is sequential
// and keeps S in VMEM scratch across chunk steps, with the intra-chunk part
// as matrix products. On the card blocks run in no order.
//
// T < 48: `wkv_decode_kernel`. At T = 1 the whole cost is moving the state,
// so the design is about how it moves: many 16-byte accesses in flight at
// once, on every SM, and little else between the load and the store.
//
//   * A CTA owns one stream and a block of 32 value columns (8 when V is
//     not a multiple of 4 or a pointer is not 16-byte aligned): the value
//     columns of S are independent, so y needs no sum across CTAs, and
//     rwkv6-3b's decode is 640 CTAs of 128 threads, about 5 an SM in one
//     wave (zamba2's 1024).
//   * Thread (tx, ty) of the CTA's 8 x RT threads holds 4 neighbouring
//     columns (one float4) of rows ty, ty + RT, ... (R <= 8 rows; RT = 16
//     up to K = 128, then 32 and 64): a warp's load covers four whole
//     128-byte row segments of S. Every thread issues its R float4 loads
//     of the state first; then the CTA stages the tokens' q, k, exp(logw)
//     and v columns in shared memory in one coalesced pass (up to 8 tokens
//     at a time; one token at T = 1), while the state is in flight, and u
//     is read once. Each thread reading its own rows of q, k and logw from
//     device memory instead (3 R scalar loads a token) was slower on the
//     card, at T = 1 and more so at T = 16, where each token then waits a
//     load round trip.
//   * y_t = q_t^T S is summed over K in a fixed order: each thread's rows,
//     then xor shuffles over the warp's four thread rows, then the warps'
//     sums from shared memory in warp order, no atomics, so two calls give
//     the same bits. rwkv's bonus q^T diag(u) k v^T is the scalar
//     (sum_k q_k u_k k_k) times v^T, reduced beside y and added once.
//   * T > 1 walks the staged tokens with S in registers; the warps' sums
//     wait in shared memory for the group's tokens, merged after one
//     barrier.
//   * logw is [.., K] or, for the scalar per-head decay of Mamba2, [.., 1]
//     (`w_scalar`), read once per token and used for every row.
//   * Each thread reads its entries of s0 before its first token and
//     writes the same entries of s_out after its last, and no other CTA
//     touches them, so s_out may be s0 (in place).
//
// T >= 48: the chunk-parallel path. The per-token kernel's time grows with T
// (each CTA walks every token in order) and is 80 CTAs at one row of
// rwkv6-3b. Here T splits into chunks of kChunk = 64 tokens (the last
// may be partial: rows past T are zeros with logw = 0), each of four
// sub-chunks of kSub = 16; cum is the inclusive in-chunk sum of logw in
// log2 units, ocum = cum - logw (rwkv; the previous token's cum) or cum
// (mamba). No exponent is ever positive: every factor is exp2(a - b) with
// a at or after b in the chunk.
//
//   1. `wkv_chunk_state_kernel`, grid (stream, chunk, V block):
//      dS_c = sum_s (k_s * exp2(cum_last - cum_s)) v_s^T into a workspace
//      ws [B,H,NC,K,V]; V block 0 also writes the chunk's cum into wc
//      [B,H,NC,64,Kw], which the later phases read instead of logw.
//   2. `wkv_chunk_carry_kernel`, one thread per (stream, K x V entry):
//      S_0 = s0, S_{c+1} = diag(g_c) S_c + dS_c with g_c = exp2(cum_last);
//      each chunk's starting state overwrites its dS_c, the last state goes
//      to s_out. A thread reads its s0 entry before it writes that s_out
//      entry, so s_out may be s0. The sequential chain is T / 64 steps.
//   3. `wkv_chunk_out_kernel`, grid (stream, chunk, 4 x V blocks): a CTA
//      owns the 16 query rows of sub-chunk i and 64 value columns, 16 a
//      warp: y_t = (q_t * exp2(ocum_t)) S_c + sum_s A_ts v_s, with row
//      block i of A built over K slices of 32. Off-diagonal blocks (key
//      sub-chunk j < i, on warp j) are the product
//      (q * exp2(ocum - r_j)) (k * exp2(r_j - cum))^T with r_j the cum at
//      the last token of sub-chunk j: both exponents are <= 0, so no factor
//      overflows (a chunk-start reference makes exp(-cum_s) overflow once a
//      chunk's decays sum below -88, which RWKV6's strong channels reach in
//      a few tokens) and a factor that underflows is below the product's
//      own error. The 16 x 16 diagonal block is exact SIMT sums
//      sum_k q_tk k_sk exp2(ocum_tk - cum_sk), one pair t > s a thread, four
//      columns a load; threads 120 .. 127 take the pairs s = t, which carry
//      the rwkv bonus q_t . (u * k_t) (mamba: q_t . k_t). A is assembled in
//      shared memory and multiplied by V. The four row-block CTAs of a chunk
//      each load its k, cum, S_c and V rows (their time goes mostly to
//      these loads), and each V block rebuilds A.
//
//   Every matrix product (q~ S_c, the off-diagonal q~ k~^T, A V and phase
//   1's k~^T V) runs on the tensor cores as `mma.sync.m16n8k8` TF32 tiles
//   with fp32 accumulation, each fp32 operand split into hi (its top 19
//   bits, as the tensor cores read TF32) and lo (those of x - hi) and three
//   products lo.hi + hi.lo + hi.hi summed: one TF32 product misses the
//   atol = rtol = 5e-4 the kernel is held to 5-7x at rwkv6-3b's prefill
//   shape, the split holds it as fp32 does (tests/test_torch_wkv_chunked.py
//   emulates the algebra and pins both facts). Tiles are staged in shared
//   memory by `cp.async` (16-byte copies when K and V are multiples of 4
//   and the rows 16-byte aligned, else 4-byte ones); row strides are padded
//   so that every fragment read falls on 32 distinct banks. No atomics and
//   every sum in a fixed order: two calls on the same inputs give the same
//   bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDim = 512;    // largest K (V is split into blocks)

// ---------------------------------------------------------------------------
// T < kChunkedMinT: the per-token kernel
// ---------------------------------------------------------------------------

constexpr int kCT = 8;          // column threads of a CTA
constexpr int kTokBuf = 8;      // tokens staged at once (4 at K > 256)

// CW neighbouring columns of shared memory
template <int CW>
__device__ __forceinline__ void read_cols(const float* p, float (&x)[CW]) {
  if constexpr (CW == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) x[c] = p[c];
  }
}

// the state passes through once a call: its loads and stores are marked
// evict-first (.cs), which was faster on the card than plain ones
template <int CW>
__device__ __forceinline__ void load_state(const float* p, float (&x)[CW]) {
  if constexpr (CW == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) x[c] = __ldcs(p + c);
  }
}

template <int CW>
__device__ __forceinline__ void store_state(float* p, const float (&x)[CW]) {
  if constexpr (CW == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) __stcs(p + c, x[c]);
  }
}

// grid (B * H, ceil(V / (kCT * CW))), block kCT * RT threads; R * RT >= K.
// Thread (tx, ty) = (tid % kCT, tid / kCT) holds rows ty, ty + RT, ... of
// the CTA's value columns tx * CW .. tx * CW + CW - 1: a warp covers four
// thread rows of kCT neighbours, each row's kCT * CW columns contiguous
// (128 bytes at CW = 4).
template <int R, int RT, int CW, bool kRwkv>
__global__ void __launch_bounds__(kCT * RT)
wkv_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ y, float* s_out, int T, int H, int K,
                  int V, int w_scalar) {
  constexpr int NT = kCT * RT, NW = NT / 32, VC = kCT * CW, KP = R * RT;
  constexpr int G = KP <= 256 ? kTokBuf : kTokBuf / 2;  // under 48 KB
  constexpr int NP = VC + (kRwkv ? 1 : 0);    // a warp's sums (+ bonus)
  __shared__ float part[G][NW][NP];
  __shared__ float sq[G][KP], sk[G][KP], sw[G][KP];
  __shared__ __align__(16) float sv[G][VC];

  const int bh = blockIdx.x;                  // stream b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, tx = tid % kCT, ty = tid / kCT;
  const int lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.y * VC;             // the CTA's first column
  const int col = v0 + tx * CW;
  const bool active = col < V;                // CW = 4: V % 4 == 0
  // token t of the stream is row (b * T + t) * H + h of the [B,T,H,*] inputs
  const size_t row0 = (size_t)b * T * H + h;

  float S[R][CW];
  const float* s_in = s0 + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = ty + j * RT;
    if (active && r < K) {
      load_state<CW>(s_in + (size_t)r * V + col, S[j]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) S[j][c] = 0.f;
    }
  }
  float ur[kRwkv ? R : 1];
  if constexpr (kRwkv) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = ty + j * RT;
      ur[j] = r < K ? __ldg(u + (size_t)h * K + r) : 0.f;
    }
  }

  for (int t0 = 0; t0 < T; t0 += G) {
    const int n = min(G, T - t0);
    // the group's q, k, exp(logw) and v columns, one coalesced pass
    for (int i = tid; i < n * KP; i += NT) {
      const int tt = i / KP, r = i - tt * KP;
      const size_t row = row0 + (size_t)(t0 + tt) * H;
      const bool ok = r < K;
      sq[tt][r] = ok ? __ldg(q + row * K + r) : 0.f;
      sk[tt][r] = ok ? __ldg(k + row * K + r) : 0.f;
      sw[tt][r] = ok ? expf(__ldg(logw + (w_scalar ? row : row * K + r)))
                     : 0.f;
    }
    for (int i = tid; i < n * VC; i += NT) {
      const int tt = i / VC, c = i - tt * VC;
      sv[tt][c] = v0 + c < V
                      ? __ldg(v + (row0 + (size_t)(t0 + tt) * H) * V + v0 + c)
                      : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      float vv[CW];
      read_cols<CW>(&sv[tt][tx * CW], vv);
      float acc[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = 0.f;
      float bonus = 0.f;                      // rwkv: sum_k q_k u_k k_k
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + j * RT;
        const float qj = sq[tt][r], kj = sk[tt][r], w = sw[tt][r];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float kv = kj * vv[c];
          if constexpr (kRwkv) {              // y reads S before the token
            acc[c] = fmaf(qj, S[j][c], acc[c]);
            S[j][c] = fmaf(w, S[j][c], kv);
          } else {                            // y reads S after it
            S[j][c] = fmaf(w, S[j][c], kv);
            acc[c] = fmaf(qj, S[j][c], acc[c]);
          }
        }
        if constexpr (kRwkv) bonus = fmaf(qj * ur[j], kj, bonus);
      }
      // the warp's four thread rows, then one slot per warp in shared
      // memory: a fixed order, no atomics
#pragma unroll
      for (int o = kCT; o < 32; o <<= 1) {
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
        if constexpr (kRwkv)
          bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
      }
      if (lane < kCT) {
#pragma unroll
        for (int c = 0; c < CW; ++c) part[tt][warp][tx * CW + c] = acc[c];
        if constexpr (kRwkv) {
          if (lane == 0) part[tt][warp][VC] = bonus;
        }
      }
    }
    __syncthreads();
    // y of these n tokens, one thread per (token, column): the warps' sums
    // in warp order, then the rwkv bonus as one scalar times v
    for (int i = tid; i < n * VC; i += NT) {
      const int tt = i / VC, c = i - tt * VC;
      if (v0 + c < V) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) acc += part[tt][w][c];
        if constexpr (kRwkv) {
          float bonus = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) bonus += part[tt][w][VC];
          acc = fmaf(bonus, sv[tt][c], acc);
        }
        y[(row0 + (size_t)(t0 + tt) * H) * V + v0 + c] = acc;
      }
    }
    __syncthreads();                          // the group's buffers refill
  }
  // each thread writes exactly the entries it read: s_out may be s0
  float* s_o = s_out + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = ty + j * RT;
    if (active && r < K) store_state<CW>(s_o + (size_t)r * V + col, S[j]);
  }
}

template <int R, int RT, int CW, bool kRwkv>
int launch_decode(int BH, int V, cudaStream_t st, const float* q,
                  const float* k, const float* v, const float* lw,
                  const float* u, const float* s0, float* y, float* s_out,
                  int T, int H, int K, int w_scalar) {
  const int nvb = (V + kCT * CW - 1) / (kCT * CW);
  if (nvb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  wkv_decode_kernel<R, RT, CW, kRwkv><<<dim3(BH, nvb), kCT * RT, 0, st>>>(
      q, k, v, lw, u, s0, y, s_out, T, H, K, V, w_scalar);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int RT>
int launch_bucket(bool rwkv, bool vec, int BH, int V, cudaStream_t st,
                  const float* q, const float* k, const float* v,
                  const float* lw, const float* u, const float* s0, float* y,
                  float* s_out, int T, int H, int K, int w_scalar) {
#define WKV_DECODE(CW, RK)                                                   \
  return launch_decode<R, RT, CW, RK>(BH, V, st, q, k, v, lw, u, s0, y,      \
                                      s_out, T, H, K, w_scalar)
  if (vec) {
    if (rwkv) WKV_DECODE(4, true);
    WKV_DECODE(4, false);
  }
  if (rwkv) WKV_DECODE(1, true);
  WKV_DECODE(1, false);
#undef WKV_DECODE
}

// the per-token kernel at any T, by K's bucket: at most 8 rows a thread,
// 128 threads up to K = 128, then 256 and 512
int launch_sequential(int BH, int K, int V, cudaStream_t st, const float* q,
                      const float* k, const float* v, const float* lw,
                      const float* u, const float* s0, float* y,
                      float* s_out, int T, int H, int w_scalar, bool rk,
                      bool vec) {
#define WKV_BUCKET(R, RT)                                                    \
  return launch_bucket<R, RT>(rk, vec, BH, V, st, q, k, v, lw, u, s0, y,     \
                              s_out, T, H, K, w_scalar)
  if (K <= 16) WKV_BUCKET(1, 16);
  if (K <= 32) WKV_BUCKET(2, 16);
  if (K <= 64) WKV_BUCKET(4, 16);
  if (K <= 128) WKV_BUCKET(8, 16);
  if (K <= 256) WKV_BUCKET(8, 32);
  WKV_BUCKET(8, 64);
#undef WKV_BUCKET
}

// ---------------------------------------------------------------------------
// T >= kChunkedMinT: the chunk-parallel path
// ---------------------------------------------------------------------------

// Below this T the per-token kernel is the faster one: at 8 rows of 40
// heads of K = V = 64 the two meet near T = 48 (chip_smoke.py phase 3e
// times both paths at T 2, 16, 32, 48 and 64).
constexpr int kChunkedMinT = 48;
constexpr int kChunk = 64;          // tokens per chunk
constexpr int kSub = 16;            // tokens per sub-chunk: a block of A
constexpr int kThreads1 = 256;      // phase 1: 8 warps
constexpr int kThreads3 = 128;      // phase 3: 4 warps
constexpr int kVB = 64;             // value columns per CTA, both phases
constexpr int kKT1 = 64;            // phase 1: K rows per slice
constexpr int kKT3 = 32;            // phase 3: K columns per slice
// Row strides. An mma fragment read (row g, column tq) of a tile hits bank
// 4 g + tq when the stride is 4 mod 32, a transposed one (row tq, column
// g) 8 tq + g when it is 8 mod 32: 32 distinct banks either way.
constexpr int kS1 = kKT1 + 8;       // phase 1 k~, cum [token][K row]
constexpr int kS3 = kKT3 + 4;       // phase 3 q, k, cum [token][K column]
constexpr int kVS = kVB + 8;        // v [token][column], S_c [K row][column]
constexpr int kAS = kChunk + 4;     // phase 3 A [query row][key]
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t kSmem1 =
    sizeof(float) * (2 * kChunk * kS1 + kChunk * kVS + kThreads1);
constexpr int kStrict = kSub * (kSub - 1) / 2;   // diagonal pairs t > s
constexpr size_t kSmem3 =
    sizeof(float) * ((3 * kSub + 2 * kChunk) * kS3 + (kKT3 + kChunk) * kVS +
                     kKT3);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 2^x for x <= 0 (every exponent here), results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// rows [0, rows) x columns [0, W) of a row-major source whose rows lie
// row_stride floats apart -> dst, rows DS floats apart; rows >= n_rows and
// columns >= n_cols become zeros. vec: 16-byte copies (n_cols, row_stride
// and W multiples of 4, src 16-byte aligned), else 4-byte ones.
template <int W, int DS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t row_stride, int rows,
                                          int n_rows, int n_cols, bool vec) {
  if (vec && W % 4 == 0) {
    constexpr int G = W / 4;
    for (int i = threadIdx.x; i < rows * G; i += NT) {
      const int r = i / G, c = (i % G) * 4;
      const bool ok = r < n_rows && c < n_cols;
      cp_async16(dst + r * DS + c, ok ? src + r * row_stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, c = i % W;
      const bool ok = r < n_rows && c < n_cols;
      cp_async4(dst + r * DS + c, ok ? src + r * row_stride + c : src,
                ok ? 4 : 0);
    }
  }
}

// cs[t][c] (logw, c < W, t < kChunk) -> log2e * (logw_0 + ... + logw_t) in
// place: thread (c, p) sums tokens [p TOK, (p + 1) TOK) in order, then adds
// the totals of the parts before its own. Ends behind a barrier.
template <int W, int DS, int NT>
__device__ __forceinline__ void chunk_cumsum(float* cs, float* tot) {
  constexpr int TOK = kChunk / (NT / W);
  const int c = threadIdx.x % W, p = threadIdx.x / W;
  float x[TOK];
#pragma unroll
  for (int t = 0; t < TOK; ++t) x[t] = cs[(p * TOK + t) * DS + c];
  float run = 0.f;
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    run = fmaf(x[t], kLog2e, run);
    x[t] = run;
  }
  tot[p * W + c] = run;
  __syncthreads();
  float off = 0.f;
  for (int pp = 0; pp < p; ++pp) off += tot[pp * W + c];
#pragma unroll
  for (int t = 0; t < TOK; ++t) cs[(p * TOK + t) * DS + c] = off + x[t];
  __syncthreads();
}

// the scalar decay's cs[t], t < kChunk, the same way: warp 0, two tokens a
// lane, an inclusive shuffle scan of the pairs. Ends behind a barrier.
__device__ __forceinline__ void chunk_cumsum_scalar(float* cs) {
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const float a = cs[2 * l] * kLog2e;
    const float b = fmaf(cs[2 * l + 1], kLog2e, a);
    float s = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, s, o);
      if (l >= o) s += n;
    }
    float ex = __shfl_up_sync(0xffffffffu, s, 1);
    if (l == 0) ex = 0.f;
    cs[2 * l] = ex + a;
    cs[2 * l + 1] = ex + b;
  }
  __syncthreads();
}

// x -> TF32 hi + lo: hi keeps x's top 19 bits, lo those of x - hi (exact
// in fp32), so hi + lo holds 21 of x's 24 significant bits
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this lane's A fragment of a 16 x 8 tile, split: the elements (g, tq),
// (g + 8, tq), (g, tq + 4), (g + 8, tq + 4)
struct FragA {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
  // element (r, c) at p[r * rs + c]
  __device__ __forceinline__ void load(const float* p, int rs) {
    const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
    const float* r = p + g * rs + tq;
    set(r[0], r[8 * rs], r[4], r[8 * rs + 4]);
  }
  // ... split already: (hi, lo) at p[r * rs + c]
  __device__ __forceinline__ void load_split(const float2* p, int rs) {
    const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
    const float2* r = p + g * rs + tq;
    const float2 x[4] = {r[0], r[8 * rs], r[4], r[8 * rs + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = __float_as_uint(x[e].x);
      lo[e] = __float_as_uint(x[e].y);
    }
  }
};

// d += A . B (8 x 8) in three TF32 products lo.hi + hi.lo + hi.hi; this
// lane's B elements (tq, g) and (tq + 4, g) are b0 and b1
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  unsigned h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}
// ... with B's (k, n) at p[k * ks + n]
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const float* p, int ks) {
  const int g = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  mma3(d, a, p[tq * ks + g], p[(tq + 4) * ks + g]);
}

// Phase 1. grid (B * H, NC, ceil(V / kVB)), kThreads1 threads, kSmem1
// bytes. dS_c [K][V] -> ws[bh][c]; V block 0 also writes the chunk's cum
// [kChunk][Kw] -> wc[bh][c]. Warp w owns K rows 16 (w % 4) .. + 15 of a
// slice and the 32 columns 32 (w / 4) .. + 31 of the block.
template <bool kScalar>
__global__ void __launch_bounds__(kThreads1)
wkv_chunk_state_kernel(const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ logw, float* __restrict__ ws,
                       float* __restrict__ wc, int T, int H, int K, int V,
                       int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [kChunk][kS1] k, then k~
  float* cs = ks + kChunk * kS1;      // [kChunk][kS1] logw, then cum
  float* vs = cs + kChunk * kS1;      // [kChunk][kVS]
  float* tot = vs + kChunk * kVS;     // [kThreads1]

  const int NC = gridDim.y;
  const int bh = blockIdx.x, c = blockIdx.y, v0 = blockIdx.z * kVB;
  const int b = bh / H, h = bh - b * H;
  const int nt = min(kChunk, T - c * kChunk);       // tokens of this chunk
  // token t of the chunk is row row0 + t * H of the [B,T,H,*] inputs
  const size_t row0 = ((size_t)b * T + (size_t)c * kChunk) * H + h;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const int Kw = kScalar ? 1 : K;
  float* dS = ws + ((size_t)bh * NC + c) * K * V;
  float* cum_out = wc + ((size_t)bh * NC + c) * kChunk * Kw;

  load_tile<kVB, kVS, kThreads1>(vs, v + row0 * V + v0, (size_t)H * V,
                                 kChunk, nt, V - v0, vec);
  if (kScalar)
    load_tile<1, 1, kThreads1>(cs, logw + row0, H, kChunk, nt, 1, false);
  for (int k0 = 0; k0 < K; k0 += kKT1) {
    if (k0 > 0) __syncthreads();      // the last slice is consumed
    load_tile<kKT1, kS1, kThreads1>(ks, k + row0 * K + k0, (size_t)H * K,
                                    kChunk, nt, K - k0, vec);
    if (!kScalar)
      load_tile<kKT1, kS1, kThreads1>(cs, logw + row0 * K + k0,
                                      (size_t)H * K, kChunk, nt, K - k0, vec);
    cp_async_wait_all();
    __syncthreads();
    if (!kScalar)
      chunk_cumsum<kKT1, kS1, kThreads1>(cs, tot);
    else if (k0 == 0)
      chunk_cumsum_scalar(cs);
    // k~_s = k_s * exp2(cum_last - cum_s); the cum for the later phases
    for (int i = threadIdx.x; i < kChunk * kKT1; i += kThreads1) {
      const int s = i / kKT1, cc = i % kKT1;
      const float last = kScalar ? cs[kChunk - 1] : cs[(kChunk - 1) * kS1 + cc];
      const float cum = kScalar ? cs[s] : cs[s * kS1 + cc];
      ks[s * kS1 + cc] *= ex2(last - cum);
      if (blockIdx.z == 0 && k0 + cc < Kw && (!kScalar || cc == 0))
        cum_out[s * Kw + k0 + cc] = cum;
    }
    __syncthreads();

    // rows k0 + m0 .. + 15 of dS: A = k~^T (16 x kChunk tokens), B = v
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
    for (int s0 = 0; s0 < nt; s0 += 8) {   // rows past nt are zeros
      // A (m, s) = k~[s][m]: rows of A are columns of ks
      const float* p = ks + (s0 + tq) * kS1 + m0 + g;
      FragA a;
      a.set(p[0], p[8], p[4 * kS1], p[4 * kS1 + 8]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma3(acc[n], a, vs + s0 * kVS + n0 + n * 8, kVS);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = k0 + m0 + g + (e >> 1) * 8;
        const int col = v0 + n0 + n * 8 + 2 * tq + (e & 1);
        if (row < K && col < V) dS[(size_t)row * V + col] = acc[n][e];
      }
  }
}

// Phase 2. grid (ceil(K * V / 256), streams in y, then z), 256 threads:
// S_0 = s0, each chunk's dS replaced by its starting state S_c, S_{c+1} =
// g_c S_c + dS_c with g_c = exp2(the chunk's last cum), the last S -> s_out
// (which may be s0: each thread reads its entry first). The next chunk's
// loads are issued before this one's store.
__global__ void __launch_bounds__(256)
wkv_chunk_carry_kernel(const float* s0, float* __restrict__ ws,
                       const float* __restrict__ wc, float* s_out, int BH,
                       int K, int V, int NC, int w_scalar) {
  const int KV = K * V;
  const int i = blockIdx.x * 256 + threadIdx.x;
  const size_t bh = blockIdx.y + (size_t)blockIdx.z * gridDim.y;
  if (i >= KV || bh >= (size_t)BH) return;
  const int Kw = w_scalar ? 1 : K;
  float* p = ws + bh * NC * KV + i;
  // the last cum of chunk c is wc[bh][c][kChunk - 1][k]
  const float* gp =
      wc + (bh * NC * kChunk + kChunk - 1) * Kw + (w_scalar ? 0 : i / V);
  const size_t gstep = (size_t)kChunk * Kw;
  float S = s0[bh * KV + i], d = p[0], lc = gp[0];
  for (int c = 0; c < NC; ++c) {
    const bool more = c + 1 < NC;
    const float d_next = more ? p[(size_t)(c + 1) * KV] : 0.f;
    const float lc_next = more ? gp[(c + 1) * gstep] : 0.f;
    p[(size_t)c * KV] = S;
    S = fmaf(ex2(lc), S, d);
    d = d_next;
    lc = lc_next;
  }
  s_out[bh * KV + i] = S;
}

// Phase 3. grid (B * H, NC, 4 ceil(V / kVB)), kThreads3 threads, kSmem3
// bytes; ws holds each chunk's starting state, wc its cum. CTA (stream,
// chunk, i + 4 vb) owns the chunk's query rows 16 i .. 16 i + 15 (sub-chunk
// i) and the value columns of block vb; warp w owns columns 16 w .. + 15
// of it. Each K slice adds its part of q~ S_c (q~ = q exp2(ocum), split
// once into shared memory for the four warps), of the off-diagonal block
// j = w < i (on warp w) and of the diagonal block: thread p < 120 owns the
// p-th pair t > s, threads 120 .. 127 the pairs t = s (two each, no
// exponent). Then y = q~ S_c + A V.
template <bool kRwkv, bool kScalar>
__global__ void __launch_bounds__(kThreads3, 4)
wkv_chunk_out_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ wc,
                     const float* __restrict__ u,
                     const float* __restrict__ ws, float* __restrict__ y,
                     int T, int H, int K, int V, int vec) {
  const int NC = gridDim.y;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int i = blockIdx.z % 4, v0 = (blockIdx.z / 4) * kVB;
  const int nt = min(kChunk, T - c * kChunk);
  if (i * kSub >= nt) return;         // no query row of this block exists
  const int nb = (i + 1) * kSub;      // rows 0 .. nb - 1 feed block i
  const int rows_q = min(kSub, nt - i * kSub), rows_k = min(nb, nt);
  const int b = bh / H, h = bh - b * H;
  const size_t row0 = ((size_t)b * T + (size_t)c * kChunk) * H + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int Kw = kScalar ? 1 : K;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kSub][kS3] q of the block's rows
  float* ks = qs + kSub * kS3;        // [kChunk][kS3] k, rows < nb
  float* cs = ks + kChunk * kS3;      // [kChunk][kS3] cum, rows < nb
  float2* qt = reinterpret_cast<float2*>(cs + kChunk * kS3);  // [kSub][kS3]
  float* ss = cs + kChunk * kS3 + 2 * kSub * kS3;  // [kKT3][kVS] S_c rows
  float* vs = ss + kKT3 * kVS;        // [kChunk][kVS] v, rows < nb
  float* us = vs + kChunk * kVS;      // [kKT3]
  float* As = qs;                     // [kSub][kAS] after the slices
  static_assert(kSub * kAS <= (kSub + kChunk) * kS3, "A over q and k");

  auto cum = [&](int t, int cc) { return kScalar ? cs[t] : cs[t * kS3 + cc]; };
  auto ocum = [&](int t, int cc) {
    return kRwkv ? (t > 0 ? cum(t - 1, cc) : 0.f) : cum(t, cc);
  };

  // the diagonal pairs: p < kStrict, the p-th pair t > s in row-major
  // order; else the pairs t = s for t = 2 (p - kStrict) and the next
  static_assert(kStrict + kSub / 2 == kThreads3, "one task a thread");
  const bool strict = threadIdx.x < kStrict;
  int pt = 1, ps = threadIdx.x;
  if (strict) {
    while (ps >= pt) ps -= pt++;
  } else {
    pt = ps = 2 * (threadIdx.x - kStrict);
  }
  float d0 = 0.f, d1 = 0.f;           // pair (pt, ps); t = s: also pt + 1

  float acc[2][4], aoff[2][4];        // y columns; block (i, warp) of A
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = aoff[n][e] = 0.f;

  const int t0 = i * kSub + g, t1 = t0 + 8;   // this lane's query rows
  const float* S_c = ws + ((size_t)bh * NC + c) * K * V;
  const float* cum_in = wc + ((size_t)bh * NC + c) * kChunk * Kw;
  load_tile<kVB, kVS, kThreads3>(vs, v + row0 * V + v0, (size_t)H * V, nb,
                                 rows_k, V - v0, vec);
  if (kScalar)
    load_tile<1, 1, kThreads3>(cs, cum_in, 1, nb, nb, 1, false);
  for (int k0 = 0; k0 < K; k0 += kKT3) {
    if (k0 > 0) __syncthreads();      // the last slice is consumed
    const int nk = K - k0;
    load_tile<kKT3, kS3, kThreads3>(qs, q + (row0 + (size_t)i * kSub * H) * K
                                    + k0, (size_t)H * K, kSub, rows_q, nk,
                                    vec);
    load_tile<kKT3, kS3, kThreads3>(ks, k + row0 * K + k0, (size_t)H * K, nb,
                                    rows_k, nk, vec);
    if (!kScalar)
      load_tile<kKT3, kS3, kThreads3>(cs, cum_in + k0, Kw, nb, nb, nk, vec);
    load_tile<kVB, kVS, kThreads3>(ss, S_c + (size_t)k0 * V + v0, V, kKT3,
                                   nk, V - v0, vec);
    if (kRwkv && threadIdx.x < kKT3)
      us[threadIdx.x] =
          threadIdx.x < nk ? u[(size_t)h * K + k0 + threadIdx.x] : 0.f;
    cp_async_wait_all();
    __syncthreads();
    for (int x = threadIdx.x; x < kSub * kKT3; x += kThreads3) {
      const int r = x / kKT3, cc = x % kKT3;
      unsigned hi, lo;
      split(qs[r * kS3 + cc] * ex2(ocum(i * kSub + r, cc)), hi, lo);
      qt[r * kS3 + cc] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kKT3; kk += 8) {
      // q~ S_c
      FragA a;
      a.load_split(qt + kk, kS3);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma3(acc[n], a, ss + kk * kVS + warp * 16 + n * 8, kVS);
      // block (i, j = warp) of A: (q exp2(ocum - r_j)) (k exp2(r_j - cum))^T
      if (warp < i) {
        const int c0 = kk + tq, c1 = c0 + 4, rj = warp * kSub + kSub - 1;
        const float r0 = cum(rj, c0), r1 = cum(rj, c1);
        const float* qr = qs + g * kS3;
        a.set(qr[c0] * ex2(ocum(t0, c0) - r0),
              qr[8 * kS3 + c0] * ex2(ocum(t1, c0) - r0),
              qr[c1] * ex2(ocum(t0, c1) - r1),
              qr[8 * kS3 + c1] * ex2(ocum(t1, c1) - r1));
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = warp * kSub + n * 8 + g;   // this lane's key
          mma3(aoff[n], a, ks[s * kS3 + c0] * ex2(r0 - cum(s, c0)),
               ks[s * kS3 + c1] * ex2(r1 - cum(s, c1)));
        }
      }
    }

    // the diagonal block, exactly, four columns at a time
    const float4* qa = reinterpret_cast<const float4*>(qs + pt * kS3);
    const float4* ka = reinterpret_cast<const float4*>(
        ks + (i * kSub + ps) * kS3);
    if (strict) {
      const int rt = i * kSub + pt, rs = i * kSub + ps;
      const float4* oa = reinterpret_cast<const float4*>(
          cs + (kRwkv ? rt - 1 : rt) * kS3);
      const float4* ca = reinterpret_cast<const float4*>(cs + rs * kS3);
#pragma unroll
      for (int c4 = 0; c4 < kKT3 / 4; ++c4) {
        const float4 x = qa[c4], z = ka[c4];
        if (kScalar) {
          d0 = fmaf(x.x, z.x, d0); d0 = fmaf(x.y, z.y, d0);
          d0 = fmaf(x.z, z.z, d0); d0 = fmaf(x.w, z.w, d0);
        } else {
          const float4 o = oa[c4], m = ca[c4];
          d0 = fmaf(x.x * z.x, ex2(o.x - m.x), d0);
          d0 = fmaf(x.y * z.y, ex2(o.y - m.y), d0);
          d0 = fmaf(x.z * z.z, ex2(o.z - m.z), d0);
          d0 = fmaf(x.w * z.w, ex2(o.w - m.w), d0);
        }
      }
    } else {
      // pairs (t, t) and (t + 1, t + 1): q_t . (w * k_t), w = u or 1
      const float4* qb = qa + kS3 / 4;
      const float4* kb = ka + kS3 / 4;
      const float4* ua = reinterpret_cast<const float4*>(us);
#pragma unroll
      for (int c4 = 0; c4 < kKT3 / 4; ++c4) {
        const float4 w = kRwkv ? ua[c4] : make_float4(1.f, 1.f, 1.f, 1.f);
        const float4 x = qa[c4], z = ka[c4], x2 = qb[c4], z2 = kb[c4];
        d0 = fmaf(x.x * z.x, w.x, d0); d0 = fmaf(x.y * z.y, w.y, d0);
        d0 = fmaf(x.z * z.z, w.z, d0); d0 = fmaf(x.w * z.w, w.w, d0);
        d1 = fmaf(x2.x * z2.x, w.x, d1); d1 = fmaf(x2.y * z2.y, w.y, d1);
        d1 = fmaf(x2.z * z2.z, w.z, d1); d1 = fmaf(x2.w * z2.w, w.w, d1);
      }
    }
  }

  // row block i of A -> As (over q and k, which every warp is done with):
  // the pairs, the upper triangle's zeros, the off-diagonal blocks; then
  // y += A V over the keys [0, nb) that hold tokens
  __syncthreads();
  for (int x = threadIdx.x; x < kSub * kSub; x += kThreads3)
    if (x % kSub > x / kSub) As[(x / kSub) * kAS + i * kSub + x % kSub] = 0.f;
  if (strict) {
    if (kScalar) d0 *= ex2(ocum(i * kSub + pt, 0) - cum(i * kSub + ps, 0));
    As[pt * kAS + i * kSub + ps] = d0;
  } else {
    As[pt * kAS + i * kSub + pt] = d0;
    As[(pt + 1) * kAS + i * kSub + pt + 1] = d1;
  }
  if (warp < i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        As[(g + (e >> 1) * 8) * kAS + warp * kSub + n * 8 + 2 * tq +
           (e & 1)] = aoff[n][e];
  __syncthreads();
  const int n_keys = min(nb, (nt + 7) / 8 * 8);
  for (int kk = 0; kk < n_keys; kk += 8) {
    FragA a;
    a.load(As + kk, kAS);
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mma3(acc[n], a, vs + kk * kVS + warp * 16 + n * 8, kVS);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = i * kSub + g + (e >> 1) * 8;
      const int col = v0 + warp * 16 + n * 8 + 2 * tq + (e & 1);
      if (t < nt && col < V) y[(row0 + (size_t)t * H) * V + col] = acc[n][e];
    }
}

template <bool kRwkv, bool kScalar>
int launch_chunked(int BH, int T, int H, int K, int V, int vec,
                   cudaStream_t st, const float* q, const float* k,
                   const float* v, const float* lw, const float* u,
                   const float* s0, float* y, float* s_out, float* ws,
                   float* wc) {
  auto k1 = wkv_chunk_state_kernel<kScalar>;
  auto k3 = wkv_chunk_out_kernel<kRwkv, kScalar>;
  // raised once per instantiation; a failure is kept and returned by every
  // later launch
  static const cudaError_t attr_err = [&] {
    const cudaError_t e = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem1);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)kSmem3);
  }();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int NC = (T + kChunk - 1) / kChunk, NVB = (V + kVB - 1) / kVB;
  k1<<<dim3(BH, NC, NVB), kThreads1, kSmem1, st>>>(k, v, lw, ws, wc, T, H, K,
                                                   V, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bh_y = BH < 65535 ? BH : 65535;
  wkv_chunk_carry_kernel<<<dim3((K * V + 255) / 256, bh_y,
                                (BH + bh_y - 1) / bh_y),
                           256, 0, st>>>(s0, ws, wc, s_out, BH, K, V, NC,
                                         kScalar ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(BH, NC, 4 * NVB), kThreads3, kSmem3, st>>>(q, k, v, wc, u, ws, y,
                                                       T, H, K, V, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one path of wkv_scan at any T >= 1 (the chunked one needs ws and wc)
int run_path(bool chunked, const float* q, const float* k, const float* v,
             const float* logw, const float* u, const float* s0, float* y,
             float* s_out, float* ws, float* wc, int B, int T, int H, int K,
             int V, int w_scalar, int rwkv, void* stream) {
  if (B < 1 || T < 1 || H < 1 || K < 1 || V < 1 || K > kMaxDim ||
      (rwkv && u == nullptr) || (long long)B * H > 0x7fffffffLL ||
      (chunked && (ws == nullptr || wc == nullptr ||
                   (T + kChunk - 1) / kChunk > 65535 ||
                   (V + kVB - 1) / kVB > 16383)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!chunked)
    return launch_sequential(
        BH, K, V, st, q, k, v, logw, u, s0, y, s_out, T, H, w_scalar,
        rwkv != 0,
        V % 4 == 0 && aligned16(v) && aligned16(s0) && aligned16(s_out) &&
            aligned16(y));
  const int vec = K % 4 == 0 && V % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && (w_scalar || aligned16(logw)) &&
                  aligned16(ws) && aligned16(wc);
#define WKV_CHUNKED(R, S)                                                    \
  return launch_chunked<R, S>(BH, T, H, K, V, vec, st, q, k, v, logw, u, s0, \
                              y, s_out, ws, wc)
  if (rwkv) {
    if (w_scalar) WKV_CHUNKED(true, true);
    WKV_CHUNKED(true, false);
  }
  if (w_scalar) WKV_CHUNKED(false, true);
  WKV_CHUNKED(false, false);
#undef WKV_CHUNKED
}

}  // namespace

// q, k [B,T,H,K], v [B,T,H,V], logw [B,T,H,K] (w_scalar = 0) or [B,T,H,1]
// (w_scalar = 1), u [H,K] (rwkv = 1; may be null for rwkv = 0), s0 and s_out
// [B,H,K,V] (may be the same buffer), y [B,T,H,V]: all fp32, contiguous.
// K <= 512, any V. ws [B,H,ceil(T/64),K,V] and wc [B,H,ceil(T/64),64,Kw]
// (Kw = 1 if w_scalar else K) are the chunked path's fp32 workspace, given
// exactly when T >= kChunkedMinT (null below). Returns the CUDA error of
// the launches (0 on success).
extern "C" int wkv_scan(const float* q, const float* k, const float* v,
                        const float* logw, const float* u, const float* s0,
                        float* y, float* s_out, float* ws, float* wc, int B,
                        int T, int H, int K, int V, int w_scalar, int rwkv,
                        void* stream) {
  const bool chunked = T >= kChunkedMinT;
  if (chunked != (ws != nullptr || wc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_path(chunked, q, k, v, logw, u, s0, y, s_out, ws, wc, B, T, H,
                  K, V, w_scalar, rwkv, stream);
}

// wkv_scan's per-token (chunked = 0) or chunked path at any T >= 1, with
// wkv_scan's arguments (ws and wc for the chunked path only): the two
// paths timed and checked side by side.
extern "C" int wkv_scan_path(const float* q, const float* k, const float* v,
                             const float* logw, const float* u,
                             const float* s0, float* y, float* s_out,
                             float* ws, float* wc, int B, int T, int H, int K,
                             int V, int w_scalar, int rwkv, int chunked,
                             void* stream) {
  return run_path(chunked != 0, q, k, v, logw, u, s0, y, s_out, ws, wc, B, T,
                  H, K, V, w_scalar, rwkv, stream);
}
