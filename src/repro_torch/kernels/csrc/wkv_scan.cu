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
// Bound on the card: bytes. Each token costs 4 K V flops against (3 K + 2 V)
// * 4 bytes of its own, and the state is read once and written once: at the
// rwkv6-3b decode shape (8 rows x 40 heads, K = V = 64, T = 1) that is the
// 5.2 MB state both ways, a few microseconds at 3.35 TB/s.
//
// The TPU kernel runs a (stream, chunk) grid whose chunk axis is sequential
// and keeps S in VMEM scratch across chunk steps, with the intra-chunk part
// as matrix products. On the card blocks run in no order, so one CTA owns a
// stream (and a block of its value columns) and walks all its tokens
// itself, with S in registers from the first token to the last:
//
//   * L adjacent lanes share one value column v of S; lane p holds rows
//     k = p, p + L, ... (R = ceil(K / L) registers, R a power of two up to
//     32). L is 4 for K <= 128, 8 for K <= 256 and 16 for K <= 512, so the
//     state never takes more than 32 registers a lane. y_t[v] is their
//     partial dot products summed with log2(L) xor shuffles.
//   * The value columns of S are independent, so a second grid axis splits
//     V into blocks of 512 / L columns (one CTA of at most 512 threads
//     each): any V runs. Each block stages its stream's q, k and w itself.
//   * 16 tokens at a time of q, k, exp(logw) and v are staged in dynamic
//     shared memory by coalesced loads; u is staged once. Then every thread
//     steps through the 16 tokens with no barrier between them.
//   * Any T >= 1 runs, T = 1 (decode) included: the last stage is short,
//     never a chunk that must divide T.
//   * logw is [.., K] or, for the scalar per-head decay of Mamba2, [.., 1]
//     (`w_scalar`), read once per token and used for every row.
//   * Each CTA reads its slice of s0 before its first token and writes its
//     slice of s_out after its last, so s_out may be s0 (in place).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 16;      // tokens staged in shared memory at once
constexpr int kMaxThreads = 512;
constexpr int kMaxDim = 512;    // largest K (V is split into blocks)

// smem floats: q, k, w [kStage][K], v [kStage][VB], u [K]
__host__ __device__ constexpr int smem_floats(int K, int VB) {
  return 3 * kStage * K + kStage * VB + K;
}

// grid (B * H, ceil(V / VB)), block VB * L threads (rounded up to a warp),
// VB = kMaxThreads / L value columns per block, dynamic shared memory
// smem_floats(K, VB) floats
template <int R, int L, bool kRwkv>
__global__ void __launch_bounds__(kMaxThreads)
wkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* s0, float* __restrict__ y,
           float* s_out, int T, int H, int K, int V, int w_scalar) {
  constexpr int VB = kMaxThreads / L;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kStage * K;
  float* sw = sk + kStage * K;
  float* sv = sw + kStage * K;                // [kStage][VB]
  float* su = sv + kStage * VB;

  const int bh = blockIdx.x;                  // stream b * H + h
  const int b = bh / H, h = bh - b * H;
  const int v0 = blockIdx.y * VB;             // first value column
  const int vb = min(VB, V - v0);             // columns of this block
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int c = tid / L, lane = tid % L;
  const int col = v0 + c;
  const bool active = c < vb;
  // token t of the stream is row (b * T + t) * H + h of the [B,T,H,*] inputs
  const size_t row0 = (size_t)b * T * H + h;
  const int wK = w_scalar ? 1 : K;

  float S[R];
  const float* s_in = s0 + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + j * L;
    S[j] = (active && r < K) ? s_in[(size_t)r * V + col] : 0.f;
  }
  if (kRwkv)
    for (int i = tid; i < K; i += nthreads) su[i] = u[(size_t)h * K + i];

  for (int t0 = 0; t0 < T; t0 += kStage) {
    const int n = min(kStage, T - t0);
    __syncthreads();                          // the last stage is consumed
    for (int i = tid; i < n * K; i += nthreads) {
      const int tt = i / K, r = i - tt * K;
      const size_t row = row0 + (size_t)(t0 + tt) * H;
      sq[i] = q[row * K + r];
      sk[i] = k[row * K + r];
      sw[i] = expf(logw[row * wK + (w_scalar ? 0 : r)]);
    }
    for (int i = tid; i < n * vb; i += nthreads) {
      const int tt = i / vb, cc = i - tt * vb;
      sv[tt * VB + cc] = v[(row0 + (size_t)(t0 + tt) * H) * V + v0 + cc];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float* qt = sq + tt * K;
      const float* kt = sk + tt * K;
      const float* wt = sw + tt * K;
      const float vt = active ? sv[tt * VB + c] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = lane + j * L;
        if (r < K) {
          const float kv = kt[r] * vt;
          if (kRwkv) {
            acc = fmaf(qt[r], fmaf(su[r], kv, S[j]), acc);
            S[j] = fmaf(wt[r], S[j], kv);
          } else {
            S[j] = fmaf(wt[r], S[j], kv);
            acc = fmaf(qt[r], S[j], acc);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (active && lane == 0)
        y[(row0 + (size_t)(t0 + tt) * H) * V + col] = acc;
    }
  }

  float* s_o = s_out + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + j * L;
    if (active && r < K) s_o[(size_t)r * V + col] = S[j];
  }
}

template <int R, int L, bool kRwkv>
int launch_one(int BH, int K, int V, cudaStream_t st, const float* q,
               const float* k, const float* v, const float* lw,
               const float* u, const float* s0, float* y, float* s_out, int T,
               int H, int w_scalar) {
  constexpr int VB = kMaxThreads / L;
  auto kernel = wkv_kernel<R, L, kRwkv>;
  const size_t smem = sizeof(float) * smem_floats(K, VB);
  // raised once per instantiation to the most any K takes; a failure is
  // kept and returned by every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats(kMaxDim, VB)));
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  const int threads = (((V < VB ? V : VB) * L + 31) / 32) * 32;
  const dim3 grid(BH, (V + VB - 1) / VB);
  kernel<<<grid, threads, smem, st>>>(q, k, v, lw, u, s0, y, s_out, T, H, K,
                                      V, w_scalar);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int L>
int launch_r(bool rwkv, int BH, int K, int V, cudaStream_t st,
             const float* q, const float* k, const float* v, const float* lw,
             const float* u, const float* s0, float* y, float* s_out, int T,
             int H, int w_scalar) {
  if (rwkv)
    return launch_one<R, L, true>(BH, K, V, st, q, k, v, lw, u, s0, y, s_out,
                                  T, H, w_scalar);
  return launch_one<R, L, false>(BH, K, V, st, q, k, v, lw, u, s0, y, s_out,
                                 T, H, w_scalar);
}

}  // namespace

// q, k [B,T,H,K], v [B,T,H,V], logw [B,T,H,K] (w_scalar = 0) or [B,T,H,1]
// (w_scalar = 1), u [H,K] (rwkv = 1; may be null for rwkv = 0), s0 and s_out
// [B,H,K,V] (may be the same buffer), y [B,T,H,V]: all fp32, contiguous.
// K <= 512, any V. Returns the CUDA error of the launch (0 on success).
extern "C" int wkv_scan(const float* q, const float* k, const float* v,
                        const float* logw, const float* u, const float* s0,
                        float* y, float* s_out, int B, int T, int H, int K,
                        int V, int w_scalar, int rwkv, void* stream) {
  if (B < 1 || T < 1 || H < 1 || K < 1 || V < 1 || K > kMaxDim ||
      (rwkv && u == nullptr) || (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rk = rwkv != 0;
#define WKV_LAUNCH(R, L)                                                     \
  return launch_r<R, L>(rk, BH, K, V, st, q, k, v, logw, u, s0, y, s_out, T, \
                        H, w_scalar)
  if (K <= 4) WKV_LAUNCH(1, 4);
  if (K <= 8) WKV_LAUNCH(2, 4);
  if (K <= 16) WKV_LAUNCH(4, 4);
  if (K <= 32) WKV_LAUNCH(8, 4);
  if (K <= 64) WKV_LAUNCH(16, 4);
  if (K <= 128) WKV_LAUNCH(32, 4);
  if (K <= 256) WKV_LAUNCH(32, 8);
  WKV_LAUNCH(32, 16);
#undef WKV_LAUNCH
}
