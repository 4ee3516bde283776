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
// stream and walks all its tokens itself, with S in registers from the
// first token to the last:
//
//   * 4 adjacent lanes share one value column v of S; lane p holds rows
//     k = p, p + 4, ... (R = ceil(K / 4) registers, R a power of two up to
//     32, so K, V <= 128 and at most 512 threads). y_t[v] is their partial
//     dot products summed with two xor shuffles.
//   * 16 tokens at a time of q, k, exp(logw) and v are staged in shared
//     memory by coalesced loads; u is staged once. Then every thread steps
//     through the 16 tokens with no barrier between them.
//   * Any T >= 1 runs, T = 1 (decode) included: the last stage is short,
//     never a chunk that must divide T.
//   * logw is [.., K] or, for the scalar per-head decay of Mamba2, [.., 1]
//     (`w_scalar`), read once per token and used for every row.
//   * Each CTA reads its slice of s0 before its first token and writes its
//     slice of s_out after its last, so s_out may be s0 (in place).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;       // lanes sharing one value column
constexpr int kStage = 16;      // tokens staged in shared memory at once
constexpr int kMaxDim = 128;    // largest K and V
constexpr int kMaxThreads = kMaxDim * kLanes;

template <int R, bool kRwkv>
__global__ void __launch_bounds__(kMaxThreads)
wkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* s0, float* __restrict__ y,
           float* s_out, int T, int H, int K, int V, int w_scalar) {
  __shared__ float sq[kStage * kMaxDim];
  __shared__ float sk[kStage * kMaxDim];
  __shared__ float sw[kStage * kMaxDim];
  __shared__ float sv[kStage * kMaxDim];
  __shared__ float su[kMaxDim];

  const int bh = blockIdx.x;                  // stream b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int col = tid / kLanes, lane = tid % kLanes;
  const bool active = col < V;
  // token t of the stream is row (b * T + t) * H + h of the [B,T,H,*] inputs
  const size_t row0 = (size_t)b * T * H + h;
  const int wK = w_scalar ? 1 : K;

  float S[R];
  const float* s_in = s0 + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + j * kLanes;
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
    for (int i = tid; i < n * V; i += nthreads) {
      const int tt = i / V, c = i - tt * V;
      sv[i] = v[(row0 + (size_t)(t0 + tt) * H) * V + c];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float* qt = sq + tt * K;
      const float* kt = sk + tt * K;
      const float* wt = sw + tt * K;
      const float vt = active ? sv[tt * V + col] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = lane + j * kLanes;
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
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (active && lane == 0)
        y[(row0 + (size_t)(t0 + tt) * H) * V + col] = acc;
    }
  }

  float* s_o = s_out + (size_t)bh * K * V;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + j * kLanes;
    if (active && r < K) s_o[(size_t)r * V + col] = S[j];
  }
}

template <int R>
int launch_r(bool rwkv, dim3 grid, int threads, cudaStream_t st,
             const float* q, const float* k, const float* v, const float* lw,
             const float* u, const float* s0, float* y, float* s_out, int T,
             int H, int K, int V, int w_scalar) {
  if (rwkv)
    wkv_kernel<R, true><<<grid, threads, 0, st>>>(q, k, v, lw, u, s0, y,
                                                  s_out, T, H, K, V, w_scalar);
  else
    wkv_kernel<R, false><<<grid, threads, 0, st>>>(q, k, v, lw, u, s0, y,
                                                   s_out, T, H, K, V,
                                                   w_scalar);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k [B,T,H,K], v [B,T,H,V], logw [B,T,H,K] (w_scalar = 0) or [B,T,H,1]
// (w_scalar = 1), u [H,K] (rwkv = 1; may be null for rwkv = 0), s0 and s_out
// [B,H,K,V] (may be the same buffer), y [B,T,H,V]: all fp32, contiguous.
// Returns the CUDA error of the launch (0 on success).
extern "C" int wkv_scan(const float* q, const float* k, const float* v,
                        const float* logw, const float* u, const float* s0,
                        float* y, float* s_out, int B, int T, int H, int K,
                        int V, int w_scalar, int rwkv, void* stream) {
  if (B < 1 || T < 1 || H < 1 || K < 1 || V < 1 || K > kMaxDim ||
      V > kMaxDim || (rwkv && u == nullptr) ||
      (long long)B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (K + kLanes - 1) / kLanes;
  const int threads = ((V * kLanes + 31) / 32) * 32;
  const dim3 grid(B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rk = rwkv != 0;
#define WKV_LAUNCH(R)                                                        \
  return launch_r<R>(rk, grid, threads, st, q, k, v, logw, u, s0, y, s_out, \
                     T, H, K, V, w_scalar)
  if (per_lane <= 1) WKV_LAUNCH(1);
  if (per_lane <= 2) WKV_LAUNCH(2);
  if (per_lane <= 4) WKV_LAUNCH(4);
  if (per_lane <= 8) WKV_LAUNCH(8);
  if (per_lane <= 16) WKV_LAUNCH(16);
  WKV_LAUNCH(32);
#undef WKV_LAUNCH
}
