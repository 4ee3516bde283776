// Fused Gatekeeper-loss statistics for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `gatekeeper_loss_tokens`
// (src/repro/kernels/gatekeeper_loss.py). For hidden states x [T, d] and
// the unembedding table [V, d] (both fp32) and targets [T] int32 it
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
// V = 92544: 11.6 ms at the 67 TFLOP/s fp32 rate off the tensor cores),
// against one read of the 758 MB table (0.23 ms). So it is bound by
// operations, and the design is an fp32 SIMT GEMM with the reductions
// folded into its epilogue:
//
//   * Kernel 1 (partials). A CTA of 256 threads owns 128 tokens and one
//     split of the vocabulary (a run of 128-column tiles). For each tile
//     it computes the [128, 128] logits tile in registers (8 x 8 per
//     thread, from 8-deep slices of x and the table staged through double
//     buffered shared memory), then folds the tile into per-thread running
//     (m, s, w, first argmax) for its 8 rows and 8 columns. The running
//     max is the argmax value, and a thread sees its columns in increasing
//     order, so a strict '>' keeps the first index. The target logit is
//     written to shared memory by the one thread that owns its column. At
//     the end of the split the 16 threads that share rows merge their
//     stats with shuffles (equal maxima keep the lower index) and write
//     one partial per (split, token).
//   * Kernel 2 (merge). One thread per token combines the splits:
//     m = max m_i, s = sum s_i e^{m_i - m}, w = sum w_i e^{m_i - m}; the
//     argmax is that of the first split reaching m, so ties resolve to the
//     lowest vocabulary index, as in JAX.
//
// The TPU grid walks the vocabulary in order for each token block. Here
// the vocabulary is split across CTAs as well, so that T / 128 token
// blocks (16 at T = 2048) times the splits fill the 132 SMs. blockIdx.x
// runs over token blocks, so the CTAs of one vocabulary split run side by
// side and share its table slice through the 50 MB L2. Token and
// vocabulary tails are masked in the kernel (no padding to a tile).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 128;      // tokens per CTA
constexpr int VB = 128;      // vocabulary columns per tile
constexpr int DK = 8;        // depth of one shared-memory stage
constexpr int THREADS = 256;
constexpr int PAD = 4;       // keeps the transposed stores conflict-free
constexpr float NEG = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

// row i (0..7) of a thread: ty*4 + (i & 3) + (i >> 2) * 64; column j
// likewise with tx, so the float4 shared-memory reads of a warp are
// broadcasts (x) or contiguous (table)
__device__ __forceinline__ int lane_offset(int lane, int i) {
  return lane * 4 + (i & 3) + (i >> 2) * 64;
}

__device__ __forceinline__ float4 load4(const float* __restrict__ base,
                                        int row, int n_rows, int k, int d) {
  if (row < n_rows && k < d)
    return *reinterpret_cast<const float4*>(base + (size_t)row * d + k);
  return make_float4(0.f, 0.f, 0.f, 0.f);
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

__global__ void __launch_bounds__(THREADS)
gk_partial_kernel(const float* __restrict__ x, const float* __restrict__ table,
                  const int* __restrict__ targets, int T, int V, int d,
                  int tiles_per_split, float* __restrict__ pm,
                  float* __restrict__ ps, float* __restrict__ pw,
                  int* __restrict__ pidx, float* __restrict__ ptl) {
  __shared__ __align__(16) float xs[2][DK][TB + PAD];
  __shared__ __align__(16) float ts[2][DK][VB + PAD];
  __shared__ float tl_s[TB];
  __shared__ int tgt_s[TB];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * TB;
  const int split = blockIdx.y;
  const int v_begin = split * tiles_per_split * VB;
  const int v_end = min(V, v_begin + tiles_per_split * VB);
  // global -> shared staging: one float4 along depth per thread and array
  const int lr = tid >> 1, lk = (tid & 1) * 4;

  if (tid < TB) {
    tgt_s[tid] = t0 + tid < T ? targets[t0 + tid] : -1;
    tl_s[tid] = 0.f;
  }
  float m[8], s[8], w[8];
  int idx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG; s[i] = 0.f; w[i] = 0.f; idx[i] = NO_INDEX;
  }

  for (int v0 = v_begin; v0 < v_end; v0 += VB) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 xr = load4(x, t0 + lr, T, lk, d);
    float4 tr = load4(table, v0 + lr, V, lk, d);
    __syncthreads();        // the previous tile's last stage is read
    int buf = 0;
    xs[0][lk + 0][lr] = xr.x; xs[0][lk + 1][lr] = xr.y;
    xs[0][lk + 2][lr] = xr.z; xs[0][lk + 3][lr] = xr.w;
    ts[0][lk + 0][lr] = tr.x; ts[0][lk + 1][lr] = tr.y;
    ts[0][lk + 2][lr] = tr.z; ts[0][lk + 3][lr] = tr.w;
    __syncthreads();

    for (int k0 = 0; k0 < d; k0 += DK) {
      const bool more = k0 + DK < d;
      if (more) {
        xr = load4(x, t0 + lr, T, k0 + DK + lk, d);
        tr = load4(table, v0 + lr, V, k0 + DK + lk, d);
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ts[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ts[buf][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) {
        const int nb = buf ^ 1;
        xs[nb][lk + 0][lr] = xr.x; xs[nb][lk + 1][lr] = xr.y;
        xs[nb][lk + 2][lr] = xr.z; xs[nb][lk + 3][lr] = xr.w;
        ts[nb][lk + 0][lr] = tr.x; ts[nb][lk + 1][lr] = tr.y;
        ts[nb][lk + 2][lr] = tr.z; ts[nb][lk + 3][lr] = tr.w;
        __syncthreads();
        buf = nb;
      }
    }

    // fold the finished tile into the running row statistics
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = lane_offset(ty, i);
      const int tg = tgt_s[r];
      float bm = NEG;
      int bi = NO_INDEX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = v0 + lane_offset(tx, j);
        if (col < V && acc[i][j] > bm) { bm = acc[i][j]; bi = col; }
        if (col == tg) tl_s[r] = acc[i][j];
      }
      const float mn = fmaxf(m[i], bm);
      float ss = 0.f, ww = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (v0 + lane_offset(tx, j) < V) {
          const float p = expf(acc[i][j] - mn);
          ss += p;
          ww = fmaf(p, acc[i][j], ww);
        }
      }
      const float sc = expf(m[i] - mn);
      s[i] = fmaf(s[i], sc, ss);
      w[i] = fmaf(w[i], sc, ww);
      if (bm > m[i]) idx[i] = bi;
      m[i] = mn;
    }
  }

  // merge the 16 threads (one half-warp) that share each row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, w[i], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx[i], off);
      merge_stats(m[i], s[i], w[i], idx[i], m2, s2, w2, i2);
    }
    const int t = t0 + lane_offset(ty, i);
    if (tx == 0 && t < T) {
      const size_t o = (size_t)split * T + t;
      pm[o] = m[i]; ps[o] = s[i]; pw[o] = w[i]; pidx[o] = idx[i];
    }
  }
  __syncthreads();
  if (tid < TB && t0 + tid < T) ptl[(size_t)split * T + t0 + tid] = tl_s[tid];
}

__global__ void gk_merge_kernel(const float* __restrict__ pm,
                                const float* __restrict__ ps,
                                const float* __restrict__ pw,
                                const int* __restrict__ pidx,
                                const float* __restrict__ ptl,
                                const int* __restrict__ targets, int T, int V,
                                int n_splits, int span, float log_v,
                                float* __restrict__ ce, float* __restrict__ kl,
                                float* __restrict__ corr,
                                float* __restrict__ ent,
                                float* __restrict__ lse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float m = NEG;
  for (int sp = 0; sp < n_splits; ++sp) m = fmaxf(m, pm[(size_t)sp * T + t]);
  float s = 0.f, w = 0.f;
  int idx = NO_INDEX;
  for (int sp = 0; sp < n_splits; ++sp) {
    const size_t o = (size_t)sp * T + t;
    const float e = expf(pm[o] - m);
    s = fmaf(ps[o], e, s);
    w = fmaf(pw[o], e, w);
    if (idx == NO_INDEX && pm[o] == m) idx = pidx[o];
  }
  const int tg = targets[t];
  const float tl = (tg >= 0 && tg < V) ? ptl[(size_t)(tg / span) * T + t] : 0.f;
  const float l = m + logf(s);
  const float h = l - w / s;
  ce[t] = l - tl;
  kl[t] = log_v - h;
  corr[t] = idx == tg ? 1.f : 0.f;
  ent[t] = h;
  lse[t] = l;
}

}  // namespace

// scratch: 5 * n_splits * T four-byte words (partial m, s, w, argmax index,
// target logit). Returns the CUDA error of the launches (0 on success).
extern "C" int gatekeeper_loss_tokens(const float* x, const float* table,
                                      const int* targets, float* ce, float* kl,
                                      float* corr, float* ent, float* lse,
                                      float* scratch, int T, int V, int d,
                                      int tiles_per_split, int n_splits,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)n_splits * T;
  float* pm = scratch;
  float* ps = scratch + n;
  float* pw = scratch + 2 * n;
  int* pidx = reinterpret_cast<int*>(scratch + 3 * n);
  float* ptl = scratch + 4 * n;
  dim3 grid((T + TB - 1) / TB, n_splits);
  gk_partial_kernel<<<grid, THREADS, 0, st>>>(x, table, targets, T, V, d,
                                              tiles_per_split, pm, ps, pw,
                                              pidx, ptl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float log_v = static_cast<float>(log(static_cast<double>(V)));
  gk_merge_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      pm, ps, pw, pidx, ptl, targets, T, V, n_splits, tiles_per_split * VB,
      log_v, ce, kl, corr, ent, lse);
  return static_cast<int>(cudaGetLastError());
}
