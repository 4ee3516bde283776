// Paged MLA flash-decode for Hopper (sm_90a): weight-absorbed multi-head
// latent attention read straight from the block-paged compressed cache.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes by repro_torch/kernels/paged_attention.py.
// The entry point launches on the caller's stream and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// paged_flash_decode_mla replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_flash_decode_mla (_mla_kernel).
// Per row b and query head h it computes a softmax over the positions
// idx <= pos[b] whose page id is nonzero, with score
// (q_abs . ckv_n + q_rope . kr) * scale, where ckv_n is the cached latent
// rms-normed in fp32 with (1 + kv_norm), and value ckv_n itself. The output
// is the fp32 latent context [B,1,H,r]; a row with no valid position gives
// exact zeros (denominator max(l, 1e-30)).
//
//   Bound: operations. All H query heads share one latent per position, so
//   each cached element read feeds every head: 2*H*(r+dr) + 2*H*r flops per
//   position against (r+dr) elements, above the card's fp32 ops-per-byte
//   balance at H = 128. With bf16 operands at the tensor cores' bf16 rate
//   the bytes bound instead; this kernel computes in fp32 SIMT.
//   The TPU kernel keeps an [H, r] fp32 accumulator (256 KiB at H=128,
//   r=512) in VMEM for the whole row. That exceeds a CTA's shared memory, so
//   here the grid is (head group of kHeads, row): each CTA walks its row's
//   pages (skipping page 0 and pages wholly past pos), rms-norms each
//   [bs, r] ckv block once into shared memory, keeps one fp32 online softmax
//   per head, and holds its [kHeads, r] accumulator in registers (thread t
//   owns latent columns t, t + 256). Per page: each warp norms and scores
//   its tokens (its lanes hold the token's normed latent in registers, the
//   heads' queries come from shared memory, the heads' warp reductions
//   interleaved); warp h runs head h's softmax update; then every thread
//   accumulates p @ ckv_n into its columns. The page's ckv rows are re-read by the
//   H / kHeads CTAs of a row, from L2. wgmma on the heads-by-latent
//   products, TMA page loads and splitting long rows across CTAs are later
//   work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kHeads = 8;                   // query heads per CTA
constexpr int kThreads = 256;               // 8 warps: warp h owns head h's softmax
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 512;                  // latent width (kv_lora)
constexpr int kMaxDr = 64;                  // rope width
constexpr int kMaxBs = 32;                  // tokens per page (one lane each)
constexpr int kCols = kMaxR / kThreads;     // accumulator columns per thread
constexpr int kRRegs = kMaxR / 32;          // latent values per lane
constexpr int kDrRegs = kMaxDr / 32;
static_assert(kHeads == kWarps, "one softmax warp per head");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (ceil(H / kHeads), B), block kThreads. Shared, all fp32:
//   q_s [kHeads][r], qr_s [kHeads][dr], w_s [r]    (once per CTA)
//   ckv_s [bs][r]                                  (normed page block)
//   p_s [kHeads][bs], alpha_s [kHeads], l_s [kHeads]
template <typename KT>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const void* __restrict__ q_abs, const void* __restrict__ q_rope,
                  const KT* __restrict__ ckv_pages,
                  const KT* __restrict__ kr_pages,
                  const void* __restrict__ kv_norm,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ pos, float* __restrict__ out,
                  int H, int M, int bs, int r, int dr, float scale, float eps,
                  int qa_bf16, int qr_bf16, int w_bf16) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* qr_s = q_s + kHeads * r;
  float* w_s = qr_s + kHeads * dr;
  float* ckv_s = w_s + r;
  float* p_s = ckv_s + bs * r;
  float* alpha_s = p_s + kHeads * bs;
  float* l_s = alpha_s + kHeads;

  const int h0 = blockIdx.x * kHeads;
  const int nh = min(kHeads, H - h0);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < kHeads * r; i += kThreads) {
    const int h = i / r;
    q_s[i] = h < nh ? load_f32(q_abs, ((size_t)b * H + h0 + h) * r + i % r,
                               qa_bf16)
                    : 0.f;
  }
  for (int i = tid; i < kHeads * dr; i += kThreads) {
    const int h = i / dr;
    qr_s[i] = h < nh ? load_f32(q_rope, ((size_t)b * H + h0 + h) * dr + i % dr,
                                qr_bf16)
                     : 0.f;
  }
  for (int i = tid; i < r; i += kThreads) w_s[i] = 1.f + load_f32(kv_norm, i, w_bf16);
  __syncthreads();

  float acc[kHeads][kCols];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[h][c] = 0.f;
  float m_run = kNeg, l_run = 0.f;  // head `warp`'s softmax state
  const int p = pos[b];
  const float inv_r = 1.f / (float)r;

  for (int mb = 0; mb < M && mb * bs <= p; ++mb) {
    const int page = tables[(size_t)b * M + mb];
    if (page <= 0) continue;  // unmapped: trash contents never contribute
    const KT* ckv_blk = ckv_pages + (size_t)page * bs * r;
    const KT* kr_blk = kr_pages + (size_t)page * bs * dr;

    // 1. norm + scores: warp w takes tokens w, w + kWarps, ...
    for (int t = warp; t < bs; t += kWarps) {
      if (mb * bs + t > p) {  // past the row's position: weight exactly 0
        for (int k = lane; k < r; k += 32) ckv_s[t * r + k] = 0.f;
        if (lane < kHeads) p_s[lane * bs + t] = kNeg;
        continue;
      }
      float x[kRRegs], kx[kDrRegs];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kRRegs; ++i) {
        const int k = lane + 32 * i;
        x[i] = k < r ? to_f32(ckv_blk[(size_t)t * r + k]) : 0.f;
        ss += x[i] * x[i];
      }
#pragma unroll
      for (int i = 0; i < kDrRegs; ++i) {
        const int k = lane + 32 * i;
        kx[i] = k < dr ? to_f32(kr_blk[(size_t)t * dr + k]) : 0.f;
      }
      const float inv = rsqrtf(warp_sum(ss) * inv_r + eps);
#pragma unroll
      for (int i = 0; i < kRRegs; ++i) {
        const int k = lane + 32 * i;
        if (k < r) {
          x[i] = x[i] * inv * w_s[k];
          ckv_s[t * r + k] = x[i];
        }
      }
      // all kHeads heads at once (rows past nh are zero queries), so the
      // heads' warp reductions interleave instead of running in series
      float part[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        part[h] = 0.f;
#pragma unroll
        for (int i = 0; i < kRRegs; ++i) {
          const int k = lane + 32 * i;
          if (k < r) part[h] += q_s[h * r + k] * x[i];
        }
#pragma unroll
        for (int i = 0; i < kDrRegs; ++i) {
          const int k = lane + 32 * i;
          if (k < dr) part[h] += qr_s[h * dr + k] * kx[i];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], o);
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        if (lane == h) p_s[h * bs + t] = part[h] * scale;
    }
    __syncthreads();

    // 2. online softmax update: warp h, one lane per token
    if (warp < nh) {
      const bool valid = lane < bs && mb * bs + lane <= p;
      const float s = valid ? p_s[warp * bs + lane] : kNeg;
      const float m_new = fmaxf(m_run, warp_max(s));
      const float e = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + warp_sum(e);
      m_run = m_new;
      if (lane < bs) p_s[warp * bs + lane] = e;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + p @ ckv_n over this thread's columns
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const float a = alpha_s[h];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[h][c] *= a;
    }
    for (int t = 0; t < bs; ++t) {
      float pt[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) pt[h] = p_s[h * bs + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tid + c * kThreads;
        if (col < r) {
          const float v = ckv_s[t * r + col];
#pragma unroll
          for (int h = 0; h < kHeads; ++h) acc[h][c] += pt[h] * v;
        }
      }
    }
    __syncthreads();  // ckv_s / p_s are overwritten by the next page
  }

  if (warp < nh && lane == 0) l_s[warp] = l_run;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = tid + c * kThreads;
    if (col < r) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        if (h < nh)
          out[((size_t)b * H + h0 + h) * r + col] =
              acc[h][c] / fmaxf(l_s[h], 1e-30f);  // all-trash row -> 0
    }
  }
}

size_t smem_bytes(int r, int dr, int bs) {
  return sizeof(float) * ((size_t)kHeads * (r + dr + bs + 2) + r +
                          (size_t)bs * r);
}

template <typename KT>
int launch(const void* qa, const void* qr, const void* ckv, const void* kr,
           const void* w, const int32_t* tables, const int32_t* pos,
           float* out, int B, int H, int M, int bs, int r, int dr, float scale,
           float eps, int qa_bf16, int qr_bf16, int w_bf16,
           cudaStream_t stream) {
  // raised once per instantiation, to the largest shape the entry point
  // accepts; a failure is kept and returned by every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      mla_decode_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxR, kMaxDr, kMaxBs));
  if (attr_err != cudaSuccess) return (int)attr_err;
  const size_t smem = smem_bytes(r, dr, bs);
  dim3 grid((H + kHeads - 1) / kHeads, B);
  mla_decode_kernel<KT><<<grid, kThreads, smem, stream>>>(
      qa, qr, static_cast<const KT*>(ckv), static_cast<const KT*>(kr), w,
      tables, pos, out, H, M, bs, r, dr, scale, eps, qa_bf16, qr_bf16, w_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_abs [B,1,H,r]; q_rope [B,1,H,dr]; ckv pages [N+1,bs,r]; kr pages
// [N+1,bs,dr]; kv_norm [r]; tables [B,M] int32; pos [B] int32; out
// [B,1,H,r] float32. *_bf16: 0 = float32, 1 = bfloat16 (ckv and kr pages
// share one type).
int paged_flash_decode_mla(const void* q_abs, const void* q_rope,
                           const void* ckv_pages, const void* kr_pages,
                           const void* kv_norm, const void* tables,
                           const void* pos, void* out, int B, int H, int M,
                           int bs, int r, int dr, float scale, float eps,
                           int qa_bf16, int qr_bf16, int kv_bf16, int w_bf16,
                           void* stream) {
  if (r < 1 || r > kMaxR || dr < 0 || dr > kMaxDr || bs < 1 || bs > kMaxBs)
    return (int)cudaErrorInvalidValue;
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(q_abs, q_rope, ckv_pages, kr_pages, kv_norm,
                                 t, ps, o, B, H, M, bs, r, dr, scale, eps,
                                 qa_bf16, qr_bf16, w_bf16, s);
  return launch<float>(q_abs, q_rope, ckv_pages, kr_pages, kv_norm, t, ps, o,
                       B, H, M, bs, r, dr, scale, eps, qa_bf16, qr_bf16,
                       w_bf16, s);
}

}  // extern "C"
