// Paged decode kernels for Hopper (sm_90a): one-token GQA attention read
// straight from the block-paged KV cache, and the single-token paged write.
//
// Plain C interface (no PyTorch headers), built with nvcc into a shared
// library and called through ctypes by repro_torch/kernels/paged_attention.py.
// Every entry point launches on the caller's stream and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// paged_flash_decode_gqa replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_flash_decode_gqa (_gqa_kernel).
//   Bound: bytes. Each row reads its valid K/V prefix once; the arithmetic
//   is 4 * group * hd flops per K/V element pair, far below the card's
//   ops-per-byte balance, so the design goal is many K/V loads in flight.
//   The TPU kernel walks the page table along a sequential grid axis
//   carrying (m, l, acc) in VMEM; here one CTA per (KV head, row) splits
//   the row's valid tokens across its warps, each warp keeping its own
//   fp32 online softmax (m, l in registers, acc in shared memory) with no
//   block barrier inside the token loop, and the warps' partials are merged
//   once at the end. Tokens in unmapped pages (id 0) or past the row's
//   position are never read. A token's K or V row for one KV head is hd
//   contiguous elements, read by consecutive lanes. Splitting a row across
//   CTAs (flash-decoding), vectorised loads, TMA and wgmma are later work.
//
// paged_write_token replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_write_token (_write_kernel).
//   Bound: bytes (one token row of KV * hd elements per batch row). One CTA
//   per row writes in place into the physical block selected through the
//   page table; nothing else of the cache moves (the TPU version aliases
//   input and output for the same reason).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxGroup = 8;      // query heads per KV head
constexpr int kDecodeWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// grid (KV, B), block kDecodeWarps warps. Each warp runs its own online
// softmax over tokens warp, warp + n_warps, ... of the row's valid prefix
// (no block barrier inside the loop); the warps' (m, l, acc) partials are
// merged at the end. Shared: q [group*hd], acc [n_warps][group*hd],
// m/l [n_warps][2*group] — all fp32. Lanes own d = lane + 32*i of every
// head row, so q/acc shared-memory accesses are bank-conflict free.
template <typename QT, typename KT>
__global__ void gqa_decode_kernel(const QT* __restrict__ q,
                                  const KT* __restrict__ kp,
                                  const KT* __restrict__ vp,
                                  const int32_t* __restrict__ tables,
                                  const int32_t* __restrict__ pos,
                                  QT* __restrict__ out, int M, int bs, int KV,
                                  int group, int hd, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int gh = group * hd;
  float* q_s = smem;
  float* acc_all = q_s + gh;
  float* ml_s = acc_all + (size_t)n_warps * gh;
  float* acc = acc_all + (size_t)warp * gh;

  const int H = KV * group;
  // query heads kvh*group .. kvh*group+group-1 are contiguous in q[b, 0]
  const QT* q_row = q + (size_t)b * H * hd + (size_t)kvh * gh;
  for (int i = threadIdx.x; i < gh; i += blockDim.x) q_s[i] = to_f32(q_row[i]);
  for (int i = threadIdx.x; i < n_warps * gh; i += blockDim.x) acc_all[i] = 0.f;
  __syncthreads();

  float m[kMaxGroup], l[kMaxGroup], s[kMaxGroup], alpha[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
  }
  const int p = pos[b];
  const int n_tok = p < 0 ? 0 : min(M * bs, p + 1);   // positions idx <= pos
  const size_t tok_stride = (size_t)KV * hd;
  for (int t = warp; t < n_tok; t += n_warps) {
    const int page = tables[(size_t)b * M + t / bs];
    if (page <= 0) continue;  // unmapped: trash contents never contribute
    const size_t row = ((size_t)page * bs + t % bs) * tok_stride +
                       (size_t)kvh * hd;
    const KT* k_row = kp + row;
    const KT* v_row = vp + row;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float kd = to_f32(k_row[d]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) s[g] += q_s[g * hd + d] * kd;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float sg = warp_sum(s[g]) * scale;  // every lane holds it
        const float m_new = fmaxf(m[g], sg);
        alpha[g] = expf(m[g] - m_new);
        s[g] = expf(sg - m_new);
        l[g] = l[g] * alpha[g] + s[g];
        m[g] = m_new;
      }
    }
    for (int d = lane; d < hd; d += 32) {
      const float vd = to_f32(v_row[d]);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g * hd + d] = acc[g * hd + d] * alpha[g] + s[g] * vd;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        ml_s[warp * 2 * group + g] = m[g];
        ml_s[warp * 2 * group + group + g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps' partial softmaxes, one thread per (head, d) element
  QT* o_row = out + (size_t)b * H * hd + (size_t)kvh * gh;
  for (int i = threadIdx.x; i < gh; i += blockDim.x) {
    const int g = i / hd;
    float m_all = kNeg;
    for (int w = 0; w < n_warps; ++w) m_all = fmaxf(m_all, ml_s[w * 2 * group + g]);
    float l_all = 0.f, a = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float f = expf(ml_s[w * 2 * group + g] - m_all);
      l_all += ml_s[w * 2 * group + group + g] * f;
      a += acc_all[(size_t)w * gh + i] * f;
    }
    o_row[i] = from_f32<QT>(a / fmaxf(l_all, 1e-30f));  // all-trash row -> 0
  }
}

// grid (B,): row b writes values[b, :F] into leaf[phys, pos % bs, :F].
template <typename LT, typename VT>
__global__ void write_token_kernel(LT* __restrict__ leaf,
                                   const VT* __restrict__ vals,
                                   const int32_t* __restrict__ tables,
                                   const int32_t* __restrict__ pos, int M,
                                   int bs, int64_t F) {
  const int b = blockIdx.x;
  const int p = pos[b];
  const int blk = min(max(floor_div(p, bs), 0), M - 1);
  const int phys = tables[(size_t)b * M + blk];
  const int off = p - floor_div(p, bs) * bs;
  LT* dst = leaf + ((int64_t)phys * bs + off) * F;
  const VT* src = vals + (int64_t)b * F;
  for (int64_t i = threadIdx.x; i < F; i += blockDim.x)
    dst[i] = from_f32<LT>(to_f32(src[i]));
}

constexpr int kWriteThreads = 256;

template <typename QT, typename KT>
void launch_decode(const void* q, const void* kp, const void* vp,
                   const int32_t* tables, const int32_t* pos, void* out, int B,
                   int M, int bs, int KV, int group, int hd, float scale,
                   size_t smem, cudaStream_t stream) {
  dim3 grid(KV, B);
  gqa_decode_kernel<QT, KT><<<grid, 32 * kDecodeWarps, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), tables, pos, static_cast<QT*>(out), M, bs,
      KV, group, hd, scale);
}

template <typename LT, typename VT>
void launch_write(void* leaf, const void* vals, const int32_t* tables,
                  const int32_t* pos, int B, int M, int bs, int64_t F,
                  cudaStream_t stream) {
  write_token_kernel<LT, VT><<<B, kWriteThreads, 0, stream>>>(
      static_cast<LT*>(leaf), static_cast<const VT*>(vals), tables, pos, M, bs,
      F);
}

}  // namespace

extern "C" {

// q [B,1,H,hd]; k/v pages [N+1,bs,KV,hd]; tables [B,M] int32; pos [B] int32;
// out [B,1,H,hd] in q's type. q_bf16 / kv_bf16: 0 = float32, 1 = bfloat16.
int paged_flash_decode_gqa(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* pos, void* out,
                           int B, int M, int bs, int KV, int group, int hd,
                           float scale, int q_bf16, int kv_bf16,
                           void* stream) {
  if (group < 1 || group > kMaxGroup) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)group * hd * (1 + kDecodeWarps) +
                                       2 * (size_t)group * kDecodeWarps);
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    launch_decode<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, t, ps, out, B, M,
                                                bs, KV, group, hd, scale, smem,
                                                s);
  else if (q_bf16)
    launch_decode<__nv_bfloat16, float>(q, kp, vp, t, ps, out, B, M, bs, KV,
                                        group, hd, scale, smem, s);
  else if (kv_bf16)
    launch_decode<float, __nv_bfloat16>(q, kp, vp, t, ps, out, B, M, bs, KV,
                                        group, hd, scale, smem, s);
  else
    launch_decode<float, float>(q, kp, vp, t, ps, out, B, M, bs, KV, group,
                                hd, scale, smem, s);
  return (int)cudaGetLastError();
}

// leaf [N+1,bs,F] written in place; vals [B,F]; tables [B,M]; pos [B].
int paged_write_token(void* leaf, const void* vals, const void* tables,
                      const void* pos, int B, int M, int bs, int64_t F,
                      int leaf_bf16, int val_bf16, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leaf_bf16 && val_bf16)
    launch_write<__nv_bfloat16, __nv_bfloat16>(leaf, vals, t, ps, B, M, bs, F,
                                               s);
  else if (leaf_bf16)
    launch_write<__nv_bfloat16, float>(leaf, vals, t, ps, B, M, bs, F, s);
  else if (val_bf16)
    launch_write<float, __nv_bfloat16>(leaf, vals, t, ps, B, M, bs, F, s);
  else
    launch_write<float, float>(leaf, vals, t, ps, B, M, bs, F, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
