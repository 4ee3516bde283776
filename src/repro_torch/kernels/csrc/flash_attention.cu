// Flash attention for prefill on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py). For q [B,T,H,hd] and k, v
// [B,S,KV,hd] (GQA: KV head = query head // (H / KV)) it computes
//
//   out[b,t,h] = softmax_s(q . k_s * scale over the visible s) @ v
//
// with query t at position q_offset + t; key s is visible when s < S and,
// if causal, s <= q_offset + t, and, with a window w > 0,
// s > q_offset + t - w. A row with no visible key gives zeros (denominator
// max(l, 1e-30)), as the TPU kernel does. Scores, probabilities and the
// P @ V accumulation are fp32 whatever the input type, and the output has
// q's type. q_offset = 0 is the TPU kernel's function; q_offset > 0 is the
// mask of a prefill chunk that starts at absolute position q_offset over a
// cache view of S positions (chunked prefill, shared prefixes).
//
// Bound on the card: 4 * hd flops per visible (query, key) pair for each
// head against 2 * hd elements of K and V per key and KV head, read by
// every query of the tile. At the main path's prefill chunk (8 rows, 128
// queries, 16 heads of 128, 288 keys) fp32 inputs are bound by operations
// at the SIMT rate; bf16 inputs, whose products the tensor cores could
// take at 15x that rate, are bound by their bytes. This kernel does all
// its arithmetic in fp32 on the SIMT cores, so operations hold it back in
// both cases (bf16 mma tiles are later work). The design is an fp32 SIMT
// flash attention, the TPU kernel's algorithm with tiles sized for an SM:
//
//   * One CTA of 256 threads (16 x 16) per (64-query tile, head, row). The
//     query tile is staged once in shared memory (fp32); then, for each
//     64-key tile, K is staged, each thread computes a 4 x 4 block of
//     scores from float4 reads (queries ty*4 + i, keys tx + 16 j), the 16 threads
//     of a row reduce its max and sum with shuffles, and the row's fp32
//     online softmax (m, l) rescales the accumulator; the probabilities go
//     to shared memory, V replaces K in the same buffer, and each thread
//     adds P @ V into its 4 rows x hd/16 columns held in registers.
//   * Key tiles that the causal or window mask hides from every query of
//     the tile are never loaded: the loop runs from the first tile the
//     window reaches to the last the causal bound reaches. The TPU kernel
//     visits every tile and masks.
//   * K and V share one buffer, so shared memory is 85 KB at hd 128 and two
//     CTAs fit an SM (147 KB and one CTA at hd 256); above 48 KB it is
//     dynamic, with the limit raised once per instantiation. Row strides
//     are padded by 4 floats, which keeps the float4 reads of a half-warp
//     on distinct banks.
//   * Any hd up to 256: the kernel is instantiated at the tile widths HD
//     that the supported configs use (16 and 32 reduced, 64 whisper / zamba2
//     / rwkv6, 96 phi-3-vision, 112 kimi-k2, 128 the rest) and at 256, and a
//     call takes the smallest HD >= hd. Columns past hd are staged as zeros,
//     so they add nothing to the scores, and are never stored; rows whose
//     hd is not a multiple of 4 are staged element by element.
//   * bf16 inputs are widened to fp32 while they are staged. Tensor-core
//     (wgmma) tiles, TMA loads and double buffering are later work; the
//     TPU kernel computes in fp32, and an fp32 product has no tensor-core
//     form at full precision.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per CTA
constexpr int KB = 64;          // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty owns 4 queries, tx 4 keys
constexpr float kNeg = -1e30f;

template <int HD> struct Layout {
  // row stride of q_s and kv_s in floats: RS / 4 is odd, so the float4
  // reads of 8 consecutive rows fall on distinct banks
  static constexpr int RS = HD + 4;
  static constexpr int PS = KB + 4;   // row stride of p_s
  static constexpr int CPT = HD / 16; // output columns per thread
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)(QB + KB) * RS + (size_t)QB * PS);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows r0 .. r0+63 of a [n_rows, hd] matrix whose rows lie row_stride
// elements apart -> dst [64][HD + 4] fp32; rows past n_rows and columns
// past hd are zeros. Vector loads when hd is a multiple of 4 (the rows are
// then 8- or 16-byte aligned), else one element at a time.
template <typename IT, int HD>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const IT* __restrict__ src, int r0,
                                      int n_rows, size_t row_stride, int hd) {
  constexpr int G = HD / 4;
  const bool vec = (hd & 3) == 0;
  for (int i = threadIdx.x; i < 64 * G; i += kThreads) {
    const int r = i / G, g = i % G;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && g * 4 < hd) {
      const IT* row = src + (size_t)(r0 + r) * row_stride + g * 4;
      if (vec) {
        v = load4(row);
      } else {
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = g * 4 + j < hd ? to_f32(row[j]) : 0.f;
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * Layout<HD>::RS + g * 4) = v;
  }
}

__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// column c (0 .. CPT-1) of thread tx in the output / V tile
template <int HD>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (HD % 64 == 0) return (c >> 2) * 64 + tx * 4 + (c & 3);
  else return tx * (HD / 16) + c;
}

// grid (ceil(T / QB), H, B), block kThreads, dynamic smem Layout<HD>::bytes;
// hd <= HD is the inputs' head dim
template <typename IT, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_fwd_kernel(const IT* __restrict__ q, const IT* __restrict__ k,
                 const IT* __restrict__ v, IT* __restrict__ out, int T, int S,
                 int H, int KV, int hd, float scale, int causal, int window,
                 int q_offset) {
  using L = Layout<HD>;
  constexpr int RS = L::RS, PS = L::PS, CPT = L::CPT;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [QB][RS]
  float* kv_s = q_s + QB * RS;         // [KB][RS]: K, then V, of one tile
  float* p_s = kv_s + KB * RS;         // [QB][PS] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const size_t q_rows = (size_t)H * hd, kv_rows = (size_t)KV * hd;
  const IT* qb = q + ((size_t)b * T * H + h) * hd;
  const IT* kb = k + ((size_t)b * S * KV + kh) * hd;
  const IT* vb = v + ((size_t)b * S * KV + kh) * hd;

  // keys any query of this tile can see
  const int p_lo = q_offset + t0;
  const int p_hi = q_offset + min(T, t0 + QB) - 1;
  const int s_end = causal ? min(S, p_hi + 1) : S;
  const int s_begin = window > 0 ? max(0, p_lo - window + 1) / KB * KB : 0;

  stage<IT, HD>(q_s, qb, t0, T, q_rows, hd);

  float o[4][CPT];
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNeg;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int s0 = s_begin; s0 < s_end; s0 += KB) {
    __syncthreads();                 // the previous tile's V and P are read
    stage<IT, HD>(kv_s, kb, s0, S, kv_rows, hd);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(q_s + (ty * 4 + i) * RS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = load4(kv_s + (tx + 16 * j) * RS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = sc[i][j];
          acc = fmaf(a[i].x, bk[j].x, acc);
          acc = fmaf(a[i].y, bk[j].y, acc);
          acc = fmaf(a[i].z, bk[j].z, acc);
          acc = fmaf(a[i].w, bk[j].w, acc);
          sc[i][j] = acc;
        }
    }

    // mask, then the rows' online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      const int qp = q_offset + t;
      unsigned vis = 0;
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = s0 + tx + 16 * j;
        const bool ok = t < T && kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        sc[i][j] = ok ? sc[i][j] * scale : kNeg;
        vis |= (unsigned)ok << j;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = row16_max(rmax);
      const float mn = fmaxf(m_r[i], rmax);
      const float alpha = expf(m_r[i] - mn);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (vis >> j) & 1u ? expf(sc[i][j] - mn) : 0.f;
        sc[i][j] = p;
        rsum += p;
      }
      rsum = row16_sum(rsum);
      l_r[i] = l_r[i] * alpha + rsum;
      m_r[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(ty * 4 + i) * PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();                 // every thread is done with K
    stage<IT, HD>(kv_s, vb, s0, S, kv_rows, hd);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < KB; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(p_s + (ty * 4 + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = kv_s + (kk + u) * RS;
        float vv[CPT];
        if constexpr (HD % 64 == 0) {
#pragma unroll
          for (int g = 0; g < CPT / 4; ++g) {
            const float4 x = load4(vrow + g * 64 + tx * 4);
            vv[4 * g] = x.x; vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z; vv[4 * g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) vv[c] = vrow[out_col<HD>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                        : u == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
        }
      }
    }
  }

  IT* ob = out + ((size_t)b * T * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);   // no visible key -> 0
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = out_col<HD>(tx, c);
      if (col < hd)
        ob[(size_t)t * q_rows + col] = from_f32<IT>(o[i][c] / denom);
    }
  }
}

template <typename IT, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int S, int H, int KV, int hd, float scale, int causal,
           int window, int q_offset, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<IT, HD>;
  // raised once per instantiation; a failure is kept and returned by
  // every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<HD>::bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((T + QB - 1) / QB, H, B);
  kernel<<<grid, kThreads, Layout<HD>::bytes, st>>>(
      static_cast<const IT*>(q), static_cast<const IT*>(k),
      static_cast<const IT*>(v), static_cast<IT*>(out), T, S, H, KV, hd,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// the smallest instantiated tile width HD >= hd
template <typename IT>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int T, int S, int H, int KV, float scale,
                int causal, int window, int q_offset, cudaStream_t st) {
#define FLASH_HD(W)                                                          \
  if (hd <= W)                                                               \
  return launch<IT, W>(q, k, v, out, B, T, S, H, KV, hd, scale, causal,      \
                       window, q_offset, st)
  FLASH_HD(16);
  FLASH_HD(32);
  FLASH_HD(64);
  FLASH_HD(96);
  FLASH_HD(112);
  FLASH_HD(128);
  FLASH_HD(256);
#undef FLASH_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B,T,H,hd], k and v [B,S,KV,hd], out [B,T,H,hd], all contiguous and of
// one type: fp32 (bf16 = 0) or bf16 (bf16 = 1). 1 <= hd <= 256; H a
// multiple of KV. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int T, int S, int H, int KV,
                               int hd, float scale, int causal, int window,
                               int q_offset, int bf16, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || H > 65535 ||
      B > 65535 || q_offset < 0 || window < 0 || hd < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, T, S, H, KV, scale,
                                      causal, window, q_offset, st);
  return dispatch_hd<float>(hd, q, k, v, out, B, T, S, H, KV, scale, causal,
                            window, q_offset, st);
}
