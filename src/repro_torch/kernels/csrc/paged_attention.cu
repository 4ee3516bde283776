// Paged decode kernels for Hopper (sm_90a): one-token GQA attention read
// straight from the block-paged KV cache, and the paged write of a decode
// layer's new token into its cache leaves.
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
//   ops-per-byte balance, so fp32 FMA on the CUDA cores is enough (q is
//   fp32 on the main path; rounding it to bf16 for mma would break the
//   reference's tolerance). What holds a decode back is memory latency:
//   a few rows of a few hundred tokens are too little work to fill 132 SMs
//   unless many CTAs each keep many K/V bytes in flight. The TPU kernel
//   walks the page table along a sequential grid axis carrying (m, l, acc)
//   in VMEM; here (flash-decoding):
//
//   * Split-KV. Grid (KV * head chunks * column blocks, B, n_split). Split
//     s of a row owns the tokens [s * span, (s + 1) * span), span = a whole
//     number of pages near 64 tokens, so its boundaries depend on the block
//     size and the token index only, never on the table width M: cutting
//     the table to the active prefix leaves every split, and the output,
//     bit-identical. A split wholly past the row's position returns at once.
//   * Tiles, not tokens. A split reads its page-table entries once, into
//     one K/V row offset per token in shared memory, then streams K and V 32
//     tokens at a time through a ring of up to 4 shared-memory stages with
//     cp.async (16-byte copies, zero-filled for tokens past the position or
//     in page 0), so the next tile's loads are in flight while the current
//     one is scored; q is staged (fp32) while the first copies fly. Rows
//     that are not 16-byte aligned take a scalar load path into the stages.
//   * Per tile: 4 lanes per token convert each K quad once and dot it with
//     the q of every head of the CTA (two xor shuffles finish a score), a
//     warp per head does one online-softmax rescale, then each thread
//     converts a V quad once and adds it into float4 accumulators of every
//     head, held in registers. A CTA takes at most 16 heads (the kernel is
//     built for 1, 2, 4, 8 and 16, so a small group keeps few registers); a
//     larger group is cut into head chunks along grid x, and hd > 512 into
//     column blocks. Threads left over by a narrow row take other tokens of
//     the tile; their sums are added in a fixed order after the last tile.
//   * The partials (m, l, acc) of every active split go to an fp32
//     workspace that the wrapper allocates; a second kernel merges them in
//     a fixed order and writes the output in q's type. The order depends
//     on the row's count of active splits only (never on M or the split
//     count of the launch), so two calls, and a table cut to the active
//     prefix, give the same bits. An empty split (all its pages 0) has
//     m = -1e30, l = 0, acc = 0 and adds exactly nothing. With one split
//     per row (M * bs <= span) the split kernel writes the output itself
//     and the merge is not launched.
//   * The launch plan (head chunk, stages, shared memory, vector path) is
//     made here, in `plan_decode`; the wrapper chooses only the span and
//     sizes the workspace from the split count it implies.
//   Tokens in unmapped pages (id 0) or past the row's position are never
//   read; an all-trash row gives exact zeros.
//
// paged_write_tokens replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py::paged_write_token (_write_kernel).
//   Bound: bytes (one token row of KV * hd elements per batch row and
//   leaf), but at a decode step's 8 rows of at most 2 KB a launch costs far
//   more than its bytes: what bounds it is the launch. So one launch writes
//   a decode layer's two leaves (K and V, or MLA's ckv and kr), which share
//   the page table and the positions: grid (B, leaves), CTA (b, leaf)
//   writes row b of that leaf in place into the physical block selected
//   through the page table; nothing else of the cache moves (the TPU
//   version aliases input and output for the same reason). Each leaf has
//   its own width, block size and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;     // decode CTA: 4 warps
constexpr int kTile = 32;         // tokens per pipeline stage
constexpr int kMaxStages = 4;
constexpr int kMaxHeads = 16;     // query heads a CTA takes (register bucket)
constexpr int kMergeCols = 128;   // merge: output columns a pass covers
constexpr int kMergeGroups = 4;   // merge: most thread groups on a column
constexpr int kMaxSplits = 4096;  // merge: 2 floats a split within 48 KB
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a CTA may take

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

// four consecutive elements of a shared-memory row as fp32
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

// merge: thread groups that share the splits of a column, from a split
// count (a row's active splits, or the launch's most)
__host__ __device__ __forceinline__ int merge_groups(int n_split) {
  return n_split >= 16 ? kMergeGroups : n_split >= 8 ? 2 : 1;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's newest groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

// Shared-memory layout of one decode CTA
struct DecodeSmem {
  int qs;            // fp32 elements per staged q row: hd rounded up to 4
  size_t rs;         // bytes per K or V token row in a stage
  size_t head;       // row offsets, q, scores, m / l / alpha
  size_t stage;      // one stage: K and V of kTile tokens
  size_t total;      // head + the stages, or the P @ V reduction if larger
  __host__ __device__ DecodeSmem(int gc, int gcb, int hd, int esize,
                                 int span, int stages) {
    qs = (hd + 3) / 4 * 4;
    // 16 * esize bytes of padding put the rows that one quarter- or
    // half-warp reads on distinct banks
    rs = round_up((size_t)hd * esize, 16) + 16 * (size_t)esize;
    head = round_up(sizeof(long long) * round_up(span, kTile) +
                        sizeof(float) * ((size_t)gc * (qs + kTile + 3)), 16);
    stage = 2 * (size_t)kTile * rs;
    const size_t red = (size_t)kThreads * gcb * sizeof(float4);
    const size_t body = (size_t)stages * stage;
    total = head + (body > red ? body : red);
  }
};

// grid (KV * n_hchunk * n_dblk, B, n_split), block kThreads, dynamic
// shared memory DecodeSmem(gc, GC, hd, sizeof(KT), span, n_stages).
// CTA (kvh, hc, dblk) of row b, split s: query heads kvh * group + hc * gc
// ... (at most gc <= GC of them) over the tokens [s * span, (s + 1) * span)
// of the row's valid prefix, output columns [dblk * 512, dblk * 512 + 512)
// (hd <= 512 is one block). vec: K/V rows are 16-byte aligned (cp.async).
//   scores: thread (token r = tid / 4, part = tid % 4) converts each K quad
//     it reads once and dots it with the q quads of all the chunk's heads;
//     4 lanes sum a token's partial dots with two xor shuffles.
//   softmax: warp w takes heads w, w + 4, ...; lane = token.
//   P @ V: thread (quad qd, token group tg) converts each V quad once and
//     adds it into float4 accumulators of all the chunk's heads; the token
//     groups' accumulators are summed in group order after the last tile.
template <typename QT, typename KT, int GC>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                  const KT* __restrict__ vp, const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ pos, QT* __restrict__ out,
                  float* __restrict__ ws_acc, float* __restrict__ ws_ml, int M,
                  int bs, int KV, int group, int hd, float scale, int span,
                  int gc, int n_stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = (hd + 3) / 4;                         // quads of a row
  const int n_dblk = (nq + kThreads - 1) / kThreads;
  const int n_hchunk = gridDim.x / (KV * n_dblk);
  int bx = blockIdx.x;
  const int dblk = bx % n_dblk;
  bx /= n_dblk;
  const int hc = bx % n_hchunk, kvh = bx / n_hchunk;
  const int b = blockIdx.y, s = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int H = KV * group;
  const int h0 = hc * gc;                      // first head of the chunk
  const int gn = min(gc, group - h0);          // heads in this chunk
  const int p = pos[b];
  const int n_tok = p < 0 ? 0 : min(M * bs, p + 1);   // positions idx <= pos
  const int t_begin = s * span;
  // P @ V: this thread's quad of the block's columns and its token group
  const int nqb = min(nq - dblk * kThreads, kThreads);
  const int n_tg = kThreads / nqb;
  const int qd = dblk * kThreads + tid % nqb, tg = tid / nqb;
  const bool pv_on = tg < n_tg;
  QT* o_rows = out + ((size_t)b * H + (size_t)kvh * group + h0) * hd;
  if (t_begin >= n_tok) {                      // nothing of this row here
    if (n_split == 1 && pv_on && tg == 0)
      for (int h = 0; h < gn; ++h)
        for (int e = 0; e < 4; ++e)
          if (4 * qd + e < hd) o_rows[(size_t)h * hd + 4 * qd + e] = from_f32<QT>(0.f);
    return;
  }
  const int t_end = min(t_begin + span, n_tok);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  const DecodeSmem L(gc, GC, hd, sizeof(KT), span, n_stages);
  const int qs = L.qs;
  // [span rounded up to kTile]
  long long* row_s = reinterpret_cast<long long*>(smem);
  float* q_s = reinterpret_cast<float*>(row_s + round_up(span, kTile));
  float* s_s = q_s + (size_t)gc * qs;                  // [gc][kTile]
  float* m_s = s_s + (size_t)gc * kTile;               // [gc]
  float* l_s = m_s + gc;
  float* a_s = l_s + gc;                               // this tile's alpha
  unsigned char* st_s = smem + L.head;                 // [n_stages][K|V]
  const size_t rs = L.rs;

  // the split's token rows first, read through the page table once: the
  // element offset of each token's K/V row for this KV head, -1 for a
  // token past t_end or in page 0. The K/V copies wait on them, q does not.
  const int n_rows = n_tiles * kTile;
  for (int r = tid; r < n_rows; r += kThreads) {
    const int t = t_begin + r;
    long long off = -1;
    if (t < t_end) {
      const int page = tables[(size_t)b * M + t / bs];
      if (page > 0)
        off = (((long long)page * bs + t % bs) * KV + kvh) * (long long)hd;
    }
    row_s[r] = off;
  }
  __syncthreads();

  const int chunks = (int)(((size_t)hd * sizeof(KT)) / 16);   // vec rows
  // K and V of tile i into stage buffer st, zeros for the rows at -1
  auto load_tile = [&](int i, int st) {
    unsigned char* kst = st_s + (size_t)st * L.stage;
    unsigned char* vst = kst + (size_t)kTile * rs;
    const long long* rows = row_s + i * kTile;
    if (vec) {
      for (int c = tid; c < kTile * chunks; c += kThreads) {
        const int r = c / chunks, ch = c - r * chunks;
        const long long off = rows[r];
        const size_t src = off < 0 ? 0 : (size_t)off + (size_t)ch * (16 / sizeof(KT));
        const size_t dst = (size_t)r * rs + (size_t)ch * 16;
        cp_async16(kst + dst, kp + src, off < 0 ? 0 : 16);
        cp_async16(vst + dst, vp + src, off < 0 ? 0 : 16);
      }
    } else {
      for (int e = tid; e < kTile * qs; e += kThreads) {
        const int r = e / qs, d = e - r * qs;
        const long long off = rows[r];
        KT kv = from_f32<KT>(0.f), vv = kv;
        if (off >= 0 && d < hd) {
          kv = kp[off + d];
          vv = vp[off + d];
        }
        reinterpret_cast<KT*>(kst + (size_t)r * rs)[d] = kv;
        reinterpret_cast<KT*>(vst + (size_t)r * rs)[d] = vv;
      }
    }
  };

  for (int i = 0; i < n_stages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }

  // q of the chunk, fp32, zero past hd; m, l (visible after the first
  // tile's barrier)
  const QT* q_rows = q + ((size_t)b * H + (size_t)kvh * group + h0) * hd;
  for (int i = tid; i < gn * qs; i += kThreads) {
    const int h = i / qs, d = i - h * qs;
    q_s[i] = d < hd ? to_f32(q_rows[(size_t)h * hd + d]) : 0.f;
  }
  for (int h = tid; h < gn; h += kThreads) {
    m_s[h] = kNeg;
    l_s[h] = 0.f;
  }

  float4 acc[GC];
#pragma unroll
  for (int h = 0; h < GC; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = 0; i < n_tiles; ++i) {
    const int nxt = i + n_stages - 1;
    if (nxt < n_tiles) load_tile(nxt, nxt % n_stages);
    cp_async_commit();
    cp_async_wait(n_stages - 1);               // tile i has landed
    __syncthreads();
    const unsigned char* kst = st_s + (size_t)(i % n_stages) * L.stage;
    const KT* k_t = reinterpret_cast<const KT*>(kst);
    const KT* v_t = reinterpret_cast<const KT*>(kst + (size_t)kTile * rs);
    const size_t rse = rs / sizeof(KT);        // row stride in elements

    {  // scores of the tile's 32 tokens for every head of the chunk
      const int r = tid >> 2, part = tid & 3;
      float sc[GC];
#pragma unroll
      for (int h = 0; h < GC; ++h) sc[h] = 0.f;
      const KT* kr = k_t + (size_t)r * rse;
      for (int c = part; c < nq; c += 4) {
        const float4 k4 = load4(kr + 4 * c);
#pragma unroll
        for (int h = 0; h < GC; ++h)
          if (h < gn) sc[h] = dot4(load4(q_s + (size_t)h * qs + 4 * c), k4, sc[h]);
      }
#pragma unroll
      for (int h = 0; h < GC; ++h) {
        sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], 1);
        sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], 2);
        if (part == 0 && h < gn) s_s[h * kTile + r] = sc[h] * scale;
      }
    }
    __syncthreads();

    {  // one online-softmax rescale per head: a warp per head, a lane per
       // token
      const bool valid = row_s[i * kTile + lane] >= 0;
      for (int h = warp; h < gn; h += kThreads / 32) {
        const float sc = valid ? s_s[h * kTile + lane] : kNeg;
        float mx = sc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[h];
        const float m_new = fmaxf(m_old, mx);
        const float pr = valid ? expf(sc - m_new) : 0.f;
        float sum = pr;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        s_s[h * kTile + lane] = pr;
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[h] = alpha;
          l_s[h] = l_s[h] * alpha + sum;
          m_s[h] = m_new;
        }
      }
    }
    __syncthreads();

    if (pv_on) {  // P @ V into the accumulators of every head
#pragma unroll
      for (int h = 0; h < GC; ++h) {
        if (h < gn) {
          const float alpha = a_s[h];
          acc[h].x *= alpha; acc[h].y *= alpha;
          acc[h].z *= alpha; acc[h].w *= alpha;
        }
      }
      const KT* vc = v_t + 4 * qd;
      for (int r = tg; r < kTile; r += n_tg) {
        const float4 v4 = load4(vc + (size_t)r * rse);
#pragma unroll
        for (int h = 0; h < GC; ++h)
          if (h < gn) axpy4(s_s[h * kTile + r], v4, acc[h]);
      }
    }
    __syncthreads();      // stage i % n_stages and s_s are free again
  }

  // sum the token groups' accumulators in group order (the stages are
  // free: the last tile ended on a barrier)
  float4* red = reinterpret_cast<float4*>(st_s);      // [n_tg][GC][nqb]
  const int ql = tid % nqb;
  if (pv_on && tg > 0) {
#pragma unroll
    for (int h = 0; h < GC; ++h)
      if (h < gn) red[((size_t)tg * GC + h) * nqb + ql] = acc[h];
  }
  __syncthreads();
  if (!(pv_on && tg == 0)) return;
  for (int g2 = 1; g2 < n_tg; ++g2) {
#pragma unroll
    for (int h = 0; h < GC; ++h) {
      if (h < gn) {
        const float4 o = red[((size_t)g2 * GC + h) * nqb + ql];
        acc[h].x += o.x; acc[h].y += o.y; acc[h].z += o.z; acc[h].w += o.w;
      }
    }
  }

  const size_t part_row = (((size_t)b * KV + kvh) * n_split + s) * group + h0;
#pragma unroll
  for (int h = 0; h < GC; ++h) {
    if (h >= gn) continue;
    const float v[4] = {acc[h].x, acc[h].y, acc[h].z, acc[h].w};
    if (n_split == 1) {   // the only split: normalise, write the output
      const float denom = fmaxf(l_s[h], 1e-30f);      // all-trash row -> 0
      QT* o = o_rows + (size_t)h * hd + 4 * qd;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * qd + e < hd) o[e] = from_f32<QT>(v[e] / denom);
    } else {  // partials: ws_acc [B, KV, n_split, group, hd], ws_ml [.., 2]
      float* w = ws_acc + (part_row + h) * hd + 4 * qd;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * qd + e < hd) w[e] = v[e];
      if (dblk == 0 && qd == 0) {
        ws_ml[2 * (part_row + h)] = m_s[h];
        ws_ml[2 * (part_row + h) + 1] = l_s[h];
      }
    }
  }
}

// grid (H, B), block kMergeCols * merge_groups(n_split), dynamic shared
// memory 2 * n_split floats: out[b, h] from the row's active splits.
// Active splits are those that start below the row's n_tok; an empty one
// (m = -1e30, l = 0, acc = 0) adds exactly nothing. The splits' (m, l) are
// read once into shared memory, where the first warp turns them into
// weights exp(m_s - m) and the denominator; then group k of the row's
// ng = merge_groups(n_act) thread groups sums the splits k, k + ng, ... of
// a column, and the groups' sums are added in group order. ng, and so the
// order of every sum, follows from the row's own active split count, never
// from the launch's (which grows with M); groups past ng sit idle.
template <typename QT>
__global__ void __launch_bounds__(kMergeCols * kMergeGroups)
gqa_merge_kernel(const float* __restrict__ ws_acc,
                 const float* __restrict__ ws_ml,
                 const int32_t* __restrict__ pos, QT* __restrict__ out, int M,
                 int bs, int KV, int group, int hd, int span, int n_split) {
  constexpr int kCols = kMergeCols;
  extern __shared__ float w_s[];              // [n_split] m, then weights
  float* l_s = w_s + n_split;                 // [n_split]
  __shared__ float part_s[kMergeGroups][kCols];
  __shared__ float denom_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / group, g = h - kvh * group;
  const int p = pos[b];
  const int n_tok = p < 0 ? 0 : min(M * bs, p + 1);
  const int n_act = (n_tok + span - 1) / span;
  const int ng = merge_groups(n_act);   // <= the launch's: n_act <= n_split
  const size_t row0 = ((size_t)b * KV + kvh) * n_split * group + g;
  for (int s = threadIdx.x; s < n_act; s += blockDim.x) {
    const size_t r = row0 + (size_t)s * group;
    w_s[s] = ws_ml[2 * r];
    l_s[s] = ws_ml[2 * r + 1];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m_all = kNeg;
    for (int s = lane; s < n_act; s += 32) m_all = fmaxf(m_all, w_s[s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, o));
    float l_all = 0.f;
    for (int s = lane; s < n_act; s += 32) {
      const float w = expf(w_s[s] - m_all);
      w_s[s] = w;
      l_all += l_s[s] * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l_all += __shfl_xor_sync(0xffffffffu, l_all, o);
    if (lane == 0) denom_s = fmaxf(l_all, 1e-30f);   // all-trash row -> 0
  }
  __syncthreads();
  const float denom = denom_s;
  const int grp = threadIdx.x / kCols, col = threadIdx.x % kCols;
  const float* a_row = ws_acc + row0 * hd;
  const size_t a_step = (size_t)group * hd;   // one split further
  QT* o = out + ((size_t)b * KV * group + h) * hd;
  for (int d0 = 0; d0 < hd; d0 += kCols) {
    const int d = d0 + col;
    float a = 0.f;
    if (d < hd && grp < ng) {
#pragma unroll 4
      for (int s = grp; s < n_act; s += ng)
        a += a_row[s * a_step + d] * w_s[s];
    }
    part_s[grp][col] = a;
    __syncthreads();
    if (grp == 0 && d < hd) {
#pragma unroll
      for (int k = 1; k < ng; ++k) a += part_s[k][col];
      o[d] = from_f32<QT>(a / denom);
    }
    __syncthreads();
  }
}

// One leaf of a paged write: leaf [N+1, bs, F] written in place from
// vals [B, F]; *_bf16: 0 = float32, 1 = bfloat16.
struct WriteLeaf {
  void* leaf;
  const void* vals;
  int64_t F;
  int bs, leaf_bf16, val_bf16;
};

// row b of `w`: values[b, :F] into leaf[phys, pos % bs, :F], where phys is
// tables[b, clip(pos // bs, 0, M - 1)]
template <typename LT, typename VT>
__device__ __forceinline__ void write_row(const WriteLeaf& w, int b,
                                          const int32_t* __restrict__ tables,
                                          const int32_t* __restrict__ pos,
                                          int M) {
  const int p = pos[b], bs = w.bs;
  const int blk = min(max(floor_div(p, bs), 0), M - 1);
  const int phys = tables[(size_t)b * M + blk];
  const int off = p - floor_div(p, bs) * bs;
  LT* dst = static_cast<LT*>(w.leaf) + ((int64_t)phys * bs + off) * w.F;
  const VT* src = static_cast<const VT*>(w.vals) + (int64_t)b * w.F;
  for (int64_t i = threadIdx.x; i < w.F; i += blockDim.x)
    dst[i] = from_f32<LT>(to_f32(src[i]));
}

// grid (B, n_leaves): CTA (b, j) writes row b of leaf j (la, then lb)
__global__ void write_tokens_kernel(WriteLeaf la, WriteLeaf lb,
                                    const int32_t* __restrict__ tables,
                                    const int32_t* __restrict__ pos, int M) {
  const WriteLeaf w = blockIdx.y == 0 ? la : lb;
  const int b = blockIdx.x;
  switch (2 * w.leaf_bf16 + w.val_bf16) {
    case 0: write_row<float, float>(w, b, tables, pos, M); break;
    case 1: write_row<float, __nv_bfloat16>(w, b, tables, pos, M); break;
    case 2: write_row<__nv_bfloat16, float>(w, b, tables, pos, M); break;
    default: write_row<__nv_bfloat16, __nv_bfloat16>(w, b, tables, pos, M);
  }
}

constexpr int kWriteThreads = 256;

struct DecodePlan {
  int span, n_split, gc, n_hchunk, n_stages, vec;
  size_t smem;
};

// the register bucket of a head chunk: the next power of two >= gc
__host__ __forceinline__ int gc_bucket(int gc) {
  return gc <= 1 ? 1 : gc <= 2 ? 2 : gc <= 4 ? 4 : gc <= 8 ? 8 : 16;
}

// The launch plan of one call: the split count the span implies, the query
// heads a CTA takes (at most kMaxHeads: float4 accumulators per head live
// in registers; a larger group is cut into head chunks, and into more
// chunks while one 32-token stage does not fit), the most pipeline stages
// that fit the card's shared memory, and the 16-byte copy path where the
// K/V rows allow it. False for a shape the kernel cannot take.
bool plan_decode(int M, int bs, int group, int hd, int esize, int span,
                 const void* kp, const void* vp, DecodePlan& pl) {
  if (span < bs || span % bs != 0) return false;
  pl.span = span;
  pl.n_split = (int)(((long long)M * bs + span - 1) / span);
  if (pl.n_split > kMaxSplits) return false;
  pl.vec = (size_t)hd * esize % 16 == 0 &&
           reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  for (int n_hchunk = (group + kMaxHeads - 1) / kMaxHeads;; ++n_hchunk) {
    const int gc = (group + n_hchunk - 1) / n_hchunk;
    const int tiles = (span + kTile - 1) / kTile;
    for (int st = tiles < kMaxStages ? tiles : kMaxStages; st >= 1; --st) {
      const size_t smem =
          DecodeSmem(gc, gc_bucket(gc), hd, esize, span, st).total;
      if (smem <= kMaxSmem) {
        pl.gc = gc;
        pl.n_hchunk = (group + gc - 1) / gc;
        pl.n_stages = st;
        pl.smem = smem;
        return true;
      }
    }
    if (gc == 1) return false;
  }
}

template <typename QT, typename KT, int GC>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const int32_t* tables, const int32_t* pos, void* out,
                  void* ws_acc, void* ws_ml, int B, int M, int bs, int KV,
                  int group, int hd, float scale, const DecodePlan& pl,
                  cudaStream_t stream) {
  auto kernel = gqa_decode_kernel<QT, KT, GC>;
  // raised once per instantiation to the card's most; a failure is kept
  // and returned by every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int n_dblk = ((hd + 3) / 4 + kThreads - 1) / kThreads;
  dim3 grid(KV * pl.n_hchunk * n_dblk, B, pl.n_split);
  kernel<<<grid, kThreads, pl.smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), tables, pos, static_cast<QT*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml), M, bs, KV,
      group, hd, scale, pl.span, pl.gc, pl.n_stages, pl.vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return (int)err;
  gqa_merge_kernel<QT><<<dim3(KV * group, B),
                         kMergeCols * merge_groups(pl.n_split),
                         2 * sizeof(float) * pl.n_split, stream>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml), pos,
      static_cast<QT*>(out), M, bs, KV, group, hd, pl.span, pl.n_split);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int dispatch_gc(const void* q, const void* kp, const void* vp,
                const int32_t* tables, const int32_t* pos, void* out,
                void* ws_acc, void* ws_ml, int B, int M, int bs, int KV,
                int group, int hd, float scale, const DecodePlan& pl,
                cudaStream_t stream) {
  switch (gc_bucket(pl.gc)) {
#define GQA_GC(G)                                                            \
  case G:                                                                    \
    return launch_decode<QT, KT, G>(q, kp, vp, tables, pos, out, ws_acc,     \
                                    ws_ml, B, M, bs, KV, group, hd, scale,   \
                                    pl, stream)
    GQA_GC(1);
    GQA_GC(2);
    GQA_GC(4);
    GQA_GC(8);
    default: GQA_GC(16);
#undef GQA_GC
  }
  return (int)cudaErrorInvalidValue;  // not reached
}

}  // namespace

extern "C" {

// q [B,1,H,hd]; k/v pages [N+1,bs,KV,hd]; tables [B,M] int32; pos [B] int32;
// out [B,1,H,hd] in q's type. q_bf16 / kv_bf16: 0 = float32, 1 = bfloat16.
// Split s of a row covers its tokens [s * span, (s + 1) * span); span is a
// multiple of bs. ws_acc [B,KV,n_split,H/KV,hd] and ws_ml
// [B,KV,n_split,H/KV,2] fp32, n_split = ceil(M * bs / span), hold the
// splits' partials (unused, and may be null, when n_split == 1). Returns
// cudaErrorInvalidValue, launching nothing, for a shape it cannot take.
int paged_flash_decode_gqa(const void* q, const void* kp, const void* vp,
                           const void* tables, const void* pos, void* out,
                           void* ws_acc, void* ws_ml, int B, int M, int bs,
                           int KV, int group, int hd, float scale, int span,
                           int q_bf16, int kv_bf16, void* stream) {
  DecodePlan pl;
  if (B < 1 || B > 65535 || M < 1 || bs < 1 || KV < 1 || group < 1 ||
      hd < 1 ||
      !plan_decode(M, bs, group, hd, kv_bf16 ? 2 : 4, span, kp, vp, pl) ||
      (pl.n_split > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return dispatch_gc<__nv_bfloat16, __nv_bfloat16>(
        q, kp, vp, t, ps, out, ws_acc, ws_ml, B, M, bs, KV, group, hd, scale,
        pl, s);
  if (q_bf16)
    return dispatch_gc<__nv_bfloat16, float>(q, kp, vp, t, ps, out, ws_acc,
                                               ws_ml, B, M, bs, KV, group, hd,
                                               scale, pl, s);
  if (kv_bf16)
    return dispatch_gc<float, __nv_bfloat16>(q, kp, vp, t, ps, out, ws_acc,
                                               ws_ml, B, M, bs, KV, group, hd,
                                               scale, pl, s);
  return dispatch_gc<float, float>(q, kp, vp, t, ps, out, ws_acc, ws_ml, B,
                                     M, bs, KV, group, hd, scale, pl, s);
}

// A decode layer's paged write in one launch: leaf a [N+1,bs_a,F_a] from
// vals a [B,F_a] and, when n_leaves == 2, leaf b from vals b, both in place
// through tables [B,M] and pos [B]. *_bf16: 0 = float32, 1 = bfloat16.
int paged_write_tokens(void* leaf_a, const void* vals_a, int64_t F_a,
                       int bs_a, int leaf_a_bf16, int val_a_bf16,
                       void* leaf_b, const void* vals_b, int64_t F_b,
                       int bs_b, int leaf_b_bf16, int val_b_bf16,
                       const void* tables, const void* pos, int B, int M,
                       int n_leaves, void* stream) {
  if (B < 1 || M < 1 || n_leaves < 1 || n_leaves > 2 ||
      bs_a < 1 || (n_leaves == 2 && bs_b < 1))
    return (int)cudaErrorInvalidValue;
  const WriteLeaf a{leaf_a, vals_a, F_a, bs_a, leaf_a_bf16, val_a_bf16};
  const WriteLeaf b{leaf_b, vals_b, F_b, bs_b, leaf_b_bf16, val_b_bf16};
  write_tokens_kernel<<<dim3(B, n_leaves), kWriteThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), M);
  return (int)cudaGetLastError();
}

}  // extern "C"
