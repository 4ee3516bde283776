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
//   Bound: bytes, with every product on the tensor cores. All H query heads
//   share one latent per position, so each cached element feeds every
//   head: 2*H*(r+dr) + 2*H*r flops per position against (r+dr) elements.
//   At H = 128 that is above the card's fp32 SIMT ops-per-byte balance
//   but below its bf16 tensor-core one. The TPU kernel keeps an [H, r]
//   fp32 accumulator (256 KiB at H 128, r 512) in VMEM and walks a row's
//   pages in order. Here (flash-decoding):
//
//   * Split-KV. Grid (ceil(H / 32) head tiles, B, n_split), n_split =
//     min(32, ceil(M * bs / span)). The wrapper picks span from the block
//     size alone (a whole number of pages near 64 tokens); split s of a row
//     owns its tokens [s * rs, (s + 1) * rs), where rs is span for a row of
//     at most 32 spans and the fewest whole spans that cut a longer row
//     into 32 splits (`row_span`). So the splits, and the output's bits,
//     follow from the row's own position, never from the table's width M,
//     and the workspace holds at most 32 partials a row (8.4 MB at H 128,
//     r 512) however long the cache. A split past the row's position
//     returns at once. The splits' partials (m, l, acc) go to an fp32
//     workspace that the wrapper allocates; `mla_merge_kernel` sums a row's
//     active splits in split order (no atomics). With one split
//     (M * bs <= span) the split kernel writes the output.
//   * 32 heads a CTA, as two 16-row mma blocks. The fp32 [heads, r]
//     accumulator lives in registers: 16 warps, warp (head block, 64-column
//     block) holds 16 x 64 floats, 32 a thread. 16 warps rather than 8, so
//     that each scheduler has four warps' latency chains (shuffles, shared
//     loads, mma) to interleave. 64 heads would put 64 accumulators a thread
//     beside the rest, over the 128 registers a thread of 512 may hold, and
//     33 KB more of staged queries beside the tiles.
//   * Tiles of 32 tokens (16 for fp32 pages), which may span several
//     pages: a tile's page-table entries are read when its copies are
//     issued, then the copy engine brings the tile's raw ckv and kr into a
//     ring of 1 to 3 shared-memory stages, as many as fit:
//     one bulk copy (cp.async.bulk, completing on the stage's mbarrier) for
//     each run of consecutive cache rows in the tile, a page or the part of
//     one that the tile holds. Tokens in page 0 or past the position are not
//     copied; the norm writes zeros for them. A stage is free again once its
//     tile is normed, so the next copy is issued then and flies while the
//     tile's products run. The queries come by 16-byte loads, issued after
//     the first tiles' copies.
//   * One rms-norm per token per CTA: each warp norms its tokens of the
//     tile in fp32 (their reductions interleaved) and writes the normed
//     latent as two bf16 halves, hi = bf16(x) and lo = bf16(x - hi), into
//     shared memory, with kr (its lo part only for fp32 pages). The queries
//     are staged the same way once per CTA (their lo part only when a query
//     operand is fp32).
//   * Products: mma.sync m16n8k16, bf16 operands, fp32 accumulators, fed by
//     ldmatrix. Scores q_hi.n_hi + q_hi.n_lo + q_lo.n_hi (the lo.lo term is
//     below fp32's reach of the sum); warp (head block, 16 tokens, k part)
//     sums its part of the 576-deep dot, and the parts are added in k order.
//     P @ V as P_hi.V_hi + P_hi.V_lo + P_lo.V_hi. Single bf16 operands, or
//     a single bf16 V, miss the 1e-4 the card holds the kernel to 30 to 90
//     times over; the full split holds it with a 5x margin
//     (tests/test_torch_mla_split.py pins both on the CPU).
//   * The online softmax is fp32 in log2 units: a warp per 2 heads, a lane
//     per token; P's halves go to shared memory, where the P @ V warps read
//     them with ldmatrix.
//   * No atomics; every sum in a fixed order: two calls give the same bits.
//   r and dr that are not multiples of 16 are zero-padded; H not a multiple
//   of 32 gets zero query rows.
//   Work that grows with the head tiles and the splits rather than with
//   the products: each page is copied and normed by its row's 4 head-tile
//   CTAs, and each split loads its heads' queries and stores a 64 KB fp32
//   partial. Sharing a page's copy and norm across a cluster of the head
//   tiles, and wgmma, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHT = 32;                     // query heads per CTA
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;                   // P @ V columns per warp
constexpr int kMaxR = 512;                  // latent width (kv_lora)
constexpr int kMaxDr = 64;                  // rope width
constexpr int kMaxBs = 32;                  // tokens per page
constexpr int kMaxStages = 3;
constexpr int kMaxRowSplits = 32;           // splits a row, at most
constexpr int kMergeThreads = 128;
constexpr size_t kMaxSmem = 232448;         // 227 KB, the most a CTA may take
static_assert(2 * (kMaxR / kCols) == kWarps, "warps tile 32 heads x r");

__host__ __device__ __forceinline__ size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16_) {
  return bf16_ ? __bfloat162float(static_cast<const bf16*>(p)[i])
               : static_cast<const float*>(p)[i];
}

// two consecutive elements of a shared-memory row as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier (one 8-byte word of shared memory) that completes a phase when
// `count` threads have arrived and the bytes they announced have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive, announcing `bytes` more to land in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared by
// the copy engine, counted against `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed in pairs (x0 low)
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// zeros in a [kHT][stride] bf16 block of staged queries where no query
// lands: rows nh .. kHT - 1, and columns width .. wp - 1 of the others
__device__ __forceinline__ void zero_pad(int nh, int width, int wp,
                                         int stride, bf16* dst) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < (kHT - nh) * wp; i += kThreads)
    dst[(nh + i / wp) * stride + i % wp] = zero;
  const int pad = wp - width;
  for (int i = threadIdx.x; i < nh * pad; i += kThreads)
    dst[(i / pad) * stride + width + i % pad] = zero;
}

// rows row0 .. row0 + nh - 1 of a query [.., width] (fp32 or bf16) as bf16
// halves into hi / lo [kHT][stride], zeros past nh and past width up to wp.
// vec (rows of whole 16-byte chunks at a 16-byte aligned base): 16-byte
// loads, a thread's U of them issued before any is used, so a CTA waits
// about one round trip for its queries; else element by element.
template <bool LO>
__device__ __forceinline__ void stage_rows(const void* __restrict__ src,
                                           int is_bf16, size_t row0, int nh,
                                           int width, int wp, int stride,
                                           bf16* hi, bf16* lo, bool vec) {
  const int tid = threadIdx.x;
  zero_pad(nh, width, wp, stride, hi);
  if (LO) zero_pad(nh, width, wp, stride, lo);
  const int esize = is_bf16 ? 2 : 4, per = 16 / esize;
  if (!vec) {
    for (int i = tid; i < nh * width; i += kThreads) {
      const int h = i / width, k = i - h * width;
      const float x = load_f32(src, (row0 + h) * width + k, is_bf16);
      const bf16 xh = __float2bfloat16(x);
      hi[h * stride + k] = xh;
      if (LO) lo[h * stride + k] = __float2bfloat16(x - __bfloat162float(xh));
    }
    return;
  }
  constexpr int U = 8;
  const int cpr = width / per, total = nh * cpr;    // 16-byte chunks
  const uint4* base = reinterpret_cast<const uint4*>(
      static_cast<const unsigned char*>(src) + row0 * width * esize);
  for (int c0 = tid; c0 < total; c0 += kThreads * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) v[u] = base[c];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kThreads;
      if (c >= total) continue;
      const int h = c / cpr, k = (c - h * cpr) * per;
      uint4* dh = reinterpret_cast<uint4*>(hi + h * stride + k);
      if (is_bf16) {                     // exact in bf16: lo is zero
        *dh = v[u];
        if (LO) *reinterpret_cast<uint4*>(lo + h * stride + k) =
            make_uint4(0u, 0u, 0u, 0u);
      } else {
        const float* f = reinterpret_cast<const float*>(&v[u]);
        unsigned h0, l0, h1, l1;
        split_pair(f[0], f[1], h0, l0);
        split_pair(f[2], f[3], h1, l1);
        *reinterpret_cast<uint2*>(dh) = make_uint2(h0, h1);
        if (LO) *reinterpret_cast<uint2*>(lo + h * stride + k) =
            make_uint2(l0, l1);
      }
    }
  }
}

// Tokens a split of a row whose last position is p: the base span (a whole
// number of pages near 64 tokens) times the fewest whole spans that keep
// the row within kMaxRowSplits splits. It follows from the row's position
// alone, never from the table's width M, so a table cut to the active
// prefix splits every row as before; and the workspace stays at
// kMaxRowSplits partials a row however long the row.
__host__ __device__ __forceinline__ int row_span(int p, int span) {
  const long long n = p < 0 ? 0 : (long long)p + 1;
  const long long per = (long long)span * kMaxRowSplits;
  return span * (int)(n > per ? (n + per - 1) / per : 1);
}

// Shared-memory layout of one split CTA (byte offsets). bf16 rows of the
// staged queries and the normed tile are padded by 8 elements, so the
// eight 16-byte rows of an ldmatrix fall on distinct bank groups.
struct MlaSmem {
  int rp, drp;        // r, dr rounded up to 16 (the mma depth)
  int rs, drs;        // bf16 row strides: rp + 8, drp + 8
  int ss, ps;         // score row stride (fp32), P row stride (bf16)
  size_t raw_r, raw_dr;   // bytes of one raw ckv / kr row in a stage
  size_t q_hi, q_lo, qr_hi, qr_lo, w, n_hi, n_lo, kr_hi, kr_lo, s, p_hi,
      p_lo, ml, valid, bars, ring, stage, total;
  __host__ __device__ MlaSmem(int r, int dr, int tt, int esize, bool qlo,
                              int stages) {
    rp = (r + 15) / 16 * 16;
    drp = (dr + 15) / 16 * 16;
    rs = rp + 8;
    drs = drp + 8;
    ss = tt + 4;
    ps = tt + 8;
    raw_r = round_up((size_t)r * esize, 16);
    raw_dr = round_up((size_t)dr * esize, 16);
    const bool klo = esize == 4;
    const int ksplit = kWarps * 8 / tt;
    size_t o = 0;
    auto take = [&](size_t bytes) {
      const size_t at = o;
      o = round_up(o + bytes, 128);
      return at;
    };
    q_hi = take(2 * (size_t)kHT * rs);
    q_lo = take(qlo ? 2 * (size_t)kHT * rs : 0);
    qr_hi = take(2 * (size_t)kHT * drs);
    qr_lo = take(qlo ? 2 * (size_t)kHT * drs : 0);
    w = take(4 * (size_t)rp);
    n_hi = take(2 * (size_t)tt * rs);
    n_lo = take(2 * (size_t)tt * rs);
    kr_hi = take(2 * (size_t)tt * drs);
    kr_lo = take(klo ? 2 * (size_t)tt * drs : 0);
    s = take(4 * (size_t)ksplit * kHT * ss);
    p_hi = take(2 * (size_t)kHT * ps);
    p_lo = take(2 * (size_t)kHT * ps);
    ml = take(4 * 3 * (size_t)kHT);
    valid = take(4 * (kMaxStages + 1) + 8);   // tile masks, token range
    bars = take(8 * (size_t)kMaxStages);
    stage = round_up((size_t)tt * (raw_r + raw_dr), 128);
    ring = o;
    total = ring + (size_t)stages * stage;
  }
};

// grid (ceil(H / kHT), B, n_split), block kThreads, dynamic shared memory
// MlaSmem(r, dr, TT, sizeof(KT), QLO, n_stages).total. CTA (ht, b, s):
// query heads ht * kHT ... over the tokens [s * rs, (s + 1) * rs) of row
// b's valid prefix, rs = row_span(pos[b], span). KT: the pages' type (TT =
// 32 tokens a tile for bf16, 16 for fp32). QLO: some query operand is
// fp32, so the queries carry a lo half. bulk: raw rows land by bulk
// copies (rows of whole 16-byte chunks at 16-byte aligned bases), else
// element by element; vec_qa / vec_qr: the query rows are 16-byte loads.
//   scores: warp w takes head block w & 1, tokens 16 * ((w >> 1) % TB) of
//     the tile (TB = TT / 16) and part (w >> 1) / TB of the k-steps; the
//     parts land in their own score rows and are added in k order.
//   softmax: warp w takes heads 2w and 2w + 1, a lane per token.
//   P @ V: warp w takes head block w & 1 and columns 64 * (w >> 1) ...
template <typename KT, int TT, bool QLO>
__global__ void __launch_bounds__(kThreads, 1)
mla_split_kernel(const void* __restrict__ q_abs,
                 const void* __restrict__ q_rope,
                 const KT* __restrict__ ckv, const KT* __restrict__ kr,
                 const void* __restrict__ kv_norm,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 float* __restrict__ ws_acc, float* __restrict__ ws_ml, int H,
                 int M, int bs, int r, int dr, float scale, float eps,
                 int span, int n_stages, int bulk, int vec_qa, int vec_qr,
                 int qa_bf16, int qr_bf16, int w_bf16) {
  constexpr bool KLO = sizeof(KT) == 4;       // fp32 pages: kr has a lo half
  constexpr int TB = TT / 16;                 // 16-token score blocks a tile
  constexpr int KSPLIT = kWarps / (2 * TB);   // k parts of a score block
  constexpr int NT = TT / kWarps;             // tokens a warp norms
  constexpr int HW = kHT / kWarps;            // heads a warp's softmax takes
  static_assert(NT >= 1 && HW >= 1 && TT <= 32, "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  const MlaSmem L(r, dr, TT, sizeof(KT), QLO, n_stages);
  bf16* q_hi = reinterpret_cast<bf16*>(smem + L.q_hi);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + L.q_lo);
  bf16* qr_hi = reinterpret_cast<bf16*>(smem + L.qr_hi);
  bf16* qr_lo = reinterpret_cast<bf16*>(smem + L.qr_lo);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  bf16* n_hi = reinterpret_cast<bf16*>(smem + L.n_hi);
  bf16* n_lo = reinterpret_cast<bf16*>(smem + L.n_lo);
  bf16* kr_hi = reinterpret_cast<bf16*>(smem + L.kr_hi);
  bf16* kr_lo = reinterpret_cast<bf16*>(smem + L.kr_lo);
  float* s_s = reinterpret_cast<float*>(smem + L.s);    // [KSPLIT][kHT][ss]
  bf16* p_hi = reinterpret_cast<bf16*>(smem + L.p_hi);  // [kHT][ps]
  bf16* p_lo = reinterpret_cast<bf16*>(smem + L.p_lo);
  float* m_s = reinterpret_cast<float*>(smem + L.ml);
  float* l_s = m_s + kHT;
  float* a_s = l_s + kHT;                               // this tile's alpha
  unsigned* valid_s = reinterpret_cast<unsigned*>(smem + L.valid);
  int* range_s = reinterpret_cast<int*>(valid_s + kMaxStages + 1);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // a stage's
  unsigned char* ring = smem + L.ring;
  const int rp = L.rp, drp = L.drp, rs = L.rs, drs = L.drs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;     // fragment row, column pair
  const int h0 = blockIdx.x * kHT, b = blockIdx.y;
  const int s = blockIdx.z, n_split = gridDim.z;
  const int nh = min(kHT, H - h0);
  const int p = pos[b];
  const int n_tok = p < 0 ? 0 : min(M * bs, p + 1);   // positions idx <= pos
  const int span_b = row_span(p, span);
  const int t_begin = s * span_b;
  if (t_begin >= n_tok) {                      // nothing of this row here
    if (n_split == 1) {
      float* o = out + ((size_t)b * H + h0) * r;
      for (int i = tid; i < nh * r; i += kThreads) o[i] = 0.f;
    }
    return;
  }
  const int t_end = min(t_begin + span_b, n_tok);
  const int n_tiles = (t_end - t_begin + TT - 1) / TT;

  // the split's token range goes to shared memory, where the copies of
  // later tiles read it, rather than in registers across the tile loop
  if (tid == 0) {
    for (int st = 0; st < kMaxStages; ++st) mbar_init(bars + st, 1);
    mbar_fence_init();
    range_s[0] = t_begin;
    range_s[1] = t_end;
  }
  __syncthreads();
  // raw ckv and kr rows of tile i into stage st; tokens at row -1 are not
  // copied, and bit j of valid_s[i % (kMaxStages + 1)] is clear for them
  // (the norm writes their zeros). Bulk: warp 2 st finds the tile's runs
  // of consecutive cache rows (a page, or what of it the tile holds) with
  // two ballots and has the copy engine bring each run's ckv in one copy,
  // warp 2 st + 1 its kr, all counted on the stage's barrier (the stages'
  // warps issue side by side). Else element by element. Both visible after
  // the next barrier; a tile's mask outlives its stage, which is refilled
  // once the tile is normed, until its softmax.
  const unsigned row_b = r * sizeof(KT), rope_b = dr * sizeof(KT);
  auto load_tile = [&](int i, int st) {
    unsigned char* raw = ring + (size_t)st * L.stage;
    unsigned char* rawk = raw + (size_t)TT * L.raw_r;
    // the cache row (page * bs + offset) of the tile's token j, read
    // through the page table; -1 for a token past t_end or in page 0
    const int t0 = range_s[0] + i * TT, t1 = range_s[1];
    auto token_row = [&](int j) -> long long {
      const int t = t0 + j;
      if (j >= TT || t >= t1) return -1;
      const int page = tables[(size_t)b * M + t / bs];
      return page > 0 ? (long long)page * bs + t % bs : -1;
    };
    if (bulk) {
      if (warp >> 1 == st) {                  // warps 2 st and 2 st + 1
        const long long row = token_row(lane);
        const long long down = __shfl_down_sync(0xffffffffu, row, 1);
        const long long nxt = lane < 31 ? down : -1;
        // bit t: token t is copied; token t + 1 continues its run
        const unsigned V = __ballot_sync(0xffffffffu, row >= 0);
        const unsigned C =
            __ballot_sync(0xffffffffu, row >= 0 && nxt == row + 1);
        if ((warp & 1) == 0 && lane == 0) {
          valid_s[i % (kMaxStages + 1)] = V;
          mbar_expect(bars + st, __popc(V) * (row_b + rope_b));
        }
        const bool start =
            row >= 0 && !(lane > 0 && ((C >> (lane - 1)) & 1u));
        if (start) {
          const unsigned len = __ffs(~(C >> lane));     // the run's tokens
          if ((warp & 1) == 0)
            bulk_load(raw + lane * L.raw_r, ckv + row * r, len * row_b,
                      bars + st);
          else if (rope_b > 0)
            bulk_load(rawk + lane * L.raw_dr, kr + row * dr, len * rope_b,
                      bars + st);
        }
      }
    } else {
      if (warp == 0) {
        const unsigned V = __ballot_sync(0xffffffffu, token_row(lane) >= 0);
        if (lane == 0) valid_s[i % (kMaxStages + 1)] = V;
      }
      const int cw = r + dr;
      for (int e = tid; e < TT * cw; e += kThreads) {
        const int t = e / cw, k = e - t * cw;
        const long long row = token_row(t);
        if (row < 0) continue;
        if (k < r)
          reinterpret_cast<KT*>(raw + t * L.raw_r)[k] = ckv[row * r + k];
        else
          reinterpret_cast<KT*>(rawk + t * L.raw_dr)[k - r] =
              kr[row * dr + k - r];
      }
    }
  };
  // the first tiles before the queries: their copies fly while the
  // queries' loads wait
  for (int i = 0; i < n_stages && i < n_tiles; ++i) load_tile(i, i);
  // the CTA's queries as bf16 halves, zeros past H and r; 1 + kv_norm;
  // the softmax state (all visible after the first tile's barrier)
  const size_t q_row0 = (size_t)b * H + h0;
  stage_rows<QLO>(q_abs, qa_bf16, q_row0, nh, r, rp, rs, q_hi, q_lo,
                  vec_qa);
  stage_rows<QLO>(q_rope, qr_bf16, q_row0, nh, dr, drp, drs, qr_hi, qr_lo,
                  vec_qr);
  for (int k = tid; k < rp; k += kThreads)
    w_s[k] = k < r ? 1.f + load_f32(kv_norm, k, w_bf16) : 0.f;
  for (int h = tid; h < kHT; h += kThreads) {
    m_s[h] = kNeg;
    l_s[h] = 0.f;
  }

  // P @ V: this warp's head block and columns; acc[n] is the n8 tile of
  // columns c0 + 8n (element e: head row g + 8 (e >> 1), column 2 tq + (e & 1))
  const int hb = warp & 1, c0 = (warp >> 1) * kCols;
  float acc[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // scores: this warp's 16 tokens of the tile and its part of the k-steps
  const int tb = (warp >> 1) % TB, ks = (warp >> 1) / TB;
  const int nkr = rp / 16, nk = nkr + drp / 16;
  const int kk0 = ks * nk / KSPLIT, kk1 = (ks + 1) * nk / KSPLIT;
  const float sl2 = scale * kLog2e;
  const float inv_r = 1.f / (float)r;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed for every warp, and every warp is done with tile
    // i - 1's products (the normed tile and P are free)
    if (bulk) mbar_wait(bars + i % n_stages, (i / n_stages) & 1);
    __syncthreads();
    const unsigned char* raw = ring + (size_t)(i % n_stages) * L.stage;

    // 1. rms-norm: warp w norms token w (and w + 16 of a 32-token tile)
    //    into the bf16 halves, its tokens' reductions interleaved; columns
    //    past r are zeros
    {
      float2 v[NT][kMaxR / 64];
      float ss[NT];
      bool ok[NT];                    // rows at -1 were not copied: zeros
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const KT* x = reinterpret_cast<const KT*>(raw + (warp + u * kWarps) *
                                                  L.raw_r);
        ok[u] = (valid_s[i % (kMaxStages + 1)] >> (warp + u * kWarps)) & 1u;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxR / 64; ++j) {
          const int k = 2 * (lane + 32 * j);
          float2 xv = make_float2(0.f, 0.f);
          if (ok[u] && k < r) {
            xv = load2(x + k);
            if (k + 1 >= r) xv.y = 0.f;
          }
          v[u][j] = xv;
          s0 = fmaf(xv.x, xv.x, s0);
          s1 = fmaf(xv.y, xv.y, s1);
        }
        ss[u] = s0 + s1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < NT; ++u)
          ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int t = warp + u * kWarps;
        const float inv = rsqrtf(ss[u] * inv_r + eps);
#pragma unroll
        for (int j = 0; j < kMaxR / 64; ++j) {
          const int k = 2 * (lane + 32 * j);
          if (k < rp) {
            const float2 wk = load2(w_s + k);
            unsigned hi, lo;
            split_pair(v[u][j].x * inv * wk.x, v[u][j].y * inv * wk.y, hi,
                       lo);
            *reinterpret_cast<unsigned*>(n_hi + t * rs + k) = hi;
            *reinterpret_cast<unsigned*>(n_lo + t * rs + k) = lo;
          }
        }
        const KT* y = reinterpret_cast<const KT*>(
            raw + (size_t)TT * L.raw_r + t * L.raw_dr);
#pragma unroll
        for (int j = 0; j < (kMaxDr + 63) / 64; ++j) {
          const int k = 2 * (lane + 32 * j);
          if (k < drp) {
            float2 yv = make_float2(0.f, 0.f);
            if (ok[u] && k < dr) {
              yv = load2(y + k);
              if (k + 1 >= dr) yv.y = 0.f;
            }
            unsigned hi, lo;
            split_pair(yv.x, yv.y, hi, lo);
            *reinterpret_cast<unsigned*>(kr_hi + t * drs + k) = hi;
            if (KLO) *reinterpret_cast<unsigned*>(kr_lo + t * drs + k) = lo;
          }
        }
      }
    }
    __syncthreads();
    // the stage is free: tile i + n_stages flies while tile i is multiplied
    if (i + n_stages < n_tiles) load_tile(i + n_stages, i % n_stages);

    // 2. scores of 16 heads x 16 tokens over k-steps [kk0, kk1)
    {
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      const int a_row = hb * 16 + (lane & 15), a_col = (lane >> 4) * 8;
      const int b_row = tb * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int b_col = ((lane >> 3) & 1) * 8;
      for (int kk = kk0; kk < kk1; ++kk) {
        // k-steps [0, nkr) of q_abs . ckv_n, then those of q_rope . kr;
        // queries and keys of one part share a row stride
        const bool rope = kk >= nkr;
        const int col = (rope ? kk - nkr : kk) * 16;
        const int st = rope ? drs : rs;
        const int a_at = a_row * st + col + a_col;
        const int b_at = b_row * st + col + b_col;
        unsigned a[4], kh[4], kl[4];
        ldsm_x4(a, (rope ? qr_hi : q_hi) + a_at);
        ldsm_x4(kh, (rope ? kr_hi : n_hi) + b_at);
        mma_bf16(sc[0], a, kh[0], kh[1]);
        mma_bf16(sc[1], a, kh[2], kh[3]);
        if (!rope || KLO) {                    // the keys' lo half
          ldsm_x4(kl, (rope ? kr_lo : n_lo) + b_at);
          mma_bf16(sc[0], a, kl[0], kl[1]);
          mma_bf16(sc[1], a, kl[2], kl[3]);
        }
        if (QLO) {                             // the queries' lo half
          ldsm_x4(a, (rope ? qr_lo : q_lo) + a_at);
          mma_bf16(sc[0], a, kh[0], kh[1]);
          mma_bf16(sc[1], a, kh[2], kh[3]);
        }
      }
      float* srow = s_s + ((size_t)ks * kHT + hb * 16 + g) * L.ss +
                    tb * 16 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(srow + j * 8) =
            make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(srow + 8 * L.ss + j * 8) =
            make_float2(sc[j][2], sc[j][3]);
      }
    }
    __syncthreads();

    // 3. online softmax, log2 units: warp w takes heads 2w and 2w + 1, a
    //    lane per token, the two heads' reductions interleaved
    {
      const bool valid = (valid_s[i % (kMaxStages + 1)] >> lane) & 1u;
      float sc[HW], mx[HW], sum[HW];
#pragma unroll
      for (int u = 0; u < HW; ++u) {
        const int h = warp * HW + u;
        float x = 0.f;
        if (lane < TT) {
#pragma unroll
          for (int k = 0; k < KSPLIT; ++k)
            x += s_s[((size_t)k * kHT + h) * L.ss + lane];
        }
        sc[u] = valid ? x * sl2 : kNeg;
        mx[u] = sc[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < HW; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
      for (int u = 0; u < HW; ++u) {
        mx[u] = fmaxf(m_s[warp * HW + u], mx[u]);        // the new max
        sum[u] = valid ? exp2f(sc[u] - mx[u]) : 0.f;
        sc[u] = sum[u];                                  // p
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < HW; ++u)
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
#pragma unroll
      for (int u = 0; u < HW; ++u) {
        const int h = warp * HW + u;
        if (lane < TT) {
          const bf16 ph = __float2bfloat16(sc[u]);
          p_hi[h * L.ps + lane] = ph;
          p_lo[h * L.ps + lane] =
              __float2bfloat16(sc[u] - __bfloat162float(ph));
        }
        if (lane == 0) {
          const float alpha = exp2f(m_s[h] - mx[u]);
          a_s[h] = alpha;
          l_s[h] = l_s[h] * alpha + sum[u];
          m_s[h] = mx[u];
        }
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P @ V over this warp's heads and columns
    if (c0 < rp) {
      const float al0 = a_s[hb * 16 + g], al1 = a_s[hb * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        acc[n][0] *= al0;
        acc[n][1] *= al0;
        acc[n][2] *= al1;
        acc[n][3] *= al1;
      }
      const int p_row = hb * 16 + (lane & 15), p_col = (lane >> 4) * 8;
      const int v_off = (lane & 15) * rs + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < TB; ++kk) {
        unsigned ph[4], pl[4];
        ldsm_x4(ph, p_hi + p_row * L.ps + kk * 16 + p_col);
        ldsm_x4(pl, p_lo + p_row * L.ps + kk * 16 + p_col);
#pragma unroll
        for (int dp = 0; dp < kCols / 16; ++dp) {
          const int col = c0 + dp * 16;
          if (col < rp) {
            unsigned vh[4], vl[4];
            ldsm_x4_trans(vh, n_hi + v_off + kk * 16 * rs + col);
            ldsm_x4_trans(vl, n_lo + v_off + kk * 16 * rs + col);
            mma_bf16(acc[2 * dp], ph, vh[0], vh[1]);
            mma_bf16(acc[2 * dp], ph, vl[0], vl[1]);
            mma_bf16(acc[2 * dp], pl, vh[0], vh[1]);
            mma_bf16(acc[2 * dp + 1], ph, vh[2], vh[3]);
            mma_bf16(acc[2 * dp + 1], ph, vl[2], vl[3]);
            mma_bf16(acc[2 * dp + 1], pl, vh[2], vh[3]);
          }
        }
      }
    }
  }

  // the last tile's softmax ended on a barrier: m_s and l_s are final
  if (c0 < rp) {
    const size_t base = n_split == 1
        ? ((size_t)b * H + h0) * r
        : (((size_t)b * n_split + s) * H + h0) * r;
    float* dst = n_split == 1 ? out + base : ws_acc + base;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hl = hb * 16 + g + 8 * half;
      if (hl >= nh) continue;
      // one split: normalise (an all-trash row gives 0); else the partial
      const float inv_l = n_split == 1 ? 1.f / fmaxf(l_s[hl], 1e-30f) : 1.f;
      float* o = dst + (size_t)hl * r;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        const int col = c0 + n * 8 + 2 * tq;
        const float x0 = acc[n][2 * half], x1 = acc[n][2 * half + 1];
        const float y0 = n_split == 1 ? x0 * inv_l : x0;
        const float y1 = n_split == 1 ? x1 * inv_l : x1;
        if ((r & 1) == 0 && col + 1 < r) {
          *reinterpret_cast<float2*>(o + col) = make_float2(y0, y1);
        } else {
          if (col < r) o[col] = y0;
          if (col + 1 < r) o[col + 1] = y1;
        }
      }
    }
  }
  if (n_split > 1 && tid < nh) {
    const size_t row = ((size_t)b * n_split + s) * H + h0 + tid;
    ws_ml[2 * row] = m_s[tid];
    ws_ml[2 * row + 1] = l_s[tid];
  }
}

// `n` (4 or 1) consecutive floats of a partial row into v[0 .. n)
__device__ __forceinline__ void load_cols(const float* p, int n,
                                          float (&v)[4]) {
  if (n == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = p[0]; v[1] = v[2] = v[3] = 0.f;
  }
}

// grid (H, B), block kMergeThreads: out[b, h] from row b's active splits,
// those that start below the row's n_tok. An empty split (m = -1e30,
// l = 0, acc = 0) adds exactly nothing. The first warp turns the splits' m
// into weights exp2(m_s - m_all) and sums the denominator in a fixed
// shuffle tree; then each thread sums its columns over the splits in split
// order. Every order follows from the row's own active split count, never
// from the launch's (which grows with M): a table cut to the active prefix
// gives the same bits, and a row of one active split gives the split
// kernel's own output.
__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float* __restrict__ ws_acc,
                 const float* __restrict__ ws_ml,
                 const int32_t* __restrict__ pos, float* __restrict__ out,
                 int H, int M, int bs, int r, int span, int n_split) {
  __shared__ float w_s[kMaxRowSplits], l_s[kMaxRowSplits], inv_s;
  const int h = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  const int n_tok = p < 0 ? 0 : min(M * bs, p + 1);
  const int span_b = row_span(p, span);
  const int n_act = (n_tok + span_b - 1) / span_b;
  const size_t row0 = (size_t)b * n_split * H + h;   // split s: + s * H
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m_all = kNeg, l_all = 0.f;
    for (int s0 = 0; s0 < n_act; s0 += 32) {     // lane: splits lane, +32 ..
      const int s = s0 + lane;
      const float2 ml = s < n_act
          ? *reinterpret_cast<const float2*>(ws_ml + 2 * (row0 + (size_t)s * H))
          : make_float2(kNeg, 0.f);
      m_all = fmaxf(m_all, ml.x);
      if (s < n_act) {
        w_s[s] = ml.x;                       // m now, the weight below
        l_s[s] = ml.y;
      }
    }
    m_all = warp_max(m_all);
    for (int s = lane; s < n_act; s += 32) {
      const float w = exp2f(w_s[s] - m_all);
      w_s[s] = w;
      l_all += l_s[s] * w;
    }
    l_all = warp_sum(l_all);
    if (lane == 0) inv_s = 1.f / fmaxf(l_all, 1e-30f);   // all-trash row -> 0
  }
  __syncthreads();
  const float inv = inv_s;
  const float* a_row = ws_acc + row0 * r;
  const size_t a_step = (size_t)H * r;        // one split further
  float* o = out + ((size_t)b * H + h) * r;
  // columns in fours where rows allow, else one by one; splits summed in
  // order, their loads issued four splits ahead of the sums
  const int quad = (r & 3) == 0 ? 4 : 1;
  for (int d = threadIdx.x * quad; d < r; d += kMergeThreads * quad) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
    for (; s + 4 <= n_act; s += 4) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        load_cols(a_row + (s + u) * a_step + d, quad, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = fmaf(v[u][e], w_s[s + u], a[e]);
    }
    for (; s < n_act; ++s) {
      float v[4];
      load_cols(a_row + s * a_step + d, quad, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(v[e], w_s[s], a[e]);
    }
    for (int e = 0; e < quad; ++e) o[d + e] = a[e] * inv;
  }
}

struct MlaPlan {
  int n_split, n_stages, bulk, vec_qa, vec_qr;
  size_t smem;
};

// rows of `width` elements of `esize` bytes from `p` go as 16-byte loads
inline bool rows16(const void* p, int width, int esize) {
  return (size_t)width * esize % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The split count of a launch: one a base span of the table, at most
// kMaxRowSplits (a row longer than that many spans takes longer splits).
inline int mla_splits(int M, int bs, int span) {
  const long long n = ((long long)M * bs + span - 1) / span;
  return (int)(n < kMaxRowSplits ? n : kMaxRowSplits);
}

// The launch plan of one call: the split count, the most ring stages (1 to
// 3) that fit the card's shared memory, the bulk-copy path for the pages
// and 16-byte loads for the queries where rows allow. False for a shape it
// cannot take.
bool plan_mla(int M, int bs, int r, int dr, int esize, int tt, bool qlo,
              int span, const void* ckv, const void* kr, const void* qa,
              int qa_esize, const void* qr, int qr_esize, MlaPlan& pl) {
  if (span < bs || span % bs != 0) return false;
  pl.n_split = mla_splits(M, bs, span);
  pl.bulk = rows16(ckv, r, esize) && rows16(kr, dr, esize);
  pl.vec_qa = rows16(qa, r, qa_esize);
  pl.vec_qr = rows16(qr, dr, qr_esize);
  for (int st = kMaxStages; st >= 1; --st) {
    const size_t smem = MlaSmem(r, dr, tt, esize, qlo, st).total;
    if (smem <= kMaxSmem) {
      pl.n_stages = st;
      pl.smem = smem;
      return true;
    }
  }
  return false;
}

template <typename KT, int TT, bool QLO>
int launch(const void* qa, const void* qr, const void* ckv, const void* kr,
           const void* w, const int32_t* tables, const int32_t* pos,
           float* out, float* ws_acc, float* ws_ml, int ws_splits, int B,
           int H, int M, int bs, int r, int dr, float scale, float eps,
           int span, int qa_bf16, int qr_bf16, int w_bf16,
           cudaStream_t stream) {
  auto kernel = mla_split_kernel<KT, TT, QLO>;
  // raised once per instantiation to the card's most; a failure is kept
  // and returned by every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr_err != cudaSuccess) return (int)attr_err;
  MlaPlan pl;
  if (!plan_mla(M, bs, r, dr, (int)sizeof(KT), TT, QLO, span, ckv, kr, qa,
                qa_bf16 ? 2 : 4, qr, qr_bf16 ? 2 : 4, pl) ||
      (pl.n_split > 1 && (ws_acc == nullptr || ws_ml == nullptr ||
                          ws_splits != pl.n_split)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((H + kHT - 1) / kHT, B, pl.n_split);
  kernel<<<grid, kThreads, pl.smem, stream>>>(
      qa, qr, static_cast<const KT*>(ckv), static_cast<const KT*>(kr), w,
      tables, pos, out, ws_acc, ws_ml, H, M, bs, r, dr, scale, eps, span,
      pl.n_stages, pl.bulk, pl.vec_qa, pl.vec_qr, qa_bf16, qr_bf16, w_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.n_split == 1) return (int)err;
  mla_merge_kernel<<<dim3(H, B), kMergeThreads, 0, stream>>>(
      ws_acc, ws_ml, pos, out, H, M, bs, r, span, pl.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_abs [B,1,H,r]; q_rope [B,1,H,dr]; ckv pages [N+1,bs,r]; kr pages
// [N+1,bs,dr]; kv_norm [r]; tables [B,M] int32; pos [B] int32; out
// [B,1,H,r] float32. *_bf16: 0 = float32, 1 = bfloat16 (ckv and kr pages
// share one type). span is a multiple of bs; split s of row b covers its
// tokens [s * rs, (s + 1) * rs), rs = row_span(pos[b], span): span, or a
// multiple of it for a row of more than kMaxRowSplits spans. ws_acc
// [B,n_split,H,r] and ws_ml [B,n_split,H,2] fp32, n_split = min(32,
// ceil(M * bs / span)), given as ws_splits, hold the splits' partials
// (unused, and may be null, when n_split == 1). Returns
// cudaErrorInvalidValue, launching nothing, for a shape it cannot take or a
// workspace of another split count.
int paged_flash_decode_mla(const void* q_abs, const void* q_rope,
                           const void* ckv_pages, const void* kr_pages,
                           const void* kv_norm, const void* tables,
                           const void* pos, void* out, void* ws_acc,
                           void* ws_ml, int ws_splits, int B, int H, int M,
                           int bs, int r, int dr, float scale, float eps,
                           int span,
                           int qa_bf16, int qr_bf16, int kv_bf16, int w_bf16,
                           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || M < 1 || r < 1 || r > kMaxR || dr < 0 ||
      dr > kMaxDr || bs < 1 || bs > kMaxBs)
    return (int)cudaErrorInvalidValue;
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* ps = static_cast<const int32_t*>(pos);
  float* o = static_cast<float*>(out);
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool qlo = !(qa_bf16 && qr_bf16);
#define MLA_LAUNCH(KT, TT, QLO)                                               \
  return launch<KT, TT, QLO>(q_abs, q_rope, ckv_pages, kr_pages, kv_norm, t, \
                             ps, o, wa, wm, ws_splits, B, H, M, bs, r, dr,   \
                             scale, eps, span, qa_bf16, qr_bf16, w_bf16, s)
  if (kv_bf16) {
    if (qlo) MLA_LAUNCH(bf16, 32, true);
    MLA_LAUNCH(bf16, 32, false);
  }
  if (qlo) MLA_LAUNCH(float, 16, true);
  MLA_LAUNCH(float, 16, false);
#undef MLA_LAUNCH
}

}  // extern "C"
