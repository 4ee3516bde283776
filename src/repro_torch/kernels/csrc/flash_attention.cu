// Flash attention for prefill on Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, `_kernel`). For q [B,T,H,hd] and
// k, v [B,S,KV,hd] (GQA: KV head = query head // (H / KV)) it computes
//
//   out[b,t,h] = softmax_s(q . k_s * scale over the visible s) @ v
//
// with query t at position q_offset + t; key s is visible when s < S and,
// if causal, s <= q_offset + t, and, with a window w > 0,
// s > q_offset + t - w. A row with no visible key gives zeros (denominator
// max(l, 1e-30)), as the TPU kernel does. The output has q's type.
// q_offset = 0 is the TPU kernel's function; q_offset > 0 is the mask of a
// prefill chunk that starts at absolute position q_offset over a cache
// view of S positions (chunked prefill, shared prefixes). Key tiles that
// the causal or window mask hides from every query of a CTA's tile are
// never loaded (the TPU kernel visits every tile and masks).
//
// Two kernels, chosen by the inputs' type in the one C entry point; both
// hold the fp32 online softmax of the TPU kernel, both run every product
// on the tensor cores with `mma.sync` and fp32 accumulation, and neither
// uses atomics: every sum is taken in a fixed order, so two calls with the
// same inputs give the same bits.
//
// fp32 inputs (every main path's type: the models' fp32 weights promote
// the bf16 activations in the q/k/v projections, and the callers cast K/V
// to q's type): `flash_fwd_f32_kernel`, and `flash_merge_kernel` after it
// where the keys are split.
//   Bound: operations at the full-size shapes (whisper-small's encoder,
//   phi-3-vision's prefill), bytes at a chunk of 128 queries over a few
//   hundred keys and at cross-attention (1 or 16 queries over 1500 keys).
//   An fp32 product has no full-precision tensor-core form, and the SIMT
//   cores give 67 TFLOP/s. TF32 keeps 10 mantissa bits, and one TF32
//   product misses the 1e-4 the kernel is held to several times over
//   (tests/test_torch_flash.py pins it), so each fp32 operand x is split
//   into hi, x rounded to TF32 to nearest, and lo = x - hi, which the
//   tensor cores truncate to TF32, and each product is the three TF32
//   products lo.hi + hi.lo + hi.hi (`mma.sync.aligned.m16n8k8`, fp32
//   accumulation): about 21 of fp32's 24 bits, at a third of the 495
//   TFLOP/s dense TF32 rate. A peaked softmax (q x 8) reads about 3e-5
//   against the one-shot fp32 softmax, on the card and in the CPU
//   emulation alike; one product alone reads 7e-3 to 1.2e-2 in the
//   emulation.
//   hi is made by an integer add and a mask (`split_tf32`): `cvt.rna`
//   gives the same bits with compares and selects besides, and took a
//   fifth more time.
//   * One CTA of 4 warps per (64-query tile, head, row, key split); each
//     warp owns 16 queries. Both Q . K^T and P @ V are three-product
//     tiles. Q . K^T takes each k8 step's dims in the order (2 tq, 2 tq +
//     1) for k indices (tq, tq + 4), in Q and K alike, so a lane reads its
//     two elements of a row as one float2. Q's split fragments stay in
//     registers at HD <= 64 and are read and split from shared memory per
//     k step above.
//   * The scores' accumulator fragment is P's A operand without a shuffle:
//     the m16n8k8 accumulator holds keys (2 tq, 2 tq + 1) of a row where
//     the A operand wants k indices (tq, tq + 4), so P @ V takes each k8
//     step's keys in that order and B reads V's rows 2 tq and 2 tq + 1.
//     The probabilities never touch shared memory. The row max is reduced
//     across the 4 threads of a row (xor shuffles 1 and 2); each thread
//     keeps its part of the row sum, and the parts are added in a fixed
//     order at the end.
//   * K and V stay fp32 in shared memory, in a ring of two stages filled by
//     16-byte `cp.async` copies, one commit group a tile: tile j + 1 is in
//     flight while tile j is multiplied, one barrier a tile. fp32 tiles
//     take twice the bf16 kernel's memory, so the key tile is 64 keys at
//     HD <= 64 (88 KB a CTA) and 32 above (101 KB at HD 128): two CTAs fit
//     an SM up to HD 128, one at HD 256 (197 KB). Q and K rows are padded
//     to HD + 8 floats, so the float2 reads of a half-warp fall on distinct
//     banks; V rows to HD + 4, so the reads of rows 2 tq and 2 tq + 1 at
//     column g do. Rows past S and columns past hd are zero-filled by the
//     copy; a row whose hd is not a multiple of 4 is not 16-byte aligned
//     and is staged element by element instead.
//   * T <= 16 (one query at a decode step's cross-attention, a 16-token
//     prompt): one warp a CTA, 16 queries and 32-key tiles, so five CTAs
//     fit an SM at HD 64. At whisper's cross-attention in 6 splits that
//     is 0.046 ms where 4-warp CTAs, two an SM, take 0.078 (PERF.md).
//   * Split-KV where the grid is under one wave (the wrapper's `kv_split`:
//     whisper's cross-attention is 96 CTAs of one row and head each over
//     1500 keys, bound by bytes): the keys some query sees are cut into
//     spans of whole 64-key tiles from `kv_begin`, the first of them
//     aligned down, so that a causal chunk's keys past its last query and
//     a window's keys before its first make no split. CTA (tile, head,
//     row, split) writes its rows' unnormalised o, max m and sum l to an
//     fp32 workspace, and
//     `flash_merge_kernel` (one warp a row) weighs the splits by exp2(m_s
//     - m), sums them in split order and divides. A split that sees no key
//     adds exactly nothing; with one split the kernel divides and writes
//     the output itself, the merge's arithmetic for one split.
//   * Masking inside a tile follows the TPU kernel's predicate; a masked
//     score becomes -1e30 and its p is zeroed explicitly (with m = -1e30 a
//     row that sees nothing yet would otherwise add exp(0) = 1). Tiles that
//     no mask reaches skip the predicate.
//   * Tile widths HD 16, 32, 64, 96, 112, 128 and 256; a call takes the
//     smallest HD >= hd.
//
// bf16 inputs (no main path runs them): `flash_fwd_bf16_kernel`.
//   Bound: bytes at the chunk (8 rows, 128 queries, 16/8 heads of 128, 288
//   keys): the tensor cores need about a fifth of the time that 17.8 MB of
//   q, k, v and out take at 3.35 TB/s. What holds a kernel back there is
//   latency: the grid is one wave of 256 CTAs whose key loops are short
//   (1 to 4 tiles), so the launch, the burst of Q and first-tile loads
//   that every CTA makes at once and the burst of output stores at the
//   end weigh as much as the loop. The design keeps every product on the
//   tensor cores and the key tiles' loads in flight behind arithmetic:
//   * One CTA of 4 warps per (64-query tile, head, row); each warp owns 16
//     queries. Products are `mma.sync.aligned.m16n8k16` with bf16 operands
//     and fp32 accumulation, fed by `ldmatrix` (`.trans` for V). `mma.sync`
//     rather than `wgmma`: at this shape the products take a few
//     microseconds even at mma.sync's rate, so a warpgroup pipeline would
//     buy little and cost a descriptor-layout shared memory and a
//     producer / consumer split; mma.sync keeps every warp's 16 rows and
//     their softmax in its own registers.
//   * Q . K^T: bf16 x bf16 products are exact, so the scores are the fp32
//     reference's up to the order of the sums. Q's fragments are loaded
//     once into registers (HD <= 128) or read from shared memory per k-step
//     (HD 256, whose 128-float output accumulator leaves no room).
//   * The scores' accumulator fragment stays in registers and becomes the
//     A operand of P @ V (the accumulator layout of two n8 tiles is the A
//     layout of one k16 step); the probabilities never touch shared
//     memory. Row max and row sum as in the fp32 kernel.
//   * P @ V with P split in two: hi = bf16(p), lo = bf16(p - hi), two bf16
//     products into one fp32 accumulator. A single bf16 P (8 bits) misses
//     the reference's tolerance (1e-4 + 2^-7 |ref|) several times over at
//     the main chunk, and an fp16 P (which would need V in fp16 too) still
//     misses it; hi + lo carries 16 bits of p, which holds it
//     (tests/test_torch_flash.py pins both bf16 facts on the CPU). It costs
//     half again the tensor-core work of the unsplit products.
//   * K and V stay bf16 in shared memory, in a ring of three stages (two at
//     HD 256) filled by 16-byte `cp.async` copies, one commit group a
//     tile: tiles j + 1 and j + 2 are in flight while tile j is multiplied,
//     one barrier a tile. Q is staged in the third stage, which tile 2
//     takes after Q has gone to registers; so two CTAs fit an SM at every
//     width (104 KB at HD 128). Rows are padded by 16 bytes, so the
//     eight 16-byte rows of an ldmatrix fall on distinct bank groups. Rows
//     past S and columns past hd are zero-filled by the copy (zero columns
//     add nothing to either product); a row whose hd is not a multiple of 8
//     is not 16-byte aligned and is staged element by element instead.
//   * Masking as in the fp32 kernel. Tile widths as in the fp32 kernel
//     (64-key tiles, two CTAs an SM; 32-key tiles at HD 256). It never
//     splits the keys.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per CTA of the bf16 kernel
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 4;                 // 16 queries each
constexpr int kTcThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct TcTile {
  static constexpr int KB = HD <= 128 ? 64 : 32;  // keys per tile
  static constexpr int RS = HD + 8;    // bf16 row stride: 16 B of padding
  static constexpr int NS = KB / 8;    // n8 score tiles per warp
  static constexpr int NO = HD / 8;    // n8 output tiles per warp
  static constexpr bool kQRegs = HD <= 128;  // Q fragments in registers
  // stages of the K/V ring, each K [KB][RS] then V [KB][RS]. With Q in
  // registers, Q's tile borrows the last stage until the first barrier
  // of the tile loop; else it has its own [QB][RS] after the ring. Either
  // way two CTAs fit an SM (104 KB at HD 128, 101 KB at HD 256).
  static constexpr int NST = kQRegs ? 3 : 2;
  static constexpr int STAGE = 2 * KB * RS;
  static constexpr size_t bytes =
      sizeof(bf16) * ((size_t)NST * STAGE + (kQRegs ? 0 : (size_t)QB * RS));
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// rows r0 .. r0+ROWS-1 of a [n_rows, hd] bf16 matrix whose rows lie
// row_stride elements apart -> dst [ROWS][RS]; rows past n_rows and columns
// past hd are zeros. vec (hd % 8 == 0, so rows are 16-byte aligned):
// cp.async copies, which the caller commits and waits for; else element by
// element, visible after the caller's next barrier.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          int r0, int n_rows,
                                          size_t row_stride, int hd,
                                          bool vec) {
  constexpr int RS = TcTile<HD>::RS;
  if (vec) {
    constexpr int G = HD / 8;
    for (int i = threadIdx.x; i < ROWS * G; i += kTcThreads) {
      const int r = i / G, c = (i % G) * 8;
      const bool ok = r0 + r < n_rows && c < hd;
      cp_async16(dst + r * RS + c,
                 ok ? src + (size_t)(r0 + r) * row_stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += kTcThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * RS + c] = r0 + r < n_rows && c < hd
                            ? src[(size_t)(r0 + r) * row_stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// grid (ceil(T / QB), H, B), block kTcThreads, dynamic smem TcTile<HD>::bytes;
// hd <= HD is the inputs' head dim
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int T, int S, int H, int KV, int hd, float scale,
                      int causal, int window, int q_offset) {
  using L = TcTile<HD>;
  constexpr int KB = L::KB, RS = L::RS, NS = L::NS, NO = L::NO;
  constexpr int NST = L::NST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [NST][2][KB][RS]
  bf16* q_s = ring + (L::kQRegs ? NST - 1 : NST) * L::STAGE;   // [QB][RS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;   // fragment row, column pair
  const int t0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const size_t q_rows = (size_t)H * hd, kv_rows = (size_t)KV * hd;
  const bf16* qb = q + ((size_t)b * T * H + h) * hd;
  const bf16* kb = k + ((size_t)b * S * KV + kh) * hd;
  const bf16* vb = v + ((size_t)b * S * KV + kh) * hd;
  const bool vec = (hd & 7) == 0;

  // keys any query of this tile can see
  const int p_lo = q_offset + t0;
  const int p_hi = q_offset + min(T, t0 + QB) - 1;
  const int s_end = causal ? min(S, p_hi + 1) : S;
  const int s_begin = window > 0 ? max(0, p_lo - window + 1) / KB * KB : 0;
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KB - 1) / KB : 0;

  // key tile j -> stage j % NST, one commit group per tile (empty past
  // the last), so "tile j has landed" is one wait count for every j
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      bf16* st = ring + (j % NST) * L::STAGE;
      load_tile<HD, KB>(st, kb, s_begin + j * KB, S, kv_rows, hd, vec);
      load_tile<HD, KB>(st + KB * RS, vb, s_begin + j * KB, S, kv_rows, hd,
                        vec);
    }
    cp_async_commit();
  };
  load_tile<HD, QB>(q_s, qb, t0, T, q_rows, hd, vec);   // in tile 0's group
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) load_kv(j);
  cp_async_wait<NST - 2>();
  __syncthreads();

  // this lane's ldmatrix addresses: the A layout of the warp's 16 queries,
  // the B layout of two n8 key tiles (K), the transposed B layout of a
  // k16 step of keys (V)
  const bf16* q_w = q_s + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * RS +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (lane & 15) * RS + (lane >> 4) * 8;

  unsigned qf[L::kQRegs ? HD / 16 : 1][4];
  if constexpr (L::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_w + kk * 16);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNeg, kNeg};   // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};     // this thread's part of the row sums
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed for every warp, and every warp is done with tile
    // it - 1 (at it = 0, with Q's stage): that stage takes tile
    // it + NST - 1, which flies, with the tiles between, while tile it is
    // multiplied
    cp_async_wait<NST - 2>();
    __syncthreads();
    load_kv(it + NST - 1);
    const int s0 = s_begin + it * KB;
    const bf16* ks = ring + (it % NST) * L::STAGE;
    const bf16* vs = ks + KB * RS;

    // S = Q K^T, 16 x KB per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      if constexpr (L::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm_x4(a, q_w + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        unsigned bk[4];
        ldsm_x4(bk, ks + k_off + jp * 16 * RS + kk * 16);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // mask (only where some mask reaches the tile), scale to log2 units,
    // then the rows' online softmax; element e of n8 tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tq + (e & 1)
    const bool edge = !(s0 + KB <= S && t0 + QB <= T &&
                        (!causal || s0 + KB - 1 <= p_lo) &&
                        (window <= 0 || s0 > p_hi - window));
    unsigned vis = 0xffffffffu;   // bit 4 j + e: s[j][e] is visible
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int t = t0 + warp * 16 + g + (e >> 1) * 8;
          const int qp = q_offset + t;
          const int kp = s0 + j * 8 + tq * 2 + (e & 1);
          const bool ok = t < T && kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) {
            x = kNeg;
            vis &= ~(1u << (4 * j + e));
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - mn);
      m_r[r] = mn;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - m_r[e >> 1]) : 0.f;
        s[j][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P = hi + lo from the score fragments (two n8 score tiles
    // are the A operand of one k16 step)
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vs + v_off + kk * 16 * RS + dp * 16);
        mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
  }

  // the row sums' four parts, in a fixed order; then out = o / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  bf16* ob = out + ((size_t)b * T * H + h) * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + g + r * 8;
    if (t >= T) continue;
    // no visible key -> 0; one reciprocal a row (within an fp32 ulp of
    // the division, far below the bf16 rounding that follows)
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    bf16* orow = ob + (size_t)t * q_rows;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + tq * 2;
      const float x0 = o[n][2 * r] * inv, x1 = o[n][2 * r + 1] * inv;
      if ((hd & 1) == 0) {
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) orow[col] = __float2bfloat16(x0);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int T, int S, int H, int KV, int hd, float scale, int causal,
                int window, int q_offset, cudaStream_t st) {
  auto kernel = flash_fwd_bf16_kernel<HD>;
  // raised once per instantiation; a failure is kept and returned by
  // every later launch
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TcTile<HD>::bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((T + QB - 1) / QB, H, B);
  kernel<<<grid, kTcThreads, TcTile<HD>::bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, S, H, KV, hd,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// fp32: tensor-core kernel, each product as three TF32 products
// ---------------------------------------------------------------------------

constexpr int kSmallT = 16;     // T <= kSmallT: one warp's 16 queries a CTA
constexpr int kSplitAlign = 64; // a split's span is whole tiles of any width

template <int HD, int WARPS> struct F32Tile {
  static constexpr int QB = 16 * WARPS;  // queries per CTA, 16 a warp
  // keys per tile: 64 where two 4-warp CTAs still fit an SM with them,
  // else 32 (so do five 1-warp CTAs at HD 64)
  static constexpr int KB = WARPS == 4 && HD <= 64 ? 64 : 32;
  static constexpr int RQ = HD + 8;   // Q and K row stride (floats)
  static constexpr int RV = HD + 4;   // V row stride
  static constexpr int NS = KB / 8;   // n8 score tiles per warp
  static constexpr int NO = HD / 8;   // n8 output tiles per warp
  static constexpr bool kQRegs = HD <= 64;  // Q's split fragments in registers
  // two stages of K [KB][RQ] then V [KB][RV], then Q [QB][RQ]: 88 KB at
  // HD 64 and 101 KB at HD 128 (two CTAs an SM), 197 KB at HD 256
  static constexpr int STAGE = KB * (RQ + RV);
  static constexpr size_t bytes =
      sizeof(float) * (2 * (size_t)STAGE + (size_t)QB * RQ);
};

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x -> TF32 operands hi and lo. hi is x rounded to TF32 (10 mantissa
// bits) to nearest, ties away from zero: the bits `cvt.rna.tf32.f32`
// gives for a finite x, by an integer add and a mask (the cvt costs
// compares and selects besides, a fifth of the kernel's time). lo = x - hi
// is exact in fp32 and goes to the tensor cores as it is; they read a
// TF32 operand's top 19 bits, so lo is truncated to TF32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// this lane's A fragment of a 16 x 8 tile, split
struct Tf32Frag {
  unsigned hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float x) {
    split_tf32(x, hi[i], lo[i]);
  }
};

// d += a . b as three TF32 products lo.hi + hi.lo + hi.hi, the small ones
// first; b0 and b1 are this lane's B elements (k tq, n g), (k tq + 4, n g)
__device__ __forceinline__ void mma3(float (&d)[4], const Tf32Frag& a,
                                     float b0, float b1) {
  unsigned h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// rows r0 .. r0+ROWS-1 of a [n_rows, hd] fp32 matrix whose rows lie
// row_stride elements apart -> dst [ROWS][RS]; rows past n_rows and columns
// past hd are zeros. vec (hd % 4 == 0, so rows are 16-byte aligned):
// cp.async copies, which the caller commits and waits for; else element by
// element, visible after the caller's next barrier.
template <int HD, int ROWS, int RS, int NT>
__device__ __forceinline__ void load_rows_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int r0, int n_rows,
                                              size_t row_stride, int hd,
                                              bool vec) {
  if (vec) {
    constexpr int G = HD / 4;
    for (int i = threadIdx.x; i < ROWS * G; i += NT) {
      const int r = i / G, c = (i % G) * 4;
      const bool ok = r0 + r < n_rows && c < hd;
      cp_async16(dst + r * RS + c,
                 ok ? src + (size_t)(r0 + r) * row_stride + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      dst[r * RS + c] = r0 + r < n_rows && c < hd
                            ? src[(size_t)(r0 + r) * row_stride + c] : 0.f;
    }
  }
}

// row r (0: g, 1: g + 8) of a warp's 16 x HD accumulator, divided by
// denom, to dst[0 .. hd-1]; element e of n8 tile n is column 8 n + 2 tq +
// (e & 1)
template <int NO>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&o)[NO][4], int r,
                                          int tq, int hd, float denom) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + tq * 2;
    const float x0 = o[n][2 * r] / denom, x1 = o[n][2 * r + 1] / denom;
    if ((hd & 1) == 0) {
      if (col < hd) *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
    } else {
      if (col < hd) dst[col] = x0;
      if (col + 1 < hd) dst[col + 1] = x1;
    }
  }
}

// grid (ceil(T / QB) * n_split, H, B), block 32 * WARPS, dynamic smem
// F32Tile<HD, WARPS>::bytes; hd <= HD is the inputs' head dim. CTA
// (x, h, b) takes query tile x / n_split and keys [kv_begin + s * span,
// kv_begin + (s + 1) * span) of split s = x % n_split (all keys when
// n_split = 1). One split: the output. Else its partial to ws: acc
// [B][n_split][T][H][hd] (o before the division), then (m, l)
// [B][n_split][T][H][2], m in log2 units.
template <int HD, int WARPS>
__global__ void __launch_bounds__(32 * WARPS,
                                  WARPS == 4 && HD <= 128 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ ws, int T, int S, int H, int KV,
                     int hd, float scale, int causal, int window,
                     int q_offset, int n_split, int kv_begin, int span) {
  using L = F32Tile<HD, WARPS>;
  constexpr int QB = L::QB, KB = L::KB, RQ = L::RQ, RV = L::RV;
  constexpr int NS = L::NS, NO = L::NO, NT = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [2][K, V]
  float* q_s = ring + 2 * L::STAGE;                   // [QB][RQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;   // fragment row, column pair
  const int split = blockIdx.x % n_split;
  const int t0 = blockIdx.x / n_split * QB, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const size_t q_rows = (size_t)H * hd, kv_rows = (size_t)KV * hd;
  const float* qb = q + ((size_t)b * T * H + h) * hd;
  const float* kb = k + ((size_t)b * S * KV + kh) * hd;
  const float* vb = v + ((size_t)b * S * KV + kh) * hd;
  const bool vec = (hd & 3) == 0;

  // keys any query of this tile can see, within this split's span
  const int p_lo = q_offset + t0;
  const int p_hi = q_offset + min(T, t0 + QB) - 1;
  int s_end = causal ? min(S, p_hi + 1) : S;
  int s_begin = window > 0 ? max(0, p_lo - window + 1) / KB * KB : 0;
  if (n_split > 1) {   // kv_begin and span are multiples of KB
    s_begin = max(s_begin, kv_begin + split * span);
    s_end = min(s_end, kv_begin + (split + 1) * span);
  }
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + KB - 1) / KB : 0;

  // key tile j -> stage j & 1, one commit group per tile (empty past the
  // last); tile j + 1 is issued only after the barrier that follows tile
  // j's wait, so at that wait tile j's group is the only one in flight
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      float* st = ring + (j & 1) * L::STAGE;
      load_rows_f32<HD, KB, RQ, NT>(st, kb, s_begin + j * KB, S, kv_rows, hd,
                                    vec);
      load_rows_f32<HD, KB, RV, NT>(st + KB * RQ, vb, s_begin + j * KB, S,
                                    kv_rows, hd, vec);
    }
    cp_async_commit();
  };
  load_rows_f32<HD, QB, RQ, NT>(q_s, qb, t0, T, q_rows, hd, vec);
  load_kv(0);                                  // Q rides in tile 0's group
  cp_async_wait<0>();
  __syncthreads();

  // Q . K^T takes dims in pairs: k index tq of a k8 step is dim 2 tq and
  // k index tq + 4 is dim 2 tq + 1, in A (Q) and B (K) alike, so each
  // lane reads its two elements of a row as one float2
  const float* q_w = q_s + (warp * 16 + g) * RQ + 2 * tq;
  auto q_frag = [&](Tf32Frag& a, int kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(q_w + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(q_w + 8 * RQ + 8 * kk);
    a.set(0, x0.x);
    a.set(1, x1.x);
    a.set(2, x0.y);
    a.set(3, x1.y);
  };
  Tf32Frag qf[L::kQRegs ? HD / 8 : 1];
  if constexpr (L::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) q_frag(qf[kk], kk);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNeg, kNeg};   // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};     // this thread's part of the row sums
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed for every warp, and every warp is done with tile
    // it - 1, whose stage takes tile it + 1 while tile it is multiplied
    cp_async_wait<0>();
    __syncthreads();
    load_kv(it + 1);
    const int s0 = s_begin + it * KB;
    const float* ks = ring + (it & 1) * L::STAGE;
    const float* vs = ks + KB * RQ;

    // S = Q K^T, 16 x KB per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const float* k_w = ks + g * RQ + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      Tf32Frag a;
      if constexpr (L::kQRegs) {
        a = qf[kk];
      } else {
        q_frag(a, kk);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 x =
            *reinterpret_cast<const float2*>(k_w + j * 8 * RQ + 8 * kk);
        mma3(s[j], a, x.x, x.y);
      }
    }

    // mask (only where some mask reaches the tile), scale to log2 units,
    // then the rows' online softmax; element e of n8 tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tq + (e & 1)
    const bool edge = !(s0 + KB <= S && t0 + QB <= T &&
                        (!causal || s0 + KB - 1 <= p_lo) &&
                        (window <= 0 || s0 > p_hi - window));
    unsigned vis = 0xffffffffu;   // bit 4 j + e: s[j][e] is visible
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int t = t0 + warp * 16 + g + (e >> 1) * 8;
          const int qp = q_offset + t;
          const int kp = s0 + j * 8 + tq * 2 + (e & 1);
          const bool ok = t < T && kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) {
            x = kNeg;
            vis &= ~(1u << (4 * j + e));
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - mn);
      m_r[r] = mn;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (4 * j + e)) & 1u
                            ? exp2f(s[j][e] - m_r[e >> 1]) : 0.f;
        s[j][e] = p;
        l_r[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V. The score fragment is P's A operand as it stands, with
    // the k8 step's keys taken in the order the fragment holds them: k
    // index tq is key 2 tq and k index tq + 4 is key 2 tq + 1, so B reads
    // V's rows 2 tq and 2 tq + 1 (no shuffle, no trip through shared
    // memory)
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      Tf32Frag pa;
      pa.set(0, s[kk][0]);
      pa.set(1, s[kk][2]);
      pa.set(2, s[kk][1]);
      pa.set(3, s[kk][3]);
      const float* v_w = vs + (8 * kk + 2 * tq) * RV + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) mma3(o[n], pa, v_w[8 * n], v_w[RV + 8 * n]);
    }
  }

  // the row sums' four parts, in a fixed order; then out = o / l, or the
  // split's partial
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + g + r * 8;
    if (t >= T) continue;
    if (n_split == 1) {
      // no visible key -> 0
      store_row<NO>(out + (((size_t)b * T + t) * H + h) * hd, o, r, tq, hd,
                    fmaxf(l_r[r], 1e-30f));
    } else {
      const size_t part = (((size_t)b * n_split + split) * T + t) * H + h;
      store_row<NO>(ws + part * hd, o, r, tq, hd, 1.f);
      if (tq == 0) {
        float* ml = ws + (size_t)gridDim.z * n_split * T * H * hd;
        ml[2 * part] = m_r[r];
        ml[2 * part + 1] = l_r[r];
      }
    }
  }
}

constexpr int kMergeWarps = 4;

// grid ceil(B * T * H / kMergeWarps), block 32 * kMergeWarps: one warp per
// output row (b, t, h), from its n_split partials in ws (the split
// kernel's layout). The splits' weights w_s = exp2(m_s - m) with m their
// largest m; then l = sum w_s l_s and o = sum w_s acc_s, in split order,
// and out = o / max(l, 1e-30). A split that saw no key (m_s = -1e30, l_s
// = 0, acc_s = 0) adds nothing; for one split this is the split kernel's
// own o / max(l, 1e-30).
__global__ void __launch_bounds__(32 * kMergeWarps)
flash_merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
                   int B, int T, int H, int hd, int n_split) {
  constexpr int kCols = 256 / 32;   // columns per lane at the widest hd
  const int lane = threadIdx.x & 31;
  const size_t rows = (size_t)B * T * H;
  const size_t row = (size_t)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t th = row % ((size_t)T * H), b = row / ((size_t)T * H);
  const float* ml = ws + rows * n_split * hd;
  auto part = [&](int s) { return (b * n_split + s) * T * H + th; };
  float m_all = kNeg;
  for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, ml[2 * part(s)]);
  float acc[kCols], den = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = part(s);
    const float w = exp2f(ml[2 * p] - m_all);
    den += w * ml[2 * p + 1];
    const float* src = ws + p * hd;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) acc[i] += w * src[c];
    }
  }
  const float denom = fmaxf(den, 1e-30f);
  float* dst = out + row * hd;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int c = lane + 32 * i;
    if (c < hd) dst[c] = acc[i] / denom;
  }
}

template <int HD, int WARPS>
int launch_f32_w(const float* q, const float* k, const float* v, float* out,
                 float* ws, int B, int T, int S, int H, int KV, int hd,
                 float scale, int causal, int window, int q_offset,
                 int n_split, int kv_begin, int span, cudaStream_t st) {
  using L = F32Tile<HD, WARPS>;
  auto kernel = flash_fwd_f32_kernel<HD, WARPS>;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((T + L::QB - 1) / L::QB * n_split, H, B);
  kernel<<<grid, 32 * WARPS, L::bytes, st>>>(q, k, v, out, ws, T, S, H, KV,
                                             hd, scale, causal, window,
                                             q_offset, n_split, kv_begin,
                                             span);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const size_t rows = (size_t)B * T * H;
  flash_merge_kernel<<<(unsigned)((rows + kMergeWarps - 1) / kMergeWarps),
                       32 * kMergeWarps, 0, st>>>(ws, out, B, T, H, hd,
                                                  n_split);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* ws, int B, int T, int S, int H, int KV, int hd,
               float scale, int causal, int window, int q_offset, int n_split,
               int kv_begin, int span, cudaStream_t st) {
  auto f = T <= kSmallT ? launch_f32_w<HD, 1> : launch_f32_w<HD, 4>;
  return f(static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(out),
           static_cast<float*>(ws), B, T, S, H, KV, hd, scale, causal, window,
           q_offset, n_split, kv_begin, span, st);
}

// the smallest instantiated tile width HD >= hd, for either kernel
int dispatch_hd(int hd, int bf16_in, const void* q, const void* k,
                const void* v, void* out, void* ws, int B, int T, int S,
                int H, int KV, float scale, int causal, int window,
                int q_offset, int n_split, int kv_begin, int span,
                cudaStream_t st) {
#define FLASH_HD(W)                                                          \
  if (hd <= W)                                                               \
  return bf16_in ? launch_bf16<W>(q, k, v, out, B, T, S, H, KV, hd, scale,   \
                                  causal, window, q_offset, st)              \
                 : launch_f32<W>(q, k, v, out, ws, B, T, S, H, KV, hd,       \
                                 scale, causal, window, q_offset, n_split,   \
                                 kv_begin, span, st)
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

// q [B,T,H,hd], k and v [B,S,KV,hd], out [B,T,H,hd], all contiguous, on
// 16-byte boundaries and of one type: fp32 (is_bf16 = 0, the TF32 x 3
// kernel) or bf16 (is_bf16 = 1). 1 <= hd <= 256; H a multiple of KV.
// n_split = 1 writes out in one launch. fp32 only: n_split > 1 cuts the
// keys from kv_begin into spans of `span` (both multiples of 64; every
// split starts below S; the first starts at or before the first key any
// query sees and the last ends at or past the last), each split's partial
// goes to ws (B * n_split * T * H * (hd + 2) floats) and a second launch
// merges them into out. Returns the CUDA error of the launches (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int T, int S, int H, int KV,
                               int hd, float scale, int causal, int window,
                               int q_offset, int is_bf16, int n_split,
                               int kv_begin, int span, void* ws,
                               void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || H > 65535 ||
      B > 65535 || q_offset < 0 || window < 0 || hd < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1) {
    // the keys some query sees: [first, last)
    const long long first =
        window > 0 ? std::max(0LL, (long long)q_offset - window + 1) : 0;
    const long long last =
        causal ? std::min((long long)S, (long long)q_offset + T) : S;
    const long long end = kv_begin + (long long)n_split * span;
    if (is_bf16 || ws == nullptr || span < kSplitAlign ||
        span % kSplitAlign != 0 || kv_begin < 0 ||
        kv_begin % kSplitAlign != 0 || end - span >= S ||
        (first < last && (kv_begin > first || end < last)))
      return (int)cudaErrorInvalidValue;
  }
  return dispatch_hd(hd, is_bf16, q, k, v, out, ws, B, T, S, H, KV, scale,
                     causal, window, q_offset, n_split, kv_begin, span,
                     static_cast<cudaStream_t>(stream));
}
