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
// hold the fp32 online softmax of the TPU kernel.
//
// bf16 inputs (the serving path): `flash_fwd_bf16_kernel`, tensor cores.
//   Bound: bytes. 4 * hd flops per visible (query, key) pair and head
//   against 2 * hd bf16 elements of K and V per key and KV head: at the
//   main path's chunk (8 rows, 128 queries, 16/8 heads of 128, 288 keys)
//   the tensor cores need about a fifth of the time that 17.8 MB of q, k,
//   v and out take at 3.35 TB/s. What holds a kernel back there is
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
//     memory. The row max is reduced across the 4 threads that hold a row
//     (xor shuffles 1 and 2); each thread keeps its part of the row sum,
//     and the parts are added in a fixed order at the end.
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
//   * Masking inside a tile follows the TPU kernel's predicate; a masked
//     score becomes -1e30 and its p is zeroed explicitly (with m = -1e30 a
//     row that sees nothing yet would otherwise add exp(0) = 1). Tiles that
//     no mask reaches skip the predicate.
//   * Tile widths HD 16, 32, 64, 96, 112, 128 (64-key tiles, two CTAs an
//     SM) and 256 (32-key tiles); a call takes the smallest HD >= hd.
//   * No atomics, and every sum in a fixed order: two calls with the same
//     inputs give the same bits.
//
// fp32 inputs (the parity checks and reduced configs): `flash_fwd_f32_kernel`,
//   SIMT cores. An fp32 product has no full-precision tensor-core form
//   (TF32 keeps 10 mantissa bits), so this kernel is bound by operations
//   at the 67 TFLOP/s SIMT rate. One CTA of 256 threads (16 x 16) per
//   (64-query tile, head, row): the query tile is staged once in shared
//   memory, then, for each 64-key tile, K is staged, each thread computes
//   a 4 x 4 block of scores from float4 reads, the 16 threads of a row
//   reduce its max and sum with shuffles, the probabilities go to shared
//   memory, V replaces K in the same buffer, and each thread adds P @ V
//   into its 4 rows x hd/16 columns held in registers. Row strides are
//   padded by 4 floats (distinct banks for a half-warp's float4 reads).
//   Same tile widths; columns past hd are staged as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per CTA, both kernels
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
// fp32: SIMT kernel
// ---------------------------------------------------------------------------

constexpr int KB = 64;          // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty owns 4 queries, tx 4 keys

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

// rows r0 .. r0+63 of a [n_rows, hd] matrix whose rows lie row_stride
// elements apart -> dst [64][HD + 4]; rows past n_rows and columns past hd
// are zeros. Vector loads when hd is a multiple of 4 (the rows are then
// 16-byte aligned), else one element at a time.
template <int HD>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int r0,
                                      int n_rows, size_t row_stride, int hd) {
  constexpr int G = HD / 4;
  const bool vec = (hd & 3) == 0;
  for (int i = threadIdx.x; i < 64 * G; i += kThreads) {
    const int r = i / G, g = i % G;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && g * 4 < hd) {
      const float* row = src + (size_t)(r0 + r) * row_stride + g * 4;
      if (vec) {
        v = load4(row);
      } else {
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = g * 4 + j < hd ? row[j] : 0.f;
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
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int T, int S, int H, int KV, int hd, float scale,
                     int causal, int window, int q_offset) {
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
  const float* qb = q + ((size_t)b * T * H + h) * hd;
  const float* kb = k + ((size_t)b * S * KV + kh) * hd;
  const float* vb = v + ((size_t)b * S * KV + kh) * hd;

  // keys any query of this tile can see
  const int p_lo = q_offset + t0;
  const int p_hi = q_offset + min(T, t0 + QB) - 1;
  const int s_end = causal ? min(S, p_hi + 1) : S;
  const int s_begin = window > 0 ? max(0, p_lo - window + 1) / KB * KB : 0;

  stage<HD>(q_s, qb, t0, T, q_rows, hd);

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
    stage<HD>(kv_s, kb, s0, S, kv_rows, hd);
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
    stage<HD>(kv_s, vb, s0, S, kv_rows, hd);
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

  float* ob = out + ((size_t)b * T * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);   // no visible key -> 0
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = out_col<HD>(tx, c);
      if (col < hd) ob[(size_t)t * q_rows + col] = o[i][c] / denom;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int T, int S, int H, int KV, int hd, float scale, int causal,
               int window, int q_offset, cudaStream_t st) {
  auto kernel = flash_fwd_f32_kernel<HD>;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<HD>::bytes);
  if (attr_err != cudaSuccess) return (int)attr_err;
  dim3 grid((T + QB - 1) / QB, H, B);
  kernel<<<grid, kThreads, Layout<HD>::bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), T, S, H, KV, hd,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// the smallest instantiated tile width HD >= hd, for either kernel
int dispatch_hd(int hd, int bf16_in, const void* q, const void* k,
                const void* v, void* out, int B, int T, int S, int H, int KV,
                float scale, int causal, int window, int q_offset,
                cudaStream_t st) {
#define FLASH_HD(W)                                                          \
  if (hd <= W)                                                               \
  return bf16_in ? launch_bf16<W>(q, k, v, out, B, T, S, H, KV, hd, scale,   \
                                  causal, window, q_offset, st)              \
                 : launch_f32<W>(q, k, v, out, B, T, S, H, KV, hd, scale,    \
                                 causal, window, q_offset, st)
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
// 16-byte boundaries and of one type: fp32 (is_bf16 = 0, the SIMT kernel)
// or bf16 (is_bf16 = 1, the tensor-core kernel). 1 <= hd <= 256; H a
// multiple of KV. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int T, int S, int H, int KV,
                               int hd, float scale, int causal, int window,
                               int q_offset, int is_bf16, void* stream) {
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || H > 65535 ||
      B > 65535 || q_offset < 0 || window < 0 || hd < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch_hd(hd, is_bf16, q, k, v, out, B, T, S, H, KV, scale, causal,
                     window, q_offset, static_cast<cudaStream_t>(stream));
}
