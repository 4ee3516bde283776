// Fused deferral signal for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `deferral_entropy`
// (src/repro/kernels/deferral_entropy.py). For logits [T, V] (fp32 or bf16)
// it returns per row, in one streaming pass over the vocabulary:
//
//   neg_entropy = sum_c p_c log p_c      (eq. 8, higher = more confident)
//   max_prob    = max_c p_c              (eq. 7)
//   argmax      = first index of the largest logit
//
// from online accumulators (m, s, w, idx): the running max m, s = sum
// e^{l-m} and w = sum e^{l-m} (l - m). Then log p_c = l_c - m - log s, so
// -H = w / s - log s and max_prob = 1 / s. The TPU kernel keeps
// w = sum e^{l-m} l and forms H = lse - w/s; carrying w relative to the
// running max avoids that cancellation at large logits and costs one
// multiply-add where the max moves.
//
// Bound on the card: bytes. Each logit is read once and costs a few flops
// and one exp: at the serving shape (8 x 92,544 fp32, 2.96 MB) 0.88 us at
// 3.35 TB/s, at the evaluation shape (2,048 x 92,544, 758 MB) 0.226 ms.
// At the serving shape the call is far shorter than a launch and a load
// round trip, so what counts is how many dependent steps it takes; the
// design keeps many 16-byte loads in flight, fills the SMs at both shapes
// and runs as one launch:
//
//   * Grid (row, vocabulary split), 256 threads. The TPU grid has one
//     program per 128 rows and walks the vocabulary in order; on the card
//     8 rows would occupy 8 SMs, so the wrapper splits the vocabulary into
//     spans (a multiple of 8 columns) until the grid holds about 4 CTAs per
//     SM (46 spans of 2,016 columns at 8 rows; one span per row at 2,048
//     rows). Each thread folds 16-byte vectors (4 fp32 or 8 bf16 logits)
//     four at a time into its running stats; its columns increase, so a
//     strict '>' keeps the first index. A vocabulary whose rows are not
//     16-byte aligned (V not a multiple of the vector) is read one element
//     at a time. Warp shuffles, then shared memory, merge the CTA's 256
//     stats into one.
//   * One split a row: that CTA writes the row's three outputs.
//   * Several: each CTA writes its stats to scratch, fences, and takes a
//     ticket from the row's counter with one atomicAdd. The CTA that draws
//     the last ticket merges the row's stats and writes the outputs, then
//     sets the counter back to 0 for the next call (the wrapper allocates
//     the counters zeroed, once per device and stream). The merge is
//     parallel and in a fixed order: thread i folds splits i, i + 256, ...
//     and the same shuffle and shared-memory tree merges the threads. That
//     order does not depend on which CTA came last, and the ticket orders
//     no arithmetic, so two calls give the same bits. Every merge takes the
//     lower index on equal maxima, so ties resolve to the lowest vocabulary
//     index, as jnp.argmax and torch.argmax do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // 16-byte loads in flight per thread
constexpr float kNeg = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

struct Stats {
  float m;    // running max
  float s;    // sum e^{l - m}
  float w;    // sum e^{l - m} (l - m)
  int idx;    // first index of m
};

__device__ __forceinline__ Stats empty_stats() {
  return Stats{kNeg, 0.f, 0.f, kNoIndex};
}

// fold b into a; equal maxima keep the lower index
__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float mn = fmaxf(a.m, b.m);
  const float ea = expf(a.m - mn), eb = expf(b.m - mn);
  const float w = ea * fmaf(a.s, a.m - mn, a.w) + eb * fmaf(b.s, b.m - mn, b.w);
  if (b.m > a.m || (b.m == a.m && b.idx < a.idx)) a.idx = b.idx;
  a.s = a.s * ea + b.s * eb;
  a.w = w;
  a.m = mn;
}

// fold n logits at columns col0 .. col0+n-1 (increasing) into st
template <int N>
__device__ __forceinline__ void fold(Stats& st, const float (&x)[N], int col0) {
  float bm = x[0];
  int bi = 0;
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (x[j] > bm) { bm = x[j]; bi = j; }
  if (bm > st.m) {               // rescale once to the new max
    const float sc = expf(st.m - bm);
    st.w = sc * fmaf(st.s, st.m - bm, st.w);
    st.s *= sc;
    st.m = bm;
    st.idx = col0 + bi;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = x[j] - st.m;
    const float e = expf(d);
    st.s += e;
    st.w = fmaf(e, d, st.w);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename LT> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ Stats shfl_stats(const Stats& st, int off) {
  Stats o;
  o.m = __shfl_xor_sync(0xffffffffu, st.m, off);
  o.s = __shfl_xor_sync(0xffffffffu, st.s, off);
  o.w = __shfl_xor_sync(0xffffffffu, st.w, off);
  o.idx = __shfl_xor_sync(0xffffffffu, st.idx, off);
  return o;
}

__device__ __forceinline__ void warp_merge(Stats& st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(st, shfl_stats(st, off));
}

// the CTA's 256 stats merged in a fixed tree; the result is thread 0's
__device__ __forceinline__ Stats block_merge(Stats st, Stats* warp_stats) {
  const int tid = threadIdx.x;
  warp_merge(st);
  if ((tid & 31) == 0) warp_stats[tid >> 5] = st;
  __syncthreads();
  if (tid < 32) {
    st = tid < kWarps ? warp_stats[tid] : empty_stats();
    warp_merge(st);
  }
  return st;
}

__device__ __forceinline__ void write_signal(const Stats& st, int row,
                                             float* neg_ent, float* max_prob,
                                             int* argmax) {
  neg_ent[row] = st.w / st.s - logf(st.s);
  max_prob[row] = 1.f / st.s;
  argmax[row] = st.idx;
}

// grid (T, n_splits), block kThreads. Split sp covers columns
// [sp * span, min(V, (sp + 1) * span)); span is a multiple of Vec<LT>::N.
// With n_splits > 1, scratch holds 4 * n_splits * T words (partial m, s, w,
// argmax) and counters T zeros, which the kernel leaves zero.
template <typename LT>
__global__ void __launch_bounds__(kThreads)
de_signal_kernel(const LT* __restrict__ logits, int V, int span, int vec,
                 float* scratch, unsigned* counters,
                 float* __restrict__ neg_ent, float* __restrict__ max_prob,
                 int* __restrict__ argmax) {
  constexpr int N = Vec<LT>::N;
  __shared__ Stats warp_stats[kWarps];
  __shared__ bool last;
  const int row = blockIdx.x, sp = blockIdx.y, T = gridDim.x;
  const int n_splits = gridDim.y;
  const int tid = threadIdx.x;
  const int c0 = sp * span;
  const int c1 = min(V, c0 + span);
  const LT* x = logits + (size_t)row * V;
  Stats st = empty_stats();
  int tail = c0;
  if (vec) {
    const int n_vec = (c1 - c0) / N;
    for (int base = 0; base < n_vec; base += kThreads * kUnroll) {
      float buf[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = base + u * kThreads + tid;
        if (v < n_vec) Vec<LT>::load(x + c0 + v * N, buf[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = base + u * kThreads + tid;
        if (v < n_vec) fold(st, buf[u], c0 + v * N);
      }
    }
    tail = c0 + n_vec * N;
  }
  for (int c = tail + tid; c < c1; c += kThreads) {
    const float one[1] = {to_f32(x[c])};
    fold(st, one, c);
  }
  st = block_merge(st, warp_stats);

  if (n_splits == 1) {
    if (tid == 0) write_signal(st, row, neg_ent, max_prob, argmax);
    return;
  }
  const size_t n = (size_t)n_splits * T;
  float* pm = scratch;
  float* ps = scratch + n;
  float* pw = scratch + 2 * n;
  int* pidx = reinterpret_cast<int*>(scratch + 3 * n);
  if (tid == 0) {
    const size_t o = (size_t)sp * T + row;
    pm[o] = st.m;
    ps[o] = st.s;
    pw[o] = st.w;
    pidx[o] = st.idx;
    __threadfence();                  // the stats before the ticket
    last = atomicAdd(counters + row, 1u) == (unsigned)(n_splits - 1);
  }
  __syncthreads();                    // also: warp_stats is free again
  if (!last) return;
  __threadfence();                    // the other CTAs' stats after it
  st = empty_stats();
  for (int i = tid; i < n_splits; i += kThreads) {
    const size_t o = (size_t)i * T + row;
    merge(st, Stats{__ldcg(pm + o), __ldcg(ps + o), __ldcg(pw + o),
                    __ldcg(pidx + o)});
  }
  st = block_merge(st, warp_stats);
  if (tid == 0) {
    write_signal(st, row, neg_ent, max_prob, argmax);
    counters[row] = 0u;               // ready for the next call
  }
}

template <typename LT>
int launch(const void* logits, float* neg_ent, float* max_prob, int* argmax,
           float* scratch, unsigned* counters, int T, int V, int span,
           int n_splits, cudaStream_t st) {
  const int vec = (V % Vec<LT>::N == 0) &&
                  (reinterpret_cast<uintptr_t>(logits) % 16 == 0) &&
                  (span % Vec<LT>::N == 0);
  de_signal_kernel<LT><<<dim3(T, n_splits), kThreads, 0, st>>>(
      static_cast<const LT*>(logits), V, span, vec, scratch, counters,
      neg_ent, max_prob, argmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [T, V] row-major, fp32 (bf16 = 0) or bf16 (bf16 = 1); outputs
// [T] each. With n_splits > 1: scratch, 4 * n_splits * T four-byte words
// (partial m, s, w, argmax), and counters, T zeroed unsigned ints that each
// call leaves zero (both may be null with n_splits = 1). Returns the CUDA
// error of the launch (0 on success).
extern "C" int deferral_entropy(const void* logits, float* neg_ent,
                                float* max_prob, int* argmax, float* scratch,
                                unsigned* counters, int T, int V, int span,
                                int n_splits, int bf16, void* stream) {
  if (T < 1 || V < 1 || span < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)span * n_splits < V ||
      (n_splits > 1 && (scratch == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(logits, neg_ent, max_prob, argmax, scratch,
                                 counters, T, V, span, n_splits, st);
  return launch<float>(logits, neg_ent, max_prob, argmax, scratch, counters,
                       T, V, span, n_splits, st);
}
