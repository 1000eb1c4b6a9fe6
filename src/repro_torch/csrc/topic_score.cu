// Hopper kernel of LDA topic inference (sm_90a, plain C interface).
//
// Replaces the Pallas TPU kernel repro.kernels.topic_score.kernel::topic_score
// (src/repro/kernels/topic_score/kernel.py:51, body _kernel):
//
//   scores = counts @ log_phi_t        (B x V) @ (V x K), f32
//   top    = argmax_k scores           int32, the first index on ties
//   conf   = softmax(scores)[top]      = 1 / sum_k exp(scores - max)
//
// What bounds it on an H100: bytes.  The counts are a bag of words per
// document: at the topic pipeline's classification chunk (B = 8192
// documents, V = 4096 words, K = 96 topics) ~1% of them are non-zero, so
// the product needs 2 * nnz * K operations, ~1% of the dense 6.44 GFLOP,
// while the dense counts must still be read once: 134 MB, 41.5 us at
// 3.35 TB/s.  log_phi_t (V x K, 1.5 MB) stays resident in the 50 MB L2.
//
// Precision: the reference holds top exactly and scores to rtol 1e-4, so
// the sums are plain IEEE f32 FMAs: no TF32, no tensor cores, no fast-math
// exponential.
//
// Precondition: log_phi_t is finite.  The kernel skips the zero counts, so
// a zero count times a non-finite log_phi_t entry, NaN in the dense
// product, is not formed.  The pipeline's log_phi is log(max(phi, 1e-12)).
//
// Design:
//  * One warp per document row.  The warp streams the row's counts once
//    with coalesced loads, VEC words a lane (16 bytes when the rows are
//    16-byte aligned), kUnroll loads a lane in flight and the next chunk's
//    loads started before the current chunk is scanned; the loads are
//    streaming (evict-first), so the counts do not push log_phi_t out of L2.
//  * Non-zero terms only.  __ballot_sync finds the lanes whose words hold
//    a non-zero count, and the warp takes them in ascending word order: for
//    each such word w the count is broadcast and every lane FMAs count *
//    log_phi_t[w, t] into its accumulators, topics t = lane + 32 j.  Each
//    topic's sum is therefore the sequential dense sum over ascending w,
//    with the zero terms (exact no-ops) left out.  NACC = ceil(K / 32)
//    accumulators a lane, a template parameter up to kMaxAcc (K <= 512);
//    a wider K is swept in passes of 32 * NACC topics, each reading the row
//    again.
//  * The epilogue runs in registers: the row max and its first index (a
//    strict > scan over each lane's ascending topics, then a shuffle
//    reduction that keeps the lower index on ties) and the sum of
//    expf(s - max) by shuffles.  scores, top and conf are written once.  (With
//    more than one pass the sum reads the row's scores back: the warp wrote
//    them itself.)  An all-zero row gives top = 0 and conf = 1/K.
//  * Dense rows stay right, only slower: every word then takes its row of
//    log_phi_t from L2.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: one document row each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;    // accumulators a lane: K <= 32 * kMaxAcc in one pass
constexpr int kUnroll = 4;     // loads of VEC words a lane per chunk
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int VEC>
struct Words;
template <>
struct Words<1> {
  float x[1];
  __device__ __forceinline__ void load(const float* p) { x[0] = __ldcs(p); }
};
template <>
struct Words<4> {
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  }
};

// The warp's chunk of kUnroll * 32 * VEC words from `base`: lane l holds
// words base + (u * 32 + l) * VEC + c.  Words past v read as 0 (with VEC = 4,
// v is a multiple of 4, so a group is wholly inside or outside).
template <int VEC>
__device__ __forceinline__ void load_chunk(Words<VEC> (&dst)[kUnroll], const float* row,
                                           int base, int v, int lane) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int w = base + (u * 32 + lane) * VEC;
    if (w < v) {
      dst[u].load(row + w);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) dst[u].x[c] = 0.f;
    }
  }
}

// Four blocks an SM (at most 64 registers a thread) while a lane's
// accumulators are few: more rows in flight (~5% at the pipeline's chunk).
template <int VEC, int NACC>
__global__ void __launch_bounds__(kThreads, NACC <= 4 ? 4 : 1)
topic_score_kernel(const float* __restrict__ counts, const float* __restrict__ lpt, int b,
                   int v, int k, float* __restrict__ scores, int32_t* __restrict__ top,
                   float* __restrict__ conf) {
  constexpr int kChunk = kUnroll * 32 * VEC;  // words per chunk
  constexpr int kPass = 32 * NACC;            // topics per pass
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= b) return;  // warp-uniform
  const float* c_row = counts + static_cast<size_t>(row) * v;
  float* s_row = scores + static_cast<size_t>(row) * k;

  float best = -INFINITY;  // this lane's first maximum over its topics
  int arg = INT_MAX;
  float acc[NACC];
  for (int k0 = 0; k0 < k; k0 += kPass) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
    Words<VEC> next[kUnroll];
    load_chunk(next, c_row, 0, v, lane);
    for (int base = 0; base < v; base += kChunk) {
      Words<VEC> cur[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
      if (base + kChunk < v) load_chunk(next, c_row, base + kChunk, v, lane);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool nz = false;
#pragma unroll
        for (int c = 0; c < VEC; ++c) nz |= cur[u].x[c] != 0.f;
        unsigned mask = __ballot_sync(kFull, nz);
        while (mask) {  // the lanes with a non-zero word, ascending
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const size_t w0 = static_cast<size_t>(base + (u * 32 + src) * VEC);
          float cnt[VEC], val[VEC][NACC];
#pragma unroll
          for (int c = 0; c < VEC; ++c) cnt[c] = __shfl_sync(kFull, cur[u].x[c], src);
#pragma unroll
          for (int c = 0; c < VEC; ++c) {  // every word's loads first, then the FMAs
            if (cnt[c] != 0.f) {  // warp-uniform
              const float* l_row = lpt + (w0 + c) * k + k0 + lane;
#pragma unroll
              for (int j = 0; j < NACC; ++j)
                val[c][j] = k0 + lane + 32 * j < k ? __ldg(l_row + 32 * j) : 0.f;
            }
          }
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            if (cnt[c] != 0.f)
#pragma unroll
              for (int j = 0; j < NACC; ++j) acc[j] = fmaf(cnt[c], val[c][j], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int t = k0 + lane + 32 * j;
      if (t < k) {
        s_row[t] = acc[j];
        if (acc[j] > best) {  // strict: the lane keeps its first maximum
          best = acc[j];
          arg = t;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, arg, off);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  float sum = 0.f;
  if (k <= kPass) {  // one pass: the scores are still in registers
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      if (lane + 32 * j < k) sum += expf(acc[j] - best);
  } else {
    __syncwarp();  // the warp's score stores are visible to all its lanes
    for (int t = lane; t < k; t += 32) sum += expf(s_row[t] - best);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) {
    top[row] = arg;
    conf[row] = 1.f / sum;
  }
}

// Launches the instance with NACC == acc (N counts up to kMaxAcc).
template <int VEC, int N = 1>
cudaError_t launch(int acc, const float* counts, const float* lpt, int b, int v, int k,
                   float* scores, int32_t* top, float* conf, cudaStream_t stream) {
  if constexpr (N > kMaxAcc) {
    return cudaErrorInvalidValue;
  } else {
    if (acc != N)
      return launch<VEC, N + 1>(acc, counts, lpt, b, v, k, scores, top, conf, stream);
    const int grid = (b + kWarps - 1) / kWarps;
    topic_score_kernel<VEC, N><<<grid, kThreads, 0, stream>>>(counts, lpt, b, v, k, scores,
                                                              top, conf);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// counts (b, v) f32 and log_phi_t (v, k) f32, row-major and contiguous,
// log_phi_t finite; writes scores (b, k) f32, top (b,) int32 and conf (b,)
// f32.  b, v >= 0, k >= 1.  The wrapper chooses acc (1..16, the
// accumulators a lane: ceil(k / 32) up to 16) and vec (4 when counts is
// 16-byte aligned and v a multiple of 4, else 1).  Launches on `stream`
// and does not synchronise.
int topic_score_launch(const void* counts, const void* log_phi_t, int b, int v, int k,
                       int acc, int vec, void* scores, void* top, void* conf, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0 || acc < 1 || acc > kMaxAcc || (vec != 1 && vec != 4) ||
      (vec == 4 && (v % 4 != 0 || reinterpret_cast<uintptr_t>(counts) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(counts);
  const float* l = static_cast<const float*>(log_phi_t);
  float* s = static_cast<float*>(scores);
  int32_t* t = static_cast<int32_t*>(top);
  float* f = static_cast<float*>(conf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec == 4 ? launch<4>(acc, c, l, b, v, k, s, t, f, st)
                                   : launch<1>(acc, c, l, b, v, k, s, t, f, st);
  return static_cast<int>(err);
}

}  // extern "C"
