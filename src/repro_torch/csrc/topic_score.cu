// Hopper kernel of LDA topic inference (sm_90a, plain C interface).
//
// Replaces the Pallas TPU kernel repro.kernels.topic_score.kernel::topic_score
// (src/repro/kernels/topic_score/kernel.py:51, body _kernel):
//
//   scores = counts @ log_phi_t        (B x V) @ (V x K), f32
//   top    = argmax_k scores           int32, the first index on ties
//   conf   = softmax(scores)[top]      = 1 / sum_k exp(scores - max)
//
// What bounds it on an H100: operations.  At the classification chunk of
// the topic pipeline (B = 8192 documents, V = 4096 words, K = 96 topics)
// the product is 2*B*V*K = 6.44 GFLOP, 96 us at the 67 TFLOP/s of f32
// outside the tensor cores, while the bytes (the dense counts, 134 MB, read
// once) take 41.5 us at 3.35 TB/s.  The epilogue is O(B*K).
//
// Precision: the reference holds top exactly and scores to rtol 1e-4, so
// the product runs in plain IEEE f32 FMAs: no TF32, no tensor cores, no
// fast-math exponential.
//
// Design (simple first; the tensor-free f32 product is what makes it slow):
//  * One block of 256 threads (16 x 16) per tile of 32 rows.  It loops over
//    K in tiles of 16 * TN columns (TN <= 8, chosen at launch so that K = 96
//    is one tile) and, inside, over V in steps of 16: the counts tile and
//    the log_phi_t tile are staged in shared memory, and each thread keeps a
//    2 x TN block of sums in registers.  Out-of-range rows, words and
//    topics load as 0 and store nothing, so B, V and K need no padding (the
//    TPU op pads K with -1e9 columns and clamps top instead).
//  * The TPU kernel runs its epilogue on the last V grid step, on the
//    score block resident in VMEM.  Here the block writes its score rows,
//    synchronises, and one warp per row reads them back (L2-resident: the
//    block wrote them itself) for the row max, the argmax (strict > scans,
//    then a shuffle reduction that keeps the lower index on ties) and the
//    sum of expf(s - max).  An all-zero row gives top = 0 and conf = 1/K.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTileRows = 32;  // rows of counts per block
constexpr int kRowsPerThread = kTileRows / 16;
constexpr int kTileV = 16;  // contraction step staged in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kTileRows * kTileV % kThreads == 0 && kTileV * 16 % kThreads == 0,
              "each thread loads whole tiles' shares");

template <int TN>
__global__ void __launch_bounds__(kThreads)
topic_score_kernel(const float* __restrict__ counts, const float* __restrict__ lpt,
                   int b, int v, int k, float* __restrict__ scores,
                   int32_t* __restrict__ top, float* __restrict__ conf) {
  constexpr int kTileK = 16 * TN;
  __shared__ float as[kTileV][kTileRows + 1];  // +1: fewer bank conflicts on store
  __shared__ float bs[kTileV][kTileK];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kTileRows;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    float acc[kRowsPerThread][TN];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int v0 = 0; v0 < v; v0 += kTileV) {
#pragma unroll
      for (int it = 0; it < kTileRows * kTileV / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int r = e / kTileV, c = e % kTileV;
        const int gr = row0 + r, gv = v0 + c;
        as[c][r] = (gr < b && gv < v) ? counts[static_cast<size_t>(gr) * v + gv] : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kTileV * kTileK / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int r = e / kTileK, c = e % kTileK;
        const int gv = v0 + r, gk = k0 + c;
        bs[r][c] = (gv < v && gk < k) ? lpt[static_cast<size_t>(gv) * k + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTileV; ++kk) {
        float a[kRowsPerThread], w[TN];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) a[i] = as[kk][ty * kRowsPerThread + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) w[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = row0 + ty * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = k0 + tx + 16 * j;
        if (r < b && c < k) scores[static_cast<size_t>(r) * k + c] = acc[i][j];
      }
    }
  }
  __syncthreads();  // the block's score rows are written and visible to it

  const int lane = tid % 32, warp = tid / 32;
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
    const int gr = row0 + r;
    if (gr >= b) break;  // warp-uniform
    const float* s = scores + static_cast<size_t>(gr) * k;
    float m = -INFINITY;
    int arg = INT_MAX;
    if (lane < k) {
      m = s[lane];
      arg = lane;
    }
    for (int c = lane + 32; c < k; c += 32) {
      const float x = s[c];
      if (x > m) {  // strict: the lane keeps its first maximum
        m = x;
        arg = c;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float om = __shfl_xor_sync(kFull, m, off);
      const int oa = __shfl_xor_sync(kFull, arg, off);
      if (om > m || (om == m && oa < arg)) {
        m = om;
        arg = oa;
      }
    }
    float sum = 0.f;
    for (int c = lane; c < k; c += 32) sum += expf(s[c] - m);
#pragma unroll
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      top[gr] = arg;
      conf[gr] = 1.f / sum;
    }
  }
}

template <int TN>
void launch(const float* counts, const float* lpt, int b, int v, int k, float* scores,
            int32_t* top, float* conf, cudaStream_t stream) {
  const int grid = (b + kTileRows - 1) / kTileRows;
  topic_score_kernel<TN><<<grid, kThreads, 0, stream>>>(counts, lpt, b, v, k, scores,
                                                        top, conf);
}

}  // namespace

extern "C" {

// counts (b, v) f32 and log_phi_t (v, k) f32, row-major and contiguous;
// writes scores (b, k) f32, top (b,) int32 and conf (b,) f32.  b, v >= 0,
// k >= 1.  Launches on `stream` and does not synchronise.
int topic_score_launch(const void* counts, const void* log_phi_t, int b, int v, int k,
                       void* scores, void* top, void* conf, void* stream) {
  if (b <= 0) return 0;
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(counts);
  const float* l = static_cast<const float*>(log_phi_t);
  float* s = static_cast<float*>(scores);
  int32_t* t = static_cast<int32_t*>(top);
  float* f = static_cast<float*>(conf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tn = k >= 128 ? 8 : (k + 15) / 16;
  switch (tn) {
    case 1: launch<1>(c, l, b, v, k, s, t, f, st); break;
    case 2: launch<2>(c, l, b, v, k, s, t, f, st); break;
    case 3: launch<3>(c, l, b, v, k, s, t, f, st); break;
    case 4: launch<4>(c, l, b, v, k, s, t, f, st); break;
    case 5: launch<5>(c, l, b, v, k, s, t, f, st); break;
    case 6: launch<6>(c, l, b, v, k, s, t, f, st); break;
    case 7: launch<7>(c, l, b, v, k, s, t, f, st); break;
    default: launch<8>(c, l, b, v, k, s, t, f, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
