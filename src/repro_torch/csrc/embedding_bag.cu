// Hopper kernel of the recsys EmbeddingBag (sm_90a, plain C interface).
//
// Replaces the Pallas TPU kernel repro.kernels.embedding_bag.kernel::embedding_bag
// (src/repro/kernels/embedding_bag/kernel.py:37, body _kernel) with the op
// around it (ops.py:16): per bag of a (B, L) id array whose negative ids are
// pads, the sum, or the mean, of the table rows its valid ids name.
//
// What bounds it on an H100: bytes.  It does one add per element it reads.
// At two-tower's serving shapes (rows of 256 f32, 1 KB) the valid rows
// dominate: the serve_bulk user bag gathers ~1.18M rows of the 8M x 256
// table (1.2 GB, ~0.36 ms at 3.35 TB/s), and the retrieval item bag ~2.5M
// rows of the 4M x 256 one.  The rows are scattered, so each is a separate
// 1 KB read: the kernel has to keep many of them in flight.
//
// Contract (the plain version, repro_torch/kernels/embedding_bag/ref.py,
// to the bit): f32 sums, slot by slot in the order l = 0..L-1, pads skipped;
// the sum rounded to the table's dtype (round to nearest even); for mean
// that divided by max(count, 1) in IEEE f32 and rounded again; an all-pad
// bag gives zeros; an id >= V contributes NaN (the reference's jnp.take
// fills out-of-range rows with NaN), and no row past the table is read.
// Build without --use_fast_math: the division must be IEEE.
//
// Design (simple first):
//  * One warp per bag, 8 bags per block of 256 threads.  The TPU kernel
//    needs ascending segments and the op appends a zero row for the pads
//    (a copy of the table on every call); here the (B, L) layout is read as
//    it is and pads are skipped, so there is no sort and no copy.
//  * Each lane loads one of 32 ids at a time; the ids are broadcast by
//    shuffle.  Lanes stride over the D columns (lane, lane + 32, ...), so a
//    row is read in coalesced 32-element pieces, C columns per lane per
//    pass (C in {1, 2, 4, 8}, chosen from D); a D above 32 * C takes more
//    passes, a D off the multiple of 32 masks its last columns.
//  * Slots go in groups of kGroup: the group's rows are loaded into
//    registers first (up to kGroup rows in flight per warp), then added in
//    slot order, so the f32 sum keeps the contract's order.
//  * Row offsets are 64-bit: id * D passes 2^31 at tables of 8M x 256.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBagsPerBlock = kThreads / 32;
constexpr int kGroup = 4;  // slots whose rows are loaded before they are added
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store(float* p, float sum, float count, bool mean) {
  *p = mean ? sum / count : sum;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float sum, float count, bool mean) {
  const __nv_bfloat16 s = __float2bfloat16_rn(sum);
  *p = mean ? __float2bfloat16_rn(__bfloat162float(s) / count) : s;
}

template <typename T, typename Id, int C>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, long long v, int d,
                     const Id* __restrict__ bags, int b, int l, int mean,
                     T* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int bag = blockIdx.x * kBagsPerBlock + threadIdx.x / 32;
  if (bag >= b) return;  // warp-uniform
  const Id* ids = bags + static_cast<long long>(bag) * l;
  T* dst = out + static_cast<long long>(bag) * d;

  for (int c0 = 0; c0 < d; c0 += 32 * C) {
    float acc[C];
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = 0.f;
    int count = 0;
    for (int s0 = 0; s0 < l; s0 += 32) {
      const int n = min(32, l - s0);
      const long long mine = lane < n ? static_cast<long long>(__ldg(ids + s0 + lane)) : -1;
      for (int g0 = 0; g0 < n; g0 += kGroup) {
        long long id[kGroup];
        float row[kGroup][C];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          id[g] = __shfl_sync(kFull, mine, min(g0 + g, 31));
          if (g0 + g >= n) id[g] = -1;  // past the bag: a pad
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const bool in_table = id[g] >= 0 && id[g] < v;
          const T* src = table + (in_table ? id[g] : 0) * static_cast<long long>(d);
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int c = c0 + lane + 32 * k;
            row[g][k] = (in_table && c < d) ? load(src + c) : NAN;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (id[g] < 0) continue;  // warp-uniform: every lane holds the same id
          ++count;
#pragma unroll
          for (int k = 0; k < C; ++k) acc[k] += row[g][k];
        }
      }
    }
    const float cnt = static_cast<float>(max(count, 1));
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < d) store(dst + c, acc[k], cnt, mean != 0);
    }
  }
}

template <typename T, typename Id>
int launch(const void* table, long long v, int d, const void* bags, int b, int l, int mean,
           void* out, cudaStream_t stream) {
  const int grid = (b + kBagsPerBlock - 1) / kBagsPerBlock;
  const T* t = static_cast<const T*>(table);
  const Id* ids = static_cast<const Id*>(bags);
  T* o = static_cast<T*>(out);
  if (d <= 32) {
    embedding_bag_kernel<T, Id, 1><<<grid, kThreads, 0, stream>>>(t, v, d, ids, b, l, mean, o);
  } else if (d <= 64) {
    embedding_bag_kernel<T, Id, 2><<<grid, kThreads, 0, stream>>>(t, v, d, ids, b, l, mean, o);
  } else if (d <= 128) {
    embedding_bag_kernel<T, Id, 4><<<grid, kThreads, 0, stream>>>(t, v, d, ids, b, l, mean, o);
  } else {
    embedding_bag_kernel<T, Id, 8><<<grid, kThreads, 0, stream>>>(t, v, d, ids, b, l, mean, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table (v, d) row-major and contiguous, f32 (dtype 0) or bf16 (dtype 1);
// bags (b, l) contiguous, int32 (index_bytes 4) or int64 (8); writes out
// (b, d) in the table's dtype.  mean: 0 for the sum, 1 for the mean.  b, l
// >= 0, v, d >= 1.  Launches on `stream` and does not synchronise.
int embedding_bag_launch(const void* table, long long v, int d, int dtype, const void* bags,
                         int index_bytes, int b, int l, int mean, void* out, void* stream) {
  if (b <= 0) return 0;
  if (v < 1 || d < 1 || l < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && index_bytes == 4)
    return launch<float, int>(table, v, d, bags, b, l, mean, out, st);
  if (dtype == 0 && index_bytes == 8)
    return launch<float, long long>(table, v, d, bags, b, l, mean, out, st);
  if (dtype == 1 && index_bytes == 4)
    return launch<__nv_bfloat16, int>(table, v, d, bags, b, l, mean, out, st);
  if (dtype == 1 && index_bytes == 8)
    return launch<__nv_bfloat16, long long>(table, v, d, bags, b, l, mean, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
