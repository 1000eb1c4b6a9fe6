// Hopper kernel of GQA decode attention over a KV cache (sm_90a, plain C
// interface).
//
// Replaces the Pallas TPU kernel
// repro.kernels.decode_attention.kernel::decode_attention
// (src/repro/kernels/decode_attention/kernel.py:90, body _kernel).  For
// every (batch b, kv head h) and each of the G query heads of its group:
//
//   s[pos]  = q . k[pos] * scale                       f32
//   s[pos]  = cap * tanh(s[pos] / cap)                 with a softcap
//   s[pos]  = -1e30 unless pos <= cur (and pos > cur - window)
//   out     = sum_pos softmax(s)[pos] * v[pos]         f32, cast to q's type
//
// with q (B, Hkv, G, d), k and v (B, S, Hkv, d) in f32 or bf16 and cur an
// int32 scalar read on the device (the cache's fill level), so a decode
// step never waits on the host.
//
// What bounds it on an H100: bytes.  Every valid K and V row is read once
// and used for all G heads of its group: at gemma-2b's decode shape (B =
// 64, Hkv = 1, G = 8, d = 256, S = 32768, bf16) that is 2.15 GB per layer,
// 0.64 ms at 3.35 TB/s.  A key row costs 4 * d bytes (K and V in bf16) and
// brings 4 * G * d flops: G = 8 flops per byte, under the 20 per byte at
// which even plain f32 FMAs (67 TFLOP/s) would be the limit.
//
// Design (simple first; wgmma, TMA and a pipelined ring are later work):
//  * Flash-decoding.  B * Hkv is only 64 at gemma-2b's decode shape, against
//    132 SMs, so S is split into n_split chunks (chosen by the wrapper from
//    the kernel's occupancy, so the blocks fill whole waves), one block of
//    256 threads per (chunk, b, h).
//    A block sweeps only the positions of its chunk that the mask keeps
//    (pos <= cur and, with a window, pos > cur - window): blocks wholly past
//    cur, or wholly before the window, read nothing.  Masked positions
//    weigh exp(-1e30 - m) = 0 exactly in the reference, so skipping them is
//    the same function.  When the mask keeps no position at all (a window
//    that lies past the cache), the reference's softmax is uniform over S,
//    and the blocks then sweep every position with the score -1e30.
//  * The GQA reuse of the TPU kernel's (G, bs) dot: each tile of 32 keys
//    and values is staged in shared memory once, in the inputs' type, and
//    serves all G query heads (q in f32).  One thread per (head, key) takes
//    the dot product, sixteen bytes of k per shared-memory read, converted
//    to f32 at use (bf16 products are exact in f32); one warp per head runs
//    the online softmax (running max m, sum l) with the precise expf; each
//    thread keeps up to 16 of the G x d accumulators in registers: one
//    column j of d and the heads g0, g0 + 256 / d, ..., so a value read from
//    shared memory serves each of them.
//  * The copies overlap the arithmetic: tiles arrive by cp.async (16 bytes,
//    global to shared memory without registers) into two buffers, tile
//    i + 1 loading while tile i is computed.  K rows are padded by 16 bytes
//    so the 8 keys of each quarter-warp's reads fall in distinct banks.
//  * What it takes: d a divisor of 256 whose rows are a multiple of 16
//    bytes, G * d <= 4096, K and V 16-byte aligned.  Every LM of the
//    registry (head_dim 16, 128 or 256, G * d <= 2048) and every layer
//    slice of a cache is; the entry point refuses anything else.
//  * A second launch merges each (b, h)'s partial (m, l, acc) over the
//    chunks: weights exp(m_i - M), out = sum w_i acc_i / max(sum w_i l_i,
//    1e-30), cast to q's type with round-to-nearest-even.
//  * Precise expf and tanhf, no fast-math: the f32 sweep holds 2e-6.
//
// The entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // keys per shared-memory tile: one per lane of a warp
constexpr int kMaxAcc = 16;  // accumulators per thread: G * d <= kThreads * kMaxAcc
constexpr float kMasked = -1e30f;  // the reference's score for a masked position
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// 16 bytes from global to shared memory without passing through registers;
// with valid = false the 16 bytes are filled with zeros and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(uint4 raw, float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(uint4 raw, float* dst, __nv_bfloat16) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the low half is the first element
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Shared memory of the split kernel: q in f32 (g x d); then, in the inputs'
// type T, two K tiles (kTile rows of pitch kp) and two V tiles (kTile x d);
// then, 16-byte aligned, the f32 scores (g x kTile) and m, l, alpha.  The K
// rows are padded by 16 bytes, so each quarter-warp's 16-byte reads of 8
// keys fall in distinct banks.  At most ~150 KB for the shapes taken.
struct SplitSmem {
  int kp;
  size_t tiles_bytes, total;
  __host__ __device__ SplitSmem(int g, int d, int elem) {
    kp = d + 16 / elem;
    tiles_bytes = sizeof(float) * static_cast<size_t>(g) * d +
                  static_cast<size_t>(elem) * 2 * kTile * (kp + d);
    tiles_bytes = (tiles_bytes + 15) / 16 * 16;
    total = tiles_bytes + sizeof(float) * (static_cast<size_t>(g) * kTile + 3 * g);
  }
};

// One block per (chunk of S, b * hkv + h): the chunk's partial softmax state.
// part_ml is (B*Hkv, n_split, 2, G): the running max, then the sum;
// part_acc is (B*Hkv, n_split, G, d).  ACC (a power of two, G * d <=
// kThreads * ACC) is the accumulators a thread holds: no instruction is
// issued for one it does not.
template <typename T, int ACC>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ cur_ptr, int s_len,
                    int hkv, int g, int d, float scale, float cap, int window, int chunk,
                    float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const SplitSmem lay(g, d, sizeof(T));
  const int kp = lay.kp;
  float* q_s = reinterpret_cast<float*>(smem);  // g * d
  T* kb = reinterpret_cast<T*>(q_s + g * d);    // 2 * kTile * kp
  T* vb = kb + 2 * kTile * kp;             // 2 * kTile * d
  float* p_s = reinterpret_cast<float*>(smem + lay.tiles_bytes);  // g * kTile
  float* m_s = p_s + g * kTile;            // g: running max
  float* l_s = m_s + g;                    // g: running sum
  float* a_s = l_s + g;                    // g: the tile's rescale factor

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = blockIdx.y;
  const int b = pair / hkv, h = pair % hkv;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int gd = g * d;
  const long long cur = *cur_ptr;

  // the positions the mask keeps: [lo_v, hi_v]
  const long long lo_v = window > 0 ? (cur - window + 1 > 0 ? cur - window + 1 : 0) : 0;
  const long long hi_v = cur < s_len - 1 ? cur : s_len - 1;
  const bool any = lo_v <= hi_v;
  int start = split * chunk;
  int end = start + chunk < s_len ? start + chunk : s_len;
  if (any) {
    if (start < lo_v) start = static_cast<int>(lo_v);
    if (end > hi_v + 1) end = static_cast<int>(hi_v + 1);
  }

  for (int e = tid; e < gd; e += kThreads) q_s[e] = to_f(q[static_cast<size_t>(pair) * gd + e]);
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;

  // K and V rows t0 .. t0 + kTile of the (b, h) pair into buffer buf; rows
  // past `end` are zeros
  auto issue = [&](int t0, int buf) {
    const int n = end - t0 < kTile ? end - t0 : kTile;
    T* kd = kb + buf * kTile * kp;
    T* vd = vb + buf * kTile * d;
    const int vpr = d / kVec;
    for (int e = tid; e < kTile * vpr; e += kThreads) {
      const int t = e / vpr, c = (e % vpr) * kVec;
      const bool ok = t < n;
      const size_t off =
          ((static_cast<size_t>(b) * s_len + (ok ? t0 + t : 0)) * hkv + h) *
              static_cast<size_t>(d) + c;
      cp_async16(kd + t * kp + c, k + off, ok);
      cp_async16(vd + t * d + c, v + off, ok);
    }
    cp_async_commit();
  };

  int buf = 0;
  if (start < end) issue(start, 0);
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = end - t0 < kTile ? end - t0 : kTile;
    if (t0 + kTile < end) {
      issue(t0 + kTile, buf ^ 1);  // its buffer was freed by the last tile's final barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kb + buf * kTile * kp;
    const T* vs = vb + buf * kTile * d;

    for (int e = tid; e < g * kTile; e += kThreads) {
      const int gi = e / kTile, t = e % kTile;
      float sc = -INFINITY;  // past the chunk: no weight at all
      if (t < n) {  // 16 bytes of k a read; two chains of sums
        const float4* q4 = reinterpret_cast<const float4*>(q_s + gi * d);
        const uint4* k4 = reinterpret_cast<const uint4*>(ks + t * kp);
        float dots[2] = {0.f, 0.f};
#pragma unroll 4
        for (int i = 0; i < d / kVec; ++i) {
          float ka[kVec];
          unpack(k4[i], ka, T());
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {
            const float4 qa = q4[i * (kVec / 4) + j / 4];
            float& acc_dot = dots[(j / 4) % 2];
            acc_dot = fmaf(qa.x, ka[j], acc_dot);
            acc_dot = fmaf(qa.y, ka[j + 1], acc_dot);
            acc_dot = fmaf(qa.z, ka[j + 2], acc_dot);
            acc_dot = fmaf(qa.w, ka[j + 3], acc_dot);
          }
        }
        sc = (dots[0] + dots[1]) * scale;
        if (cap > 0.f) sc = cap * tanhf(sc / cap);
        if (!any) sc = kMasked;
      }
      p_s[e] = sc;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += kWarps) {
      const float sc = p_s[gi * kTile + lane];
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, warp_max(sc));  // finite: the tile has a key
      const float p = expf(sc - m_new);
      const float sum = warp_sum(p);
      p_s[gi * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // d divides the block: accumulator r of a thread is head g0 + r * gstep
    // at column j (element tid + r * kThreads of the g x d output), so each
    // value read serves all its heads.  The keys past n weigh 0 and their
    // rows are 0: the whole tile adds them exactly.
    const int j = tid % d, g0 = tid / d, gstep = kThreads / d;
#pragma unroll
    for (int r = 0; r < ACC; ++r)
      if (g0 + r * gstep < g) acc[r] *= a_s[g0 + r * gstep];
    for (int t = 0; t < kTile; t += 4) {
      const float v0 = to_f(vs[t * d + j]), v1 = to_f(vs[(t + 1) * d + j]);
      const float v2 = to_f(vs[(t + 2) * d + j]), v3 = to_f(vs[(t + 3) * d + j]);
#pragma unroll
      for (int r = 0; r < ACC; ++r) {
        const int gi = g0 + r * gstep;
        if (gi < g) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + gi * kTile + t);
          float a = acc[r];
          a = fmaf(p.x, v0, a);
          a = fmaf(p.y, v1, a);
          a = fmaf(p.z, v2, a);
          a = fmaf(p.w, v3, a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  float* ml = part_ml + (static_cast<size_t>(pair) * n_split + split) * 2 * g;
  if (tid < g) {
    ml[tid] = m_s[tid];
    ml[g + tid] = l_s[tid];
  }
  float* pa = part_acc + (static_cast<size_t>(pair) * n_split + split) * gd;
#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int e = tid + r * kThreads;
    if (e < gd) pa[e] = acc[r];
  }
}

// One block per b * hkv + h: merges the chunks' partial states.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    int n_split, int g, int d, T* __restrict__ out) {
  extern __shared__ float w_s[];  // n_split * g weights, then g denominators
  float* den_s = w_s + n_split * g;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = blockIdx.x;
  const int gd = g * d;
  const float* ml = part_ml + static_cast<size_t>(pair) * n_split * 2 * g;
  for (int gi = warp; gi < g; gi += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < n_split; i += 32) m = fmaxf(m, ml[i * 2 * g + gi]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n_split; i += 32) {
      const float w = expf(ml[i * 2 * g + gi] - m);  // an empty chunk: m_i = -inf, w = 0
      w_s[i * g + gi] = w;
      l = fmaf(w, ml[i * 2 * g + g + gi], l);
    }
    l = warp_sum(l);
    if (lane == 0) den_s[gi] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* acc = part_acc + static_cast<size_t>(pair) * n_split * gd;
  for (int e = tid; e < gd; e += kThreads) {
    const int gi = e / d;
    float a = 0.f;
    for (int i = 0; i < n_split; ++i) a = fmaf(w_s[i * g + gi], acc[static_cast<size_t>(i) * gd + e], a);
    out[static_cast<size_t>(pair) * gd + e] = from_f<T>(a / den_s[gi]);
  }
}

// Calls f(std::integral_constant<int, ACC>) with the fewest accumulators a
// thread needs for G * d, a power of two up to kMaxAcc.
template <typename F>
cudaError_t with_acc(int gd, F&& f) {
  const int need = (gd + kThreads - 1) / kThreads;
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if (need <= 2) return f(std::integral_constant<int, 2>{});
  if (need <= 4) return f(std::integral_constant<int, 4>{});
  if (need <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, kMaxAcc>{});
}

// The shapes the split kernel takes (see the header): d a divisor of
// kThreads with rows a multiple of 16 bytes, G * d <= kThreads * kMaxAcc.
bool takes(int g, int d, int elem) {
  return g > 0 && d > 0 && kThreads % d == 0 && d * elem % 16 == 0 &&
         g * d <= kThreads * kMaxAcc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* cur, int b, int s,
                   int hkv, int g, int d, float scale, float cap, int window, int chunk,
                   int n_split, float* part_ml, float* part_acc, void* out,
                   cudaStream_t stream) {
  const size_t smem = SplitSmem(g, d, sizeof(T)).total;
  cudaError_t err = with_acc(g * d, [&](auto acc) {
    constexpr int kAcc = decltype(acc)::value;
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, kAcc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    decode_split_kernel<T, kAcc><<<dim3(n_split, b * hkv), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cur, s,
        hkv, g, d, scale, cap, window, chunk, part_ml, part_acc);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const size_t merge_smem = sizeof(float) * (static_cast<size_t>(n_split) * g + g);
  decode_merge_kernel<T><<<b * hkv, kThreads, merge_smem, stream>>>(
      part_ml, part_acc, n_split, g, d, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t blocks_per_sm(int g, int d, int* n) {
  const size_t smem = SplitSmem(g, d, sizeof(T)).total;
  return with_acc(g * d, [&](auto acc) {
    constexpr int kAcc = decltype(acc)::value;
    const void* fn = reinterpret_cast<const void*>(decode_split_kernel<T, kAcc>);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, fn, kThreads, smem);
  });
}

}  // namespace

extern "C" {

// Blocks of the split kernel one SM holds at once for these shapes (0 on
// error or shapes it does not take): the wrapper sizes the split so the
// blocks fill whole waves.
int decode_attention_blocks_per_sm(int g, int d, int dtype) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && takes(g, d, sizeof(float)))
    err = blocks_per_sm<float>(g, d, &n);
  else if (dtype == 1 && takes(g, d, sizeof(__nv_bfloat16)))
    err = blocks_per_sm<__nv_bfloat16>(g, d, &n);
  return err == cudaSuccess ? n : 0;
}

// q (b, hkv, g, d), k and v (b, s, hkv, d), out (b, hkv, g, d), row-major
// and contiguous, all float32 (dtype 0) or bfloat16 (dtype 1), k and v
// 16-byte aligned; cur is an int32 on the device.  cap <= 0 means no
// softcap, window <= 0 no window.
// The wrapper picks chunk (a multiple of 32) and n_split with chunk *
// n_split >= s, and allocates part_ml (b*hkv, n_split, 2, g) and part_acc
// (b*hkv, n_split, g, d) f32.  Launches on `stream`; does not synchronise.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* cur,
                            int b, int s, int hkv, int g, int d, float scale, float cap,
                            int window, int dtype, int chunk, int n_split, void* part_ml,
                            void* part_acc, void* out, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || b <= 0 || s <= 0 || hkv <= 0 || !takes(g, d, elem) ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      chunk <= 0 || chunk % kTile != 0 || n_split <= 0 || n_split > 65535 ||
      static_cast<long long>(chunk) * n_split < s || static_cast<long long>(b) * hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cur);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, c, b, s, hkv, g, d, scale, cap, window, chunk,
                                 n_split, ml, acc, out, st)
                 : launch<__nv_bfloat16>(q, k, v, c, b, s, hkv, g, d, scale, cap, window,
                                         chunk, n_split, ml, acc, out, st);
  return static_cast<int>(err);
}

}  // extern "C"
