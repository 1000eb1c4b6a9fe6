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
// with q (B, Hkv, G, d), k and v (B, S, Hkv, d) in bf16 or f32 and cur an
// int32 scalar read on the device (the cache's fill level), so a decode
// step never waits on the host.
//
// What bounds it on an H100: bytes.  Every valid K and V row is read once
// and used for all G heads of its group: at gemma-2b's decode shape (B =
// 64, Hkv = 1, G = 8, d = 256, S = 32768, bf16) that is 2.15 GB per layer,
// 0.64 ms at 3.35 TB/s.  A key row costs 4 * d bytes (K and V in bf16) and
// brings 4 * G * d flops: G = 8 flops per byte.  On the CUDA cores those
// f32 FMAs, with a bf16 unpack per element and the shared-memory traffic
// around them, take more instruction slots than the bytes leave time for;
// on the tensor cores 8 flops per byte is ~27 TFLOP/s of the ~990 there.
//
// Both paths use flash-decoding: B * Hkv is only 64 at gemma-2b's decode
// shape, against 132 SMs, so S is split into n_split chunks (the wrapper
// sizes the split from the kernel's occupancy, so the blocks fill whole
// waves), one block per (chunk, b, h).  A block sweeps only the positions
// of its chunk that the mask keeps (pos <= cur and, with a window, pos >
// cur - window): blocks wholly past cur, or wholly before the window, read
// nothing.  Masked positions weigh exp(-1e30 - m) = 0 exactly in the
// reference, so skipping them is the same function.  When the mask keeps
// no position at all (a window that lies past the cache), the reference's
// softmax is uniform over S, and the blocks then sweep every position with
// the score -1e30.  The window-slice mode (slice_w > 0, the reference's
// decode_window_slice lever on a local layer) plans the split over the
// slice_w keys of the window slice instead of S: each block computes the
// slice's start from cur on the device and reads rows base + j, with the
// batch stride still S, so every block of the split has keys of the window
// where over S most would be empty.  A second launch merges each (b, h)'s
// partial (m, l, acc) states: weights exp(m_i - M), out = sum w_i acc_i /
// max(sum w_i l_i, 1e-30), cast to q's type with round-to-nearest-even.
// Precise expf and tanhf, no fast-math.
//
// bf16 (the decode path's type), decode_tc_kernel<D>:
//  * Both products on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//    q.k: the rows of A are query heads, eight a group (rows 8-15 zero), B
//    the keys, read from shared memory by ldmatrix; bf16 products are
//    exact in f32, so only the order of the f32 sums differs from the
//    reference.  p.v: the reference keeps p in f32, so p goes in as two
//    bf16 halves, hi = bf16(p) and lo = bf16(p - hi) (~16 bits of p): the
//    A rows of head g are hi and row g + 8 lo, so the one mma that the
//    group's padding leaves free takes both, and a thread adds its two
//    accumulator rows at the end.  V is B, read by ldmatrix.trans.
//  * The online softmax runs on the mma's accumulator fragments: a lane
//    holds four scores of one head, the row max comes from two quad
//    shuffles, the row sum stays a lane's partial to the end.  Scores never
//    go through shared memory.
//  * Copies without per-thread instructions: one producer warp starts 1-D
//    bulk copies (cp.async.bulk, completing on an mbarrier) into a ring of
//    `stages` stages, ~200 KB: with one block an SM, two or more stages
//    (>= 130 KB) are in flight while the consumers read one.  A copy moves
//    a unit of 1 KB of consecutive positions (two rows at d = 256; with Hkv
//    > 1 the rows of a unit are strided, one copy a row): at one 512-byte
//    row a copy the copy engine, not HBM, set the rate.  Units are padded
//    by 16 bytes, and an ldmatrix operand takes one position from each of
//    eight units, so its eight rows fall in distinct banks.  Each stage
//    has a full barrier (the producer's expected bytes) and an empty one
//    (one arrival per consumer warp); no __syncthreads in the loop.
//  * Four consumer warps split a stage's keys (key slots) and, when G is
//    wide, the head groups (head slots): each warp keeps its own (m, l,
//    acc) over its keys and writes it as a partial state of its own, so
//    the merge launch combines n_split * key_slots partials and the block
//    never synchronises after its start.  A warp holds up to
//    max(1, 128 / d) head groups' accumulators and q fragments.
//  * The ring is zeroed at the start when the block's last tile is
//    partial and lands in a stage no full tile filled before, so the rows
//    the mma reads past the keys are finite (they weigh 0).  At d = 8 the
//    q.k k-step's columns 8-15 are zero registers, not shared memory.
//
// f32, decode_split_kernel: the CUDA-core path (the tensor cores would
// round f32 to TF32, and this path holds 2e-6): 256 threads a block, tiles
// of 32 keys staged by cp.async into two buffers, one thread per (head,
// key) for the dot products, one warp per head for the online softmax,
// and each thread up to 16 of the G x d accumulators in registers.
//
// What both take: d a divisor of 256 whose rows are a multiple of 16
// bytes, G * d <= 4096, K and V 16-byte aligned.  Every LM of the registry
// (head_dim 16, 128 or 256, G * d <= 2048) and every layer slice of a
// cache is; the entry point refuses anything else.
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
constexpr int kTile = 32;    // f32 path: keys per shared-memory tile, one per lane
constexpr int kMaxAcc = 16;  // f32 path: accumulators a thread, G * d <= kThreads * kMaxAcc
constexpr float kMasked = -1e30f;  // the reference's score for a masked position
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kTcWarps = 4;  // bf16 path: consumer warps; one producer warp more
constexpr int kTcThreads = (kTcWarps + 1) * 32;
constexpr int kTcMinStages = 2;
constexpr int kTcMaxStages = 16;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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

// The positions of the chunk [base + split * chunk, +chunk) that the block
// sweeps: [start, end), and whether the mask keeps any position of the keys
// planned over at all.  Those keys are all of S (base 0), or with slice_w >
// 0 the window slice [base, base + slice_w), base = clamp(cur - (slice_w -
// 1), 0, S - slice_w), computed here from cur: the reference's
// decode_window_slice reads that slice and masks only pos <= cur in it.
struct Span {
  int start, end;
  bool any;
  __device__ Span(long long cur, int s_len, int window, int slice_w, int split, int chunk) {
    long long base = 0, len = s_len, lo_v = 0;
    if (slice_w > 0) {
      base = cur - (slice_w - 1);
      if (base > s_len - slice_w) base = s_len - slice_w;
      if (base < 0) base = 0;
      len = slice_w;
      lo_v = base;
    } else if (window > 0) {
      lo_v = cur - window + 1 > 0 ? cur - window + 1 : 0;
    }
    const long long hi_v = cur < base + len - 1 ? cur : base + len - 1;
    any = lo_v <= hi_v;
    const long long s0 = base + static_cast<long long>(split) * chunk;
    const long long e0 = s0 + chunk < base + len ? s0 + chunk : base + len;
    start = static_cast<int>(s0);
    end = static_cast<int>(e0);
    if (any) {
      if (start < lo_v) start = static_cast<int>(lo_v);
      if (end > hi_v + 1) end = static_cast<int>(hi_v + 1);
    }
  }
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core split kernel

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

// Shared memory of the split kernel: q (g x d); two K tiles (kTile rows of
// pitch kp) and two V tiles (kTile x d); the scores (g x kTile) and m, l,
// alpha.  The K rows are padded by 16 bytes, so each quarter-warp's
// 16-byte reads of 8 keys fall in distinct banks.
struct SplitSmem {
  int kp;
  size_t tiles_bytes, total;
  __host__ __device__ SplitSmem(int g, int d) {
    kp = d + 4;
    tiles_bytes = sizeof(float) * (static_cast<size_t>(g) * d + 2 * kTile * (kp + d));
    total = tiles_bytes + sizeof(float) * (static_cast<size_t>(g) * kTile + 3 * g);
  }
};

// One block per (chunk of S, b * hkv + h): the chunk's partial softmax state.
// part_ml is (B*Hkv, n_split, 2, G): the running max, then the sum;
// part_acc is (B*Hkv, n_split, G, d).  ACC (a power of two, G * d <=
// kThreads * ACC) is the accumulators a thread holds: no instruction is
// issued for one it does not.
template <int ACC>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ cur_ptr, int s_len,
                    int hkv, int g, int d, float scale, float cap, int window, int slice_w,
                    int chunk, float* __restrict__ part_ml, float* __restrict__ part_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SplitSmem lay(g, d);
  const int kp = lay.kp;
  float* q_s = reinterpret_cast<float*>(smem);  // g * d
  float* kb = q_s + g * d;                       // 2 * kTile * kp
  float* vb = kb + 2 * kTile * kp;               // 2 * kTile * d
  float* p_s = reinterpret_cast<float*>(smem + lay.tiles_bytes);  // g * kTile
  float* m_s = p_s + g * kTile;            // g: running max
  float* l_s = m_s + g;                    // g: running sum
  float* a_s = l_s + g;                    // g: the tile's rescale factor

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = blockIdx.y;
  const int b = pair / hkv, h = pair % hkv;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int gd = g * d;
  const Span span(*cur_ptr, s_len, window, slice_w, split, chunk);
  const int start = span.start, end = span.end;

  for (int e = tid; e < gd; e += kThreads) q_s[e] = q[static_cast<size_t>(pair) * gd + e];
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
    float* kd = kb + buf * kTile * kp;
    float* vd = vb + buf * kTile * d;
    const int vpr = d / 4;
    for (int e = tid; e < kTile * vpr; e += kThreads) {
      const int t = e / vpr, c = (e % vpr) * 4;
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
    const float* ks = kb + buf * kTile * kp;
    const float* vs = vb + buf * kTile * d;

    for (int e = tid; e < g * kTile; e += kThreads) {
      const int gi = e / kTile, t = e % kTile;
      float sc = -INFINITY;  // past the chunk: no weight at all
      if (t < n) {  // 16 bytes of k a read
        const float4* q4 = reinterpret_cast<const float4*>(q_s + gi * d);
        const float4* k4 = reinterpret_cast<const float4*>(ks + t * kp);
        float dot = 0.f;
#pragma unroll 4
        for (int i = 0; i < d / 4; ++i) {
          const float4 ka = k4[i], qa = q4[i];
          dot = fmaf(qa.x, ka.x, dot);
          dot = fmaf(qa.y, ka.y, dot);
          dot = fmaf(qa.z, ka.z, dot);
          dot = fmaf(qa.w, ka.w, dot);
        }
        sc = dot * scale;
        if (cap > 0.f) sc = cap * tanhf(sc / cap);
        if (!span.any) sc = kMasked;
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
      const float v0 = vs[t * d + j], v1 = vs[(t + 1) * d + j];
      const float v2 = vs[(t + 2) * d + j], v3 = vs[(t + 3) * d + j];
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel fed by a bulk-copy ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, by the copy engine; completes its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a (16 x 16, row-major bf16) * b (16 x 8, column-major bf16), f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The ring's copy unit: kUnitRowBytes of consecutive positions (1 KB: the
// copy engine reaches the HBM rate from ~1 KB a copy, not at one 512-byte
// row a copy), then 16 bytes of padding.  A consumer warp takes eight units
// of K and eight of V a stage.
constexpr int kUnitRowBytes = 1024;
constexpr int kUnitBytes = kUnitRowBytes + 16;

// Shapes of the tensor-core kernel for head width D: a row's bytes, the
// positions of a copy unit, the keys a consumer warp takes a stage (eight
// units), the mma k-steps of q.k, the 8-column n-tiles of the output, and
// the head groups (eight heads each) a warp can hold: 4 * kNt + 2 * kSteps
// + 2 registers a group (at most 162, at D = 256), and G * D <= 4096 needs
// at most 512 / D groups, so four head slots suffice.
//
// Bank layout: unit u of a stage part starts at u * kUnitBytes, a multiple
// of 16 bytes that is 16 more than a multiple of 128, so the same column
// of position i in eight consecutive units falls in eight distinct 16-byte
// bank groups.  An 8 x 8 ldmatrix operand is therefore taken from the
// eight positions i + kR * u, u = 0..7 (one per unit), and a 16-key mma
// step j from i = 2 j and 2 j + 1: keys are summed in that order, the same
// order for q.k and p.v, which is the same sum.
template <int D>
struct Tc {
  static constexpr int kRow = 2 * D;
  static constexpr int kR = kUnitRowBytes / kRow;
  static constexpr int kKeys = 8 * kR;
  static constexpr int kSteps = D < 16 ? 1 : D / 16;
  static constexpr int kNt = D / 8;
  static constexpr int kMaxGroups = D >= 128 ? 1 : 128 / D;
};

__host__ __device__ constexpr int tc_max_groups(int d) { return d >= 128 ? 1 : 128 / d; }
__host__ __device__ constexpr int tc_stage_bytes(int key_slots) {
  return 2 * 8 * key_slots * kUnitBytes;
}
int tc_stage_keys(int d, int head_slots) {
  return kTcWarps / head_slots * 8 * (kUnitRowBytes / (2 * d));
}
size_t tc_smem_bytes(int stages, int head_slots) {
  return stages * (static_cast<size_t>(tc_stage_bytes(kTcWarps / head_slots)) +
                   2 * sizeof(uint64_t));
}

// One block per (chunk of S, b * hkv + h).  Warp kTcWarps is the producer;
// consumer warp w is head slot w % head_slots and key slot w / head_slots,
// and writes partial state split * key_slots + key slot: part_ml is
// (B*Hkv, n_part, 2, G) and part_acc (B*Hkv, n_part, G, D), n_part =
// n_split * key_slots.  A stage holds key_slots * Tc<D>::kKeys keys.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ cur_ptr, int s_len, int hkv,
                 int g, float scale, float cap, int window, int slice_w, int chunk, int stages,
                 int head_slots, float* __restrict__ part_ml, float* __restrict__ part_acc) {
  using S = Tc<D>;
  constexpr int kR = S::kR, kRow = S::kRow;
  const int key_slots = kTcWarps / head_slots;
  const int stage_keys = key_slots * S::kKeys;
  const int stage_bytes = tc_stage_bytes(key_slots);
  const int part_bytes = stage_bytes / 2;  // the K part, then the V part
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * stage_bytes);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pair = blockIdx.y;
  const int b = pair / hkv, h = pair % hkv;
  const int split = blockIdx.x;
  const Span span(*cur_ptr, s_len, window, slice_w, split, chunk);
  const int n_keys = span.end > span.start ? span.end - span.start : 0;
  const int n_tiles = (n_keys + stage_keys - 1) / stage_keys;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_keys % stage_keys != 0 && n_tiles <= stages) {
    // the last tile is partial and lands in a stage no tile filled before:
    // the rows past its keys, which weigh 0, must be finite
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = stages * stage_bytes / 16;
    for (int i = tid; i < n16; i += kTcThreads) z[i] = make_uint4(0, 0, 0, 0);
    // the zeros are ordered before the copy engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcWarps) {  // the producer: every tile's K and V rows, a unit a copy
    const size_t pos_stride = static_cast<size_t>(hkv) * D;  // elements between positions
    const size_t base = (static_cast<size_t>(b) * s_len * hkv + h) * D;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % stages;
      if (it >= stages) mbar_wait(&empty[st], (it / stages - 1) & 1);
      const int t0 = span.start + it * stage_keys;
      const int n = span.end - t0 < stage_keys ? span.end - t0 : stage_keys;
      if (lane == 0) mbar_arrive_expect_tx(&full[st], 2u * n * kRow);
      __syncwarp();
      unsigned char* kd = smem + static_cast<size_t>(st) * stage_bytes;
      for (int u = lane; u * kR < n; u += 32) {
        const int r0 = u * kR, nr = n - r0 < kR ? n - r0 : kR;
        unsigned char* ku = kd + u * kUnitBytes;
        const size_t off = base + static_cast<size_t>(t0 + r0) * pos_stride;
        if (hkv == 1) {  // the unit's positions are contiguous
          bulk_copy(ku, k + off, nr * kRow, &full[st]);
          bulk_copy(ku + part_bytes, v + off, nr * kRow, &full[st]);
        } else {
          for (int i = 0; i < nr; ++i) {
            bulk_copy(ku + i * kRow, k + off + i * pos_stride, kRow, &full[st]);
            bulk_copy(ku + part_bytes + i * kRow, v + off + i * pos_stride, kRow, &full[st]);
          }
        }
      }
    }
    return;
  }

  // the consumers
  const int hs = warp % head_slots, ks = warp / head_slots;
  const int key0 = ks * S::kKeys;  // this warp's first key of a stage
  const int n_groups = (g + 7) / 8;
  const int row = lane / 4, quad = lane % 4;

  // q as the A fragments of q.k: a0 and a2 of each k-step (rows 8-15 zero)
  uint32_t qa[S::kMaxGroups][S::kSteps][2];
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(pair) * g * D);
#pragma unroll
  for (int j = 0; j < S::kMaxGroups; ++j) {
    const int head = (hs + head_slots * j) * 8 + row;
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk) {
      const int col = kk * 16 + 2 * quad;
      const bool ok = head < g;
      qa[j][kk][0] = ok && col < D ? q32[(head * D + col) / 2] : 0u;
      qa[j][kk][1] = ok && col + 8 < D ? q32[(head * D + col + 8) / 2] : 0u;
    }
  }
  float o[S::kMaxGroups][S::kNt][4];
  float m[S::kMaxGroups], l[S::kMaxGroups];
#pragma unroll
  for (int j = 0; j < S::kMaxGroups; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][nt][e] = 0.f;
  }

  // this lane's ldmatrix row (bytes from the warp's first unit of a part):
  // K by keys i = 2 j (lanes 0-15) and 2 j + 1 (16-31) of units 0-7, at
  // columns 0-7 and 8-15 of a k-step; V transposed by keys 2 j (lanes 0-7,
  // 16-23) and 2 j + 1 (8-15, 24-31) at the columns of two n-tiles
  const int unit = (lane & 7) * kUnitBytes;
  const int k_lane = D < 16 ? unit + ((lane >> 3) & 1) * kRow
                            : unit + ((lane >> 4) & 1) * kRow + ((lane >> 3) & 1) * 16;
  const int v_lane = unit + ((lane >> 3) & 1) * kRow + (lane >> 4) * 16;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    const int t0 = span.start + it * stage_keys;
    const int n = span.end - t0 < stage_keys ? span.end - t0 : stage_keys;
    const uint32_t warp_units = smem_u32(smem + static_cast<size_t>(st) * stage_bytes) +
                                ks * 8 * kUnitBytes;
    for (int jj = 0; jj < kR / 2 && key0 + 2 * jj < n; ++jj) {  // warp-uniform
      const uint32_t k_base = warp_units + k_lane + 2 * jj * kRow;
      const uint32_t v_base = warp_units + part_bytes + v_lane + 2 * jj * kRow;
#pragma unroll
      for (int j = 0; j < S::kMaxGroups; ++j) {
        if (hs + head_slots * j >= n_groups) break;  // warp-uniform
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (D < 16) {  // columns 8-15 of the k-step are zero in q
          uint32_t bk[2];
          ldsm_x2(bk, k_base);
          mma_bf16(sc[0], qa[j][0][0], 0u, 0u, 0u, bk[0], 0u);
          mma_bf16(sc[1], qa[j][0][0], 0u, 0u, 0u, bk[1], 0u);
        } else {
#pragma unroll
          for (int kk = 0; kk < S::kSteps; ++kk) {
            uint32_t bk[4];
            ldsm_x4(bk, k_base + 32 * kk);
            mma_bf16(sc[0], qa[j][kk][0], 0u, qa[j][kk][1], 0u, bk[0], bk[1]);
            mma_bf16(sc[1], qa[j][kk][0], 0u, qa[j][kk][1], 0u, bk[2], bk[3]);
          }
        }
        // head `row` of the group at key 2 jj + nt + kR (2 quad + e) of the
        // warp's units: sc[nt][e]
        float mx = m[j];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[nt][e] * scale;
            if (cap > 0.f) x = cap * tanhf(x / cap);
            if (!span.any) x = kMasked;
            if (key0 + 2 * jj + nt + kR * (2 * quad + e) >= n) x = -INFINITY;  // no weight
            sc[nt][e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));  // finite: key 2 jj is kept
        const float alpha = expf(m[j] - mx);
        m[j] = mx;
        uint32_t pa[4];  // a0, a1, a2, a3: n-tile 0 hi, lo; n-tile 1 hi, lo
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float p0 = expf(sc[nt][0] - mx), p1 = expf(sc[nt][1] - mx);
          ps += p0 + p1;
          const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
          pa[2 * nt] = pack_bf16(h0, h1);
          pa[2 * nt + 1] = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                                     __float2bfloat16_rn(p1 - __bfloat162float(h1)));
        }
        l[j] = l[j] * alpha + ps;
#pragma unroll
        for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][nt][e] *= alpha;
        if constexpr (S::kNt == 1) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, v_base);
          mma_bf16(o[j][0], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < S::kNt; nt += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, v_base + 16 * nt);
            mma_bf16(o[j][nt], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
            mma_bf16(o[j][nt + 1], pa[0], pa[1], pa[2], pa[3], bv[2], bv[3]);
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const int n_part = gridDim.x * key_slots;
  const size_t part = static_cast<size_t>(pair) * n_part + split * key_slots + ks;
  float* ml = part_ml + part * 2 * g;
  float* pacc = part_acc + part * g * D;
#pragma unroll
  for (int j = 0; j < S::kMaxGroups; ++j) {
    const int head = (hs + head_slots * j) * 8 + row;
    float lj = l[j];
    lj += __shfl_xor_sync(kFull, lj, 1);
    lj += __shfl_xor_sync(kFull, lj, 2);
    if (head >= g) continue;
    if (quad == 0) {
      ml[head] = m[j];
      ml[g + head] = lj;
    }
    float* dst = pacc + static_cast<size_t>(head) * D + 2 * quad;
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt)  // rows g and g + 8 are p's two halves
      *reinterpret_cast<float2*>(dst + nt * 8) =
          make_float2(o[j][nt][0] + o[j][nt][2], o[j][nt][1] + o[j][nt][3]);
  }
}

// ---------------------------------------------------------------------------

// Merges the n_part partial states of each (b, h) pair: block (x, pair)
// writes output elements x * kThreads .. + kThreads of the pair's G x d,
// one a thread, after a warp a head of them has computed the head's max M
// and denominator.  (Spread over G * d / 256 blocks a pair, the merge is
// not bound by one block's load latency.)
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    int n_part, int g, int d, T* __restrict__ out) {
  __shared__ float m_s[kThreads + 1], den_s[kThreads + 1];  // the block's heads
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = blockIdx.y;
  const int gd = g * d;
  const int e0 = blockIdx.x * kThreads;
  const int h0 = e0 / d;
  const int h1 = (e0 + kThreads - 1) / d < g - 1 ? (e0 + kThreads - 1) / d : g - 1;
  const float* ml = part_ml + static_cast<size_t>(pair) * n_part * 2 * g;
  const float* acc = part_acc + static_cast<size_t>(pair) * n_part * gd;
  for (int gi = h0 + warp; gi <= h1; gi += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < n_part; i += 32) m = fmaxf(m, ml[i * 2 * g + gi]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n_part; i += 32)  // an empty partial: m_i = -inf, weight 0
      l = fmaf(expf(ml[i * 2 * g + gi] - m), ml[i * 2 * g + g + gi], l);
    l = warp_sum(l);
    if (lane == 0) {
      m_s[gi - h0] = m;
      den_s[gi - h0] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  const int e = e0 + tid;
  if (e >= gd) return;
  const int gi = e / d;
  const float m = m_s[gi - h0];
  float a = 0.f;
  for (int i = 0; i < n_part; ++i)
    a = fmaf(expf(ml[i * 2 * g + gi] - m), acc[static_cast<size_t>(i) * gd + e], a);
  out[static_cast<size_t>(pair) * gd + e] = from_f<T>(a / den_s[gi - h0]);
}

// Calls f(std::integral_constant<int, ACC>) with the fewest accumulators a
// thread of the f32 split kernel needs for G * d, a power of two up to
// kMaxAcc.
template <typename F>
cudaError_t with_acc(int gd, F&& f) {
  const int need = (gd + kThreads - 1) / kThreads;
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if (need <= 2) return f(std::integral_constant<int, 2>{});
  if (need <= 4) return f(std::integral_constant<int, 4>{});
  if (need <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, kMaxAcc>{});
}

// Calls f(std::integral_constant<int, D>) for a head width of the
// tensor-core kernel.
template <typename F>
cudaError_t with_d(int d, F&& f) {
  switch (d) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// The shapes the kernels take (see the header): d a divisor of kThreads
// with rows a multiple of 16 bytes, G * d <= kThreads * kMaxAcc.
bool takes(int g, int d, int elem) {
  return g > 0 && d > 0 && kThreads % d == 0 && d * elem % 16 == 0 &&
         g * d <= kThreads * kMaxAcc;
}

// The tensor-core kernel's ring and head slots: stages in range, and each
// warp holding at most tc_max_groups(d) head groups.
bool tc_takes(int g, int d, int stages, int head_slots) {
  return stages >= kTcMinStages && stages <= kTcMaxStages &&
         (head_slots == 1 || head_slots == 2 || head_slots == 4) &&
         ((g + 7) / 8 + head_slots - 1) / head_slots <= tc_max_groups(d);
}

cudaError_t launch_f32(const float* q, const float* k, const float* v, const int* cur, int b,
                       int s, int hkv, int g, int d, float scale, float cap, int window,
                       int slice_w, int chunk, int n_split, float* part_ml, float* part_acc,
                       cudaStream_t stream) {
  const size_t smem = SplitSmem(g, d).total;
  return with_acc(g * d, [&](auto acc) {
    constexpr int kAcc = decltype(acc)::value;
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<kAcc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    decode_split_kernel<kAcc><<<dim3(n_split, b * hkv), kThreads, smem, stream>>>(
        q, k, v, cur, s, hkv, g, d, scale, cap, window, slice_w, chunk, part_ml, part_acc);
    return cudaGetLastError();
  });
}

cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const int* cur, int b,
                      int s, int hkv, int g, int d, float scale, float cap, int window,
                      int slice_w, int chunk, int n_split, int stages, int head_slots,
                      float* part_ml, float* part_acc, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(stages, head_slots);
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    cudaError_t e = cudaFuncSetAttribute(decode_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    decode_tc_kernel<D><<<dim3(n_split, b * hkv), kTcThreads, smem, stream>>>(
        q, k, v, cur, s, hkv, g, scale, cap, window, slice_w, chunk, stages, head_slots,
        part_ml, part_acc);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Blocks of the split kernel one SM holds at once for these shapes (0 on
// error or shapes it does not take): the wrapper sizes the split so the
// blocks fill whole waves.  dtype 0 is f32 (the CUDA-core kernel), 1 bf16
// (the tensor-core kernel with a ring of `stages` stages and `head_slots`
// head slots).
int decode_attention_blocks_per_sm(int g, int d, int dtype, int stages, int head_slots) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && takes(g, d, sizeof(float))) {
    const size_t smem = SplitSmem(g, d).total;
    err = with_acc(g * d, [&](auto acc) {
      constexpr int kAcc = decltype(acc)::value;
      const void* fn = reinterpret_cast<const void*>(decode_split_kernel<kAcc>);
      cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem);
    });
  } else if (dtype == 1 && takes(g, d, sizeof(bf16)) && tc_takes(g, d, stages, head_slots)) {
    const size_t smem = tc_smem_bytes(stages, head_slots);
    err = with_d(d, [&](auto dc) {
      constexpr int D = decltype(dc)::value;
      const void* fn = reinterpret_cast<const void*>(decode_tc_kernel<D>);
      cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kTcThreads, smem);
    });
  }
  return err == cudaSuccess ? n : 0;
}

// q (b, hkv, g, d), k and v (b, s, hkv, d), out (b, hkv, g, d), row-major
// and contiguous, all float32 (dtype 0) or bfloat16 (dtype 1), k and v
// 16-byte aligned; cur is an int32 on the device.  cap <= 0 means no
// softcap, window <= 0 no window.  slice_w in 1..s reads only the window
// slice of slice_w keys that ends at cur (Span; window must then be <= 0),
// 0 all of S.
// The wrapper picks chunk and n_split with chunk * n_split >= the keys
// planned over (s, or slice_w), for bf16
// the ring's stages and the head slots (1, 2 or 4; key_slots = 4 /
// head_slots); chunk is a multiple of 32 keys for f32 and of a stage's
// keys, key_slots * 4096 / d, for bf16.  It allocates
// part_ml (b*hkv, n_part, 2, g) and part_acc (b*hkv, n_part, g, d) f32,
// n_part = n_split for f32 and n_split * key_slots for bf16.  Launches on
// `stream`; does not synchronise.
int decode_attention_launch(const void* q, const void* k, const void* v, const void* cur,
                            int b, int s, int hkv, int g, int d, float scale, float cap,
                            int window, int slice_w, int dtype, int chunk, int n_split,
                            int stages, int head_slots, void* part_ml, void* part_acc,
                            void* out, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !takes(g, d, elem) ||
      (dtype == 1 && !tc_takes(g, d, stages, head_slots)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = dtype == 0 ? kTile : tc_stage_keys(d, head_slots);
  const int keys = slice_w > 0 ? slice_w : s;  // the keys the split covers
  if (b <= 0 || s <= 0 || hkv <= 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || chunk <= 0 || chunk % tile != 0 ||
      n_split <= 0 || n_split > 65535 || static_cast<long long>(chunk) * n_split < keys ||
      static_cast<long long>(b) * hkv > 65535 || slice_w < 0 || slice_w > s ||
      (slice_w > 0 && window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cur);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int n_part;
  if (dtype == 0) {
    err = launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), c, b, s, hkv, g, d, scale, cap, window,
                     slice_w, chunk, n_split, ml, acc, st);
    n_part = n_split;
  } else {
    err = launch_tc(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), c, b, s, hkv, g, d, scale, cap, window,
                    slice_w, chunk, n_split, stages, head_slots, ml, acc, st);
    n_part = n_split * (kTcWarps / head_slots);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid((g * d + kThreads - 1) / kThreads, b * hkv);
  if (dtype == 0)
    decode_merge_kernel<float><<<merge_grid, kThreads, 0, st>>>(ml, acc, n_part, g, d,
                                                                static_cast<float*>(out));
  else
    decode_merge_kernel<bf16><<<merge_grid, kThreads, 0, st>>>(ml, acc, n_part, g, d,
                                                               static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
