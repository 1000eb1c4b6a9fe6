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
// What bounds it on an H100: bytes.  Every kept K and V row is read once
// and used for all G heads of its group: a key costs 4 * d bytes (K and V
// in bf16) and brings 4 * G * d flops, G flops a byte, against the ~295
// the tensor cores could do a byte.  At llama4-scout's decode shape (B 16,
// Hkv 8, G 5, d 128, S 32768) a layer reads 2.15 GB, 0.64 ms at 3.35 TB/s;
// at gemma-2b's (B 64, Hkv 1, G 8, d 256) as much.
//
// The keys the mask keeps are the same for every (b, h) pair (cur is one
// scalar): pos <= cur and, with a window, pos > cur - window.  The
// window-slice mode (slice_w > 0, the reference's decode_window_slice
// lever on a local layer) keeps the slice [base, base + slice_w), base =
// clamp(cur - (slice_w - 1), 0, S - slice_w), masked by pos <= cur alone.
// Masked positions weigh exp(-1e30 - m) = 0 exactly in the reference, so
// skipping them is the same function.  When the mask keeps no position at
// all (a window that lies past the cache), the reference's softmax is
// uniform over S (or the slice), and the kernels then sweep every
// position with the score -1e30.  Both paths write partial (m, l, acc)
// states over pieces of the keys and a second launch merges each (b,
// h)'s: weights exp(m_i - M), out = sum w_i acc_i / max(sum w_i l_i,
// 1e-30), cast to q's type with round-to-nearest-even.  Precise expf and
// tanhf, no fast-math.
//
// bf16 (the decode path's type), decode_tc_kernel<D>:
//  * The work: a persistent grid, one block an SM (the wrapper sizes it
//    from the occupancy).  Each pair's n kept keys are cut into T =
//    ceil(n / stage_keys) tiles of one ring stage, the pairs' tiles are
//    laid end to end (pair-major), and block i of the first min(grid,
//    total) takes tiles [ceil(i * total / grid), ceil((i + 1) * total /
//    grid)): every SM gets the same work whatever the pair count, with no
//    host sync: the block computes its range from cur.  A block's tiles
//    may span pairs, and the ring runs on across them.  Two blocks an SM,
//    each with half the ring, measured the same, and their register cap
//    (168) spilled.
//  * The copies: TMA tiled tensor copies.  The wrapper encodes one
//    CUtensorMap for K and one for V, each the 4-D tensor (d, Hkv, S, B)
//    with byte strides (2d, 2d Hkv, 2d Hkv S).  A box is min(d, 64)
//    columns x 1 head x stage_keys positions x 1 batch: one instruction
//    moves a stage's rows of one kv head, however far apart the heads put
//    them, and the copy engine walks the stride (a bulk copy per 2d-byte
//    row would let the copy count, not HBM, set the rate).  A row is d /
//    64 boxes at d >= 64; the map promotes L2 fills to 256 bytes, so the
//    first box of a row brings the second's half too.  Per stage lane 0
//    of the producer warp sets one expect-tx of the stage's bytes on its
//    full barrier and starts 2 * ceil(d / 64) copies.
//  * The shared layout: box c of a stage's K (or V) part is stage_keys
//    rows of min(2d, 128) bytes, swizzled by the copy (SWIZZLE_128B, 64B,
//    32B; none at d = 8): 16-byte chunk w of row r lands at chunk w ^ x(r),
//    x(r) = (r * row bytes / 128) mod (row bytes / 16).  The ldmatrix
//    addresses apply the same XOR, so an 8 x 8 operand's eight rows (eight
//    consecutive keys) fall in eight distinct 16-byte bank groups.  Stage
//    parts start on 1024 bytes, the 128-byte swizzle's period.
//  * No box brings a position past the tile's end into the products
//    (slots past cur may hold anything, NaN included): a tile shorter than
//    a stage has its box moved back to end at the tile's end.  Its first
//    rows then re-read positions below the tile (filled slots of the
//    cache) or, before position 0, the copy's zero fill, and get no
//    weight.  Nothing of the ring is zeroed.
//  * Both products on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//    q.k: the rows of A are query heads, eight a group (rows 8-15 zero), B
//    sixteen consecutive keys, read from shared memory by ldmatrix, the
//    odd k-steps into a second accumulator (four mma chains, not two);
//    bf16 products are exact in f32, so only the order of the f32 sums
//    differs from the reference.  p.v: the reference keeps p in f32, so p
//    goes in as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi) (~16
//    bits of p): the A rows of head g are hi and row g + 8 lo, so the one
//    mma that the group's padding leaves free takes both, and the two
//    accumulator rows are added at the end.  V is B, read by
//    ldmatrix.trans.
//  * The online softmax runs on the mma's accumulator fragments: a lane
//    holds four scores of one head, the row max comes from two quad
//    shuffles, the row sum stays a lane's partial to the end.  The
//    accumulators are rescaled only when a row's max moved (a factor of 1
//    is exact).  Scores never go through shared memory.
//  * Four consumer warps split a stage's keys (key slots) and, when G is
//    wide, the head groups (head slots); a warp holds up to max(1, 128 /
//    d) head groups' accumulators and q fragments.  Each stage has a full
//    barrier (the producer's expected bytes) and an empty one (one arrival
//    per consumer warp); no __syncthreads in the loop.  At the end of a
//    (pair, segment) key slot 0 takes the other key slots' states through
//    shared memory (named barrier 1 over the consumers) and writes one
//    partial state.  At d = 8 the q.k k-step's columns 8-15 are zero
//    registers, not shared memory.
//  * The merge launch: the block holding a pair's last tile writes how
//    many segments the pair has; decode_merge_kernel merges that many in
//    one pass (online rescaling), issuing its first loads beside the
//    count.  It is a programmatic dependent launch, so its blocks are
//    placed while the kernel runs.  (Merging inside the kernel, by the last
//    of a pair's blocks, measured slower: one block's 128 threads a pair
//    where the launch spreads a pair over G * d / 256 blocks.)
//  * What bounds it: HBM.  A consumer warp's 16-key step is ~150
//    instructions against the ~2,000 cycles an SM's share of the HBM rate
//    leaves for it, and the ring keeps two or more stages (>= 64 KB) in
//    flight per SM, more than the ~25 KB the HBM's latency-rate product
//    asks of each SM.  Every geometry takes this path: at Hkv 1, where a
//    kv head's rows are contiguous, the boxes measured faster than 1 KB
//    bulk copies of consecutive rows.
//
// f32, decode_split_kernel: the CUDA-core path (the tensor cores would
// round f32 to TF32, and this path holds 2e-6; not on the decode path): S
// split into n_split chunks a pair (the wrapper sizes the split from the
// kernel's occupancy, so the blocks fill whole waves), one block per
// (chunk, b, h); blocks wholly past cur, or wholly before the window,
// read nothing.  256
// threads a block, tiles of 32 keys staged by cp.async into two buffers,
// one thread per (head, key) for the dot products, one warp per head for
// the online softmax, and each thread up to 16 of the G x d accumulators
// in registers.
//
// What both take: d a divisor of 256 whose rows are a multiple of 16
// bytes, G * d <= 4096, K and V 16-byte aligned.  Every LM of the registry
// (head_dim 16, 128 or 256, G * d <= 2048) and every layer slice of a
// cache is; the entry points refuse anything else.
//
// The entry points return cudaGetLastError() after their launches.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda.h>
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

// f32: the positions of the chunk [base + split * chunk, +chunk) that the
// block sweeps: [start, end), and whether the mask keeps any position of the keys
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
// bf16: the tensor-core kernel fed by TMA tensor copies

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

// The box of `map` at (column c0, kv head c1, position c2, batch c3) into
// shared memory by the TMA unit, completing its bytes on `bar`; positions
// outside the tensor (below 0) are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(smem_u32(bar))
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

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
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

// Shapes of the tensor-core kernel for head width D: a row's bytes, a box
// row's bytes (the widest the 128-byte swizzle takes) and the boxes a row
// spans, the mma k-steps of q.k, the 8-column n-tiles of the output, the
// head groups (eight heads each) a warp can hold (4 * kNt + 2 * kSteps + 2
// registers a group, at most 162 at D = 256; G * D <= 4096 needs at most
// 512 / D groups, so four head slots suffice).
template <int D>
struct Tc {
  static constexpr int kRow = 2 * D;
  static constexpr int kBoxBytes = kRow < 128 ? kRow : 128;
  static constexpr int kBoxes = kRow / kBoxBytes;
  static constexpr int kChunks = kBoxBytes / 16;  // 16-byte chunks of a box row
  static constexpr int kSteps = D < 16 ? 1 : D / 16;
  static constexpr int kNt = D / 8;
  static constexpr int kMaxGroups = D >= 128 ? 1 : 128 / D;
  // what a lane holds of a head group at a segment's end: m, l and the
  // two accumulator columns of each n-tile
  static constexpr int kGroupVals = 2 + 2 * kNt;
};

__host__ __device__ constexpr int tc_max_groups(int d) { return d >= 128 ? 1 : 128 / d; }
// bytes of the key slots' exchange: three warps' lanes' states
__host__ __device__ constexpr int tc_exchange_bytes(int d) {
  return (kTcWarps - 1) * 32 * tc_max_groups(d) * (2 + d / 4) * 4;
}
__host__ __device__ constexpr int tc_stage_bytes(int d, int stage_keys) {
  return 2 * stage_keys * 2 * d;
}
// the ring (stages parts on 1024 bytes, with the slack to align its start),
// a full and an empty barrier a stage, and the key slots' exchange
size_t tc_smem_bytes(int d, int stages, int stage_keys) {
  return 1024 +
         static_cast<size_t>(stages) * (tc_stage_bytes(d, stage_keys) + 2 * sizeof(uint64_t)) +
         tc_exchange_bytes(d);
}

// The positions a bf16 call sweeps, the same for every (b, h) pair:
// [lo, lo + n), and whether the mask keeps any of them (if not, all of S
// or of the window slice, each scored -1e30).
struct Keys {
  long long lo;
  int n;
  bool any;
  __device__ Keys(long long cur, int s_len, int window, int slice_w) {
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
    lo = any ? lo_v : base;
    n = static_cast<int>(any ? hi_v - lo_v + 1 : len);
  }
};

// The work of a bf16 call: `tiles` stages of keys for each of `pairs`
// pairs, pair-major, divided evenly over the first min(grid, total)
// blocks, so each of those has a tile and the blocks one pair's tiles
// span are consecutive.  Block i takes tiles [first(i), first(i + 1));
// tile t belongs to block owner(t).
struct Work {
  int tiles;
  long long total;
  int grid;
  __device__ Work(int n_keys, int stage_keys, int pairs, int grid_)
      : tiles((n_keys + stage_keys - 1) / stage_keys),
        total(static_cast<long long>(pairs) * tiles),
        grid(grid_ < total ? grid_ : static_cast<int>(total)) {}
  __device__ long long first(int block) const { return (block * total + grid - 1) / grid; }
  __device__ int owner(long long tile) const { return static_cast<int>(tile * grid / total); }
};

// Named barrier 1 over the consumer warps (the producer runs on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcWarps * 32) : "memory");
}

// A persistent block: warp kTcWarps is the producer; consumer warp w is
// head slot w % head_slots and key slot w / head_slots.  At the end of
// each (pair, segment of the block) the key slots' states are combined
// through shared memory and key slot 0 writes partial state pair *
// max_slots + segment, the segment being this block's index less that of
// the block holding the pair's first tile: part_ml is (B*Hkv, max_slots,
// 2, G) and part_acc (B*Hkv, max_slots, G, D); the block holding a pair's
// last tile writes n_segments[pair].  A stage holds stage_keys keys,
// stage_keys / key_slots a warp.  Each block lets the merge launch start
// at once (programmatic dependent launch: the merge waits for this grid).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
decode_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
                 const int* __restrict__ cur_ptr, int s_len, int pairs, int hkv, int g,
                 float scale, float cap, int window, int slice_w, int stage_keys, int stages,
                 int head_slots, int max_slots, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int* __restrict__ n_segments) {
  using S = Tc<D>;
  constexpr int kBB = S::kBoxBytes, kCh = S::kChunks;
  const int key_slots = kTcWarps / head_slots;
  const int part_bytes = stage_keys * S::kRow;  // the K part, then the V part
  const int stage_bytes = 2 * part_bytes;
  const int box_bytes = stage_keys * kBB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(stages) * stage_bytes);
  uint64_t* empty = full + stages;
  float* exchange = reinterpret_cast<float*>(empty + stages);

  if (threadIdx.x == kTcWarps * 32) {  // the producer's copies' maps, while cur loads
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map)) : "memory");
  }
  const Keys keys(*cur_ptr, s_len, window, slice_w);
  const Work work(keys.n, stage_keys, pairs, gridDim.x);
  if (static_cast<int>(blockIdx.x) >= work.grid) return;  // more blocks than tiles
  const long long t_begin = work.first(blockIdx.x);
  const int n_tiles = static_cast<int>(work.first(blockIdx.x + 1) - t_begin);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the first tile's pair and its index in the pair; the loops step both
  const int pair0 = static_cast<int>(t_begin / work.tiles);
  const int j0 = static_cast<int>(t_begin - static_cast<long long>(pair0) * work.tiles);
  const long long keys_end = keys.lo + keys.n;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcWarps) {  // the producer: a stage's boxes of K and V
    if (lane != 0) return;
    int pair = pair0, j = j0;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % stages;
      if (it >= stages) mbar_wait(&empty[st], (it / stages - 1) & 1);
      const long long t0 = keys.lo + static_cast<long long>(j) * stage_keys;
      const long long end = t0 + stage_keys < keys_end ? t0 + stage_keys : keys_end;
      const int row0 = static_cast<int>(end - stage_keys);  // the box ends at the tile's end
      const int b = pair / hkv, h = pair % hkv;
      unsigned char* dst = ring + static_cast<size_t>(st) * stage_bytes;
      mbar_arrive_expect_tx(&full[st], stage_bytes);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_load_4d(dst + c * box_bytes, &k_map, c * (kBB / 2), h, row0, b, &full[st]);
        tma_load_4d(dst + part_bytes + c * box_bytes, &v_map, c * (kBB / 2), h, row0, b,
                    &full[st]);
      }
      if (++j == work.tiles) {
        j = 0;
        ++pair;
      }
    }
    return;
  }

  // the consumers
  const int hs = warp % head_slots, ks = warp / head_slots;
  const int warp_keys = stage_keys / key_slots;
  const int w_lo = ks * warp_keys;  // this warp's first row of a stage
  const int n_groups = (g + 7) / 8;
  const int row = lane / 4, quad = lane % 4;
  // this lane's ldmatrix row of a 16-key step and the XOR of its 16-byte
  // chunk: K by keys 0-7 (lanes 0-15) and 8-15 (16-31) at columns 0-7 and
  // 8-15 of a k-step (lanes 8-15, 24-31; at D = 8 keys 8-15 are lanes
  // 8-15); V transposed by keys 0-7 (lanes 0-7, 16-23) and 8-15 (8-15,
  // 24-31) at the columns of two n-tiles (lanes 16-31 the second).  The
  // step's first key is a multiple of 16, so the swizzle of a row depends
  // on the lane alone.
  const int key_k = (D < 16 ? (lane >> 3) & 1 : lane >> 4) * 8 + (lane & 7);
  const int key_v = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int x_k = (D < 16 ? 0 : (lane >> 3) & 1) ^ ((key_k * kBB >> 7) & (kCh - 1));
  const int x_v = (D < 16 ? 0 : lane >> 4) ^ ((key_v * kBB >> 7) & (kCh - 1));

  uint32_t qa[S::kMaxGroups][S::kSteps][2];  // q as the A fragments of q.k (rows 8-15 zero)
  float o[S::kMaxGroups][S::kNt][4];
  float m[S::kMaxGroups], l[S::kMaxGroups];
  int pair = pair0, j_tile = j0;  // the tile's
  int seg_pair = -1, segment = 0;  // the segment's
  for (int it = 0; it <= n_tiles; ++it) {
    const int p = it < n_tiles ? pair : -1;
    if (p != seg_pair) {
      if (seg_pair >= 0) {  // the segment's partial state: key slot 0 combines the others'
        constexpr int kVals = S::kMaxGroups * S::kGroupVals;
#pragma unroll
        for (int j = 0; j < S::kMaxGroups; ++j) {  // rows g and g + 8 are p's two halves
          l[j] += __shfl_xor_sync(kFull, l[j], 1);
          l[j] += __shfl_xor_sync(kFull, l[j], 2);
#pragma unroll
          for (int nt = 0; nt < S::kNt; ++nt) {
            o[j][nt][0] += o[j][nt][2];
            o[j][nt][1] += o[j][nt][3];
          }
        }
        if (ks > 0) {
          float* x = exchange + ((hs * (key_slots - 1) + ks - 1) * kVals) * 32 + lane;
#pragma unroll
          for (int j = 0; j < S::kMaxGroups; ++j) {
            float* xj = x + j * S::kGroupVals * 32;
            xj[0] = m[j];
            xj[32] = l[j];
#pragma unroll
            for (int nt = 0; nt < S::kNt; ++nt) {
              xj[(2 + 2 * nt) * 32] = o[j][nt][0];
              xj[(3 + 2 * nt) * 32] = o[j][nt][1];
            }
          }
        }
        consumers_sync();
        if (ks == 0) {
          for (int k = 1; k < key_slots; ++k) {
            const float* x = exchange + ((hs * (key_slots - 1) + k - 1) * kVals) * 32 + lane;
#pragma unroll
            for (int j = 0; j < S::kMaxGroups; ++j) {
              const float* xj = x + j * S::kGroupVals * 32;
              const float mk = xj[0], mx = fmaxf(m[j], mk);
              // weights exp(m - M); a state with no key (m = -inf) weighs 0
              const float wa = m[j] == -INFINITY ? 0.f : expf(m[j] - mx);
              const float wb = mk == -INFINITY ? 0.f : expf(mk - mx);
              m[j] = mx;
              l[j] = l[j] * wa + xj[32] * wb;
#pragma unroll
              for (int nt = 0; nt < S::kNt; ++nt) {
                o[j][nt][0] = o[j][nt][0] * wa + xj[(2 + 2 * nt) * 32] * wb;
                o[j][nt][1] = o[j][nt][1] * wa + xj[(3 + 2 * nt) * 32] * wb;
              }
            }
          }
          const size_t part = static_cast<size_t>(seg_pair) * max_slots + segment;
          float* ml = part_ml + part * 2 * g;
          float* pacc = part_acc + part * g * D;
#pragma unroll
          for (int j = 0; j < S::kMaxGroups; ++j) {
            const int head = (hs + head_slots * j) * 8 + row;
            if (head >= g) continue;
            if (quad == 0) {
              ml[head] = m[j];
              ml[g + head] = l[j];
            }
            float* dst = pacc + static_cast<size_t>(head) * D + 2 * quad;
#pragma unroll
            for (int nt = 0; nt < S::kNt; ++nt)
              *reinterpret_cast<float2*>(dst + nt * 8) = make_float2(o[j][nt][0], o[j][nt][1]);
          }
        }
        consumers_sync();  // the exchange is free again
      }
      if (p < 0) break;
      seg_pair = p;
      segment = blockIdx.x - work.owner(static_cast<long long>(p) * work.tiles);
      const uint32_t* q32 =
          reinterpret_cast<const uint32_t*>(q + static_cast<size_t>(p) * g * D);
#pragma unroll
      for (int j = 0; j < S::kMaxGroups; ++j) {
        const int head = (hs + head_slots * j) * 8 + row;
        m[j] = -INFINITY;
        l[j] = 0.f;
#pragma unroll
        for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < S::kSteps; ++kk) {
          const int col = kk * 16 + 2 * quad;
          const bool ok = head < g;
          qa[j][kk][0] = ok && col < D ? q32[(head * D + col) / 2] : 0u;
          qa[j][kk][1] = ok && col + 8 < D ? q32[(head * D + col + 8) / 2] : 0u;
        }
      }
    }
    const long long t0 = keys.lo + static_cast<long long>(j_tile) * stage_keys;
    const long long end = t0 + stage_keys < keys_end ? t0 + stage_keys : keys_end;
    const int r_lo = static_cast<int>(t0 - (end - stage_keys));  // rows below: no weight
    if (j_tile == work.tiles - 1 && tid == 0) n_segments[pair] = segment + 1;
    if (++j_tile == work.tiles) {
      j_tile = 0;
      ++pair;
    }
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    const uint32_t k_part = smem_u32(ring + static_cast<size_t>(st) * stage_bytes);
    const uint32_t v_part = k_part + part_bytes;
    for (int kb = w_lo; kb < w_lo + warp_keys; kb += 16) {  // warp-uniform
      if (kb + 16 <= r_lo) continue;
      const uint32_t k_row = k_part + (kb + key_k) * kBB;
      const uint32_t v_row = v_part + (kb + key_v) * kBB;
#pragma unroll
      for (int j = 0; j < S::kMaxGroups; ++j) {
        if (hs + head_slots * j >= n_groups) break;  // warp-uniform
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (D < 16) {  // columns 8-15 of the k-step are zero in q
          uint32_t bk[2];
          ldsm_x2(bk, k_row);
          mma_bf16(sc[0], qa[j][0][0], 0u, 0u, 0u, bk[0], 0u);
          mma_bf16(sc[1], qa[j][0][0], 0u, 0u, 0u, bk[1], 0u);
        } else {
          // odd k-steps into a second accumulator: four mma chains, not two
          float sc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < S::kSteps; ++kk) {
            uint32_t bk[4];
            ldsm_x4(bk, k_row + (2 * kk / kCh) * box_bytes + ((((2 * kk) % kCh) ^ x_k) << 4));
            float (&acc)[2][4] = kk % 2 ? sc2 : sc;
            mma_bf16(acc[0], qa[j][kk][0], 0u, qa[j][kk][1], 0u, bk[0], bk[1]);
            mma_bf16(acc[1], qa[j][kk][0], 0u, qa[j][kk][1], 0u, bk[2], bk[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) sc[nt][e] += sc2[nt][e];
        }
        // head `row` of the group at stage row kb + 8 nt + 2 quad + e: sc[nt][e]
        float mx = m[j];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[nt][e] * scale;
            if (cap > 0.f) x = cap * tanhf(x / cap);
            if (!keys.any) x = kMasked;
            if (kb + 8 * nt + 2 * quad + e < r_lo) x = -INFINITY;  // counted before: no weight
            sc[nt][e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));  // finite: row kb + 15 is kept
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
        if (!__all_sync(kFull, alpha == 1.f)) {  // a row's max moved (x 1 is exact)
#pragma unroll
          for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[j][nt][e] *= alpha;
        }
        if constexpr (S::kNt == 1) {
          uint32_t bv[2];
          ldsm_x2_trans(bv, v_row);
          mma_bf16(o[j][0], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
        } else {
#pragma unroll
          for (int nt = 0; nt < S::kNt; nt += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, v_row + (nt / kCh) * box_bytes + (((nt % kCh) ^ x_v) << 4));
            mma_bf16(o[j][nt], pa[0], pa[1], pa[2], pa[3], bv[0], bv[1]);
            mma_bf16(o[j][nt + 1], pa[0], pa[1], pa[2], pa[3], bv[2], bv[3]);
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

// ---------------------------------------------------------------------------

// Merges the partial states of each (b, h) pair: n_part a pair, the first
// n_segments[pair] of them written (all n_part without n_segments).
// Block (x, pair) writes output elements x * kThreads .. + kThreads of the
// pair's G x d, one a thread; in f32 after a warp a head of them has
// computed the head's max M and denominator, in bf16 in one pass.
// (Spread over G * d / 256 blocks a pair, the merge is not bound by one
// block's load latency.)  After the bf16 kernel it is a programmatic
// dependent launch: its blocks are placed while that grid runs and wait
// for it here, so the launch's latency overlaps the kernel; after the f32
// kernel the wait returns at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    int n_part, const int* __restrict__ n_segments, int g, int d,
                    T* __restrict__ out) {
  __shared__ float m_s[kThreads + 1], den_s[kThreads + 1];  // the block's heads
  // launched as a programmatic dependent (bf16): the partials' grid done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = blockIdx.y;
  const int gd = g * d;
  const int e0 = blockIdx.x * kThreads;
  const float* ml = part_ml + static_cast<size_t>(pair) * n_part * 2 * g;
  const float* acc = part_acc + static_cast<size_t>(pair) * n_part * gd;
  if constexpr (std::is_same<T, bf16>::value) {
    // one pass, the max found as the partials come (online rescaling): a
    // thread's loads of eight partials issued together, the first eight
    // beside the pair's count, and no first pass over the heads; the extra
    // roundings are far inside a bf16 ulp
    constexpr int kChunk = 8;
    const int e = e0 + tid;
    if (e >= gd) return;
    const int gi = e / d;
    int n_valid = n_part;  // the first chunk's loads go out before the count is known
    float mx = -INFINITY, den = 0.f, a = 0.f;
    for (int i0 = 0; i0 < n_valid; i0 += kChunk) {
      float mi[kChunk], li[kChunk], ai[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = i0 + u < n_part ? i0 + u : n_part - 1;  // a slot of the pair's allocation
        mi[u] = ml[i * 2 * g + gi];
        li[u] = ml[i * 2 * g + g + gi];
        ai[u] = acc[static_cast<size_t>(i) * gd + e];
      }
      if (i0 == 0) n_valid = n_segments[pair];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (i0 + u >= n_valid || mi[u] == -INFINITY) continue;  // not written, or no weight
        if (mi[u] > mx) {  // rescale what came before (0 before the first)
          const float r = expf(mx - mi[u]);
          den *= r;
          a *= r;
          mx = mi[u];
        }
        const float w = expf(mi[u] - mx);
        den = fmaf(w, li[u], den);
        a = fmaf(w, ai[u], a);
      }
    }
    out[static_cast<size_t>(pair) * gd + e] = from_f<T>(a / fmaxf(den, 1e-30f));
    return;
  }
  const int n_valid = n_part;
  const int h0 = e0 / d;
  const int h1 = (e0 + kThreads - 1) / d < g - 1 ? (e0 + kThreads - 1) / d : g - 1;
  for (int gi = h0 + warp; gi <= h1; gi += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < n_valid; i += 32) m = fmaxf(m, ml[i * 2 * g + gi]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n_valid; i += 32)  // an empty partial: m_i = -inf, weight 0
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
#pragma unroll 8
  for (int i = 0; i < n_valid; ++i)  // the loads of eight partials in flight together
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

// The tensor-core kernel's ring and head slots: stages in range, a box of
// 64, 128 or 256 keys (at most 256 rows, and every key slot whole 16-key
// steps), each warp holding at most tc_max_groups(d) head groups.
bool tc_takes(int g, int d, int stages, int head_slots, int stage_keys) {
  return stages >= kTcMinStages && stages <= kTcMaxStages &&
         (head_slots == 1 || head_slots == 2 || head_slots == 4) &&
         (stage_keys == 64 || stage_keys == 128 || stage_keys == 256) &&
         ((g + 7) / 8 + head_slots - 1) / head_slots <= tc_max_groups(d);
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
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

// Sets the tensor-core kernel's shared memory for (d, stages, stage_keys)
// and calls f(kernel, smem bytes).
template <typename F>
cudaError_t with_tc(int d, int stages, int stage_keys, F&& f) {
  const size_t smem = tc_smem_bytes(d, stages, stage_keys);
  return with_d(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    const void* fn = reinterpret_cast<const void*>(decode_tc_kernel<D>);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    return f(decode_tc_kernel<D>, smem);
  });
}

}  // namespace

extern "C" {

// Blocks of a kernel one SM holds at once for these shapes (0 on error or
// shapes it does not take): the wrapper sizes the f32 split so its blocks
// fill whole waves, and the bf16 kernel's persistent grid.  dtype 0 is f32
// (the CUDA-core kernel), 1 bf16 (the tensor-core kernel with a ring of
// `stages` stages of `stage_keys` keys and `head_slots` head slots).
int decode_attention_blocks_per_sm(int g, int d, int dtype, int stages, int head_slots,
                                   int stage_keys) {
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
  } else if (dtype == 1 && takes(g, d, sizeof(bf16)) &&
             tc_takes(g, d, stages, head_slots, stage_keys)) {
    err = with_tc(d, stages, stage_keys, [&](auto kernel, size_t smem) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, reinterpret_cast<const void*>(kernel), kTcThreads, smem);
    });
  }
  return err == cudaSuccess ? n : 0;
}

// Encodes into `map` (128 bytes) the bf16 kernel's tensor map of a K or V
// cache at `base`, (b, s, hkv, d) row-major and 16-byte aligned: the 4-D
// tensor (d, hkv, s, b) with boxes of min(d, 64) columns x 1 x box_keys x
// 1, swizzled as the kernel reads them, positions outside the tensor read
// as zeros.  Returns 0, the driver's CUresult, or -1 when the driver has
// no cuTensorMapEncodeTiled.
int decode_attention_encode_map(void* map, const void* base, int b, int s, int hkv, int d,
                                int box_keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const int box_bytes = 2 * d < 128 ? 2 * d : 128;
  const CUtensorMapSwizzle swizzle =
      box_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : box_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(hkv),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * d;  // bytes
  const cuuint64_t strides[3] = {row, row * hkv, row * hkv * s};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_bytes / 2), 1,
                             static_cast<cuuint32_t>(box_keys), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap m;
  const CUresult r = encode(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) std::memcpy(map, &m, sizeof(m));
  return static_cast<int>(r);
}

// f32: q (b, hkv, g, d), k and v (b, s, hkv, d), out (b, hkv, g, d),
// row-major and contiguous, k and v 16-byte aligned; cur is an int32 on
// the device.  cap <= 0 means no softcap, window <= 0 no window.  slice_w
// in 1..s reads only the window slice of slice_w keys that ends at cur
// (Span; window must then be <= 0), 0 all of S.  The wrapper picks chunk
// (a multiple of 32 keys) and n_split with chunk * n_split >= the keys
// planned over (s, or slice_w), and allocates part_ml (b*hkv, n_split, 2,
// g) and part_acc (b*hkv, n_split, g, d) f32.  Launches on `stream`; does
// not synchronise.
int decode_attention_launch_f32(const void* q, const void* k, const void* v, const void* cur,
                                int b, int s, int hkv, int g, int d, float scale, float cap,
                                int window, int slice_w, int chunk, int n_split, void* part_ml,
                                void* part_acc, void* out, void* stream) {
  const int keys = slice_w > 0 ? slice_w : s;  // the keys the split covers
  if (!takes(g, d, sizeof(float)) || b <= 0 || s <= 0 || hkv <= 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      chunk <= 0 || chunk % kTile != 0 || n_split <= 0 || n_split > 65535 ||
      static_cast<long long>(chunk) * n_split < keys || static_cast<long long>(b) * hkv > 65535 ||
      slice_w < 0 || slice_w > s || (slice_w > 0 && window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaError_t err = launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<const int*>(cur), b, s,
                               hkv, g, d, scale, cap, window, slice_w, chunk, n_split, ml, acc,
                               st);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<float><<<dim3((g * d + kThreads - 1) / kThreads, b * hkv), kThreads, 0,
                               st>>>(ml, acc, n_split, nullptr, g, d,
                                     static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// bf16: q and out (b, hkv, g, d) row-major and contiguous; K and V through
// the tensor maps that decode_attention_encode_map made for them with
// box_keys = stage_keys; cur, cap, window and slice_w as for f32.  The
// wrapper picks the ring (stages of stage_keys keys), the head slots (1, 2
// or 4; key_slots = 4 / head_slots) and the persistent grid, and
// allocates part_ml (b*hkv, max_slots, 2, g) and part_acc (b*hkv,
// max_slots, g, d) f32 and n_segments
// (b*hkv) int32, with max_slots >= ceil(grid / (b*hkv)) + 1, the most
// blocks one pair's tiles can span.  Launches on `stream`; does not
// synchronise.
int decode_attention_launch_bf16(const void* k_map, const void* v_map, const void* q,
                                 const void* cur, int b, int s, int hkv, int g, int d,
                                 float scale, float cap, int window, int slice_w, int stage_keys,
                                 int stages, int head_slots, int grid, int max_slots,
                                 void* part_ml, void* part_acc, void* n_segments, void* out,
                                 void* stream) {
  const long long pairs = static_cast<long long>(b) * hkv;
  if (!takes(g, d, sizeof(bf16)) || !tc_takes(g, d, stages, head_slots, stage_keys) || b <= 0 ||
      s <= 0 || hkv <= 0 || pairs > 65535 || grid <= 0 || grid > 65535 ||
      max_slots < (grid + pairs - 1) / pairs + 1 || slice_w < 0 || slice_w > s ||
      (slice_w > 0 && window > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap km, vm;
  std::memcpy(&km, k_map, sizeof(km));
  std::memcpy(&vm, v_map, sizeof(vm));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  int* segs = static_cast<int*>(n_segments);
  cudaError_t err = with_tc(d, stages, stage_keys, [&](auto kernel, size_t smem) {
    kernel<<<grid, kTcThreads, smem, st>>>(km, vm, static_cast<const bf16*>(q),
                                           static_cast<const int*>(cur), s, b * hkv, hkv, g,
                                           scale, cap, window, slice_w, stage_keys, stages,
                                           head_slots, max_slots, ml, acc, segs);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t merge = {};
  merge.gridDim = dim3((g * d + kThreads - 1) / kThreads, b * hkv);
  merge.blockDim = dim3(kThreads);
  merge.stream = st;
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  merge.attrs = early;
  merge.numAttrs = 1;
  err = cudaLaunchKernelEx(&merge, decode_merge_kernel<bf16>, static_cast<const float*>(ml),
                           static_cast<const float*>(acc), max_slots,
                           static_cast<const int*>(segs), g, d, static_cast<bf16*>(out));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
