// Hopper kernels of the STD cache's serving step (sm_90a, plain C interface).
//
// Replaces the two Pallas TPU kernels of repro.kernels.cache_ops:
//
//   probe_and_commit_kernel<GATHER=false>
//                            <- kernel.py::probe_and_commit (body _kernel)
//   serve_fused (fill_kernel + probe_and_commit_kernel<GATHER=true>)
//                            <- serve_kernel.py::serve_fused (body _serve_kernel)
//
// Both share one commit body and one conflict round (kernel.py::
// conflict_round), so the two kernels agree by construction.
//
// What bounds them on an H100: bytes, and the bound is tiny.  A batch of B
// requests touches at most B cache sets; per request the kernels read ~22
// bytes of request fields plus 16 bytes of segment plan, per touched set
// they read and write one packed (4W) uint32 row, and the serve kernel also
// gathers one V-word value row per request.  At B = 4096, W = 8, V = 8 that
// is ~1.4 MB, under half a microsecond at 3.35 TB/s.
//
// What sets the time: the serial dependence through one set's row.  The
// requests of a segment (a run of requests to the same set, in arrival
// order) must be applied one after the other, each to the row its
// predecessors left; a serving batch's head query repeats tens of times in
// one set, and a small topic partition may own a single set.  So the
// deepest segment sets the time, and the design keeps device memory out of
// that serial chain.
//
// Design:
//  * One warp per segment (32-lane chunks of its requests, in arrival
//    order).  Every load is issued by the warp in bulk, outside the walk:
//    lane l loads the sort permutation order[lead + 32c + l] and then that
//    request's fields, one chunk ahead of the chunk being walked (two for
//    the permutation), so a deep segment's loads are in flight while the
//    previous chunk is walked.  A one-request segment costs the same round
//    trips as a lane walking it alone would, and a longer one no more, so no
//    segment is left to one lane (no short-segment threshold): on a batch
//    of one- to four-request segments the warp per segment is faster than
//    the first design's thread per segment (PERF.md).
//  * The warp stages its set's pristine row in shared memory.  Each lane
//    probes its own request against it (pre_hit, pre_way, pre_stale,
//    pre_epoch), folds the effective write epoch (ops.py:286-292: a
//    pristine fresh hit keeps its resident epoch) and its stamp
//    clock + 1 + pos, all in parallel; the serve kernel's lanes also issue
//    the chunk's value-row gather from the post-fill table here, spread so
//    that neighbouring lanes read neighbouring words, and store it after
//    the walk.
//  * Only the conflict rounds are serial.  Step j takes request j's
//    operands from lane j by __shfl_sync (the next step's while this one
//    runs), never from device memory.  The evolving row lives in the
//    warp's registers, way k on lane k (W <= 32), so a round is a handful of
//    warp votes: __ballot_sync finds the matching ways, __reduce_min_sync
//    the smallest stamp and a second ballot the ways holding it; the lowest
//    set bit is the first index, the reference's tie rule.  Lane j keeps
//    its request's way and write flag.  A round costs ~100 ns on an H100
//    (a chain of dependent votes), so a segment of d requests costs a few
//    round trips plus d rounds.  A chunk whose requests cannot write
//    (static hits and pads only: a serving batch's deepest segment is its
//    head query, which the static layer answers) leaves the row as it is,
//    so every lane resolves its own request against it at once, the ways
//    broadcast by shuffles, and the chunk takes no rounds.  (The other
//    schedule, the whole row in every lane's registers with each lane
//    running every round, was 2.5x slower at W = 8 and 4.7-6.8x at W = 32
//    on an H100 (PERF.md) and was not kept.)
//  * After each chunk the lanes write wrote and way at their arrival
//    positions; after the last chunk the warp writes the resolved row back
//    once, way k from lane k.  Sets are owned by exactly one segment, so no
//    two warps touch the same row; out-of-range sets clamp on the gather
//    and drop on the scatter, as jnp's gather/scatter(mode="drop") do.
//  * The TPU kernel recomputes the post-fill value table in every grid
//    step because its grid runs in order on one core.  Blocks here run in
//    no order, so the deferred fill is its own launch (fill_kernel) on the
//    same stream, before the commit launch reads any value row.  Its slots
//    are unique (the host glue dedupes them), so it writes the value table
//    in place with no ordering between threads.
//  * State words are uint32: keys, epochs and min_epoch compare unsigned;
//    stamps are int32 and compare signed.  The first index wins ties.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPadHi = 0xFFFFFFFFu;
constexpr uint32_t kPadLo = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;     // warps per block, one segment each
constexpr int kThreads = 32 * kWarps;
constexpr int kGatherRegs = 8;  // value words a lane holds across the walk

// request flags, packed into one word for the walk's shuffles
constexpr uint32_t kAdmit = 1u;
constexpr uint32_t kStatic = 2u;
constexpr uint32_t kPad = 4u;

// One request's operands of a conflict round.
struct Op {
  uint32_t hi, lo, ep, minep, flags;
  int32_t stamp;
};

__device__ __forceinline__ Op shfl_op(const Op& o, int src) {
  return Op{__shfl_sync(kFull, o.hi, src), __shfl_sync(kFull, o.lo, src),
            __shfl_sync(kFull, o.ep, src), __shfl_sync(kFull, o.minep, src),
            __shfl_sync(kFull, o.flags, src), __shfl_sync(kFull, o.stamp, src)};
}

// The write rule of one exact sequential LRU step (kernel.py:66), given
// the round's hit, its way and whether the way's epoch is below minep.
// A hit refreshes its way; an admitted miss evicts the LRU way.  A stale hit
// refreshes the stamp and takes the new epoch.  Static hits and the pad key
// never write.
__device__ __forceinline__ void write_rule(const Op& o, bool is_hit, bool way_stale,
                                           bool& do_write, bool& refresh) {
  do_write = !(o.flags & (kStatic | kPad)) && (is_hit || (o.flags & kAdmit));
  refresh = do_write && (!is_hit || way_stale);
}

// The evolving row spread over lanes: way k on lane k (W <= 32).  A round
// is a few warp votes: __ballot_sync for the matching ways and for the ways
// whose epoch is below the floor, __reduce_min_sync for the smallest stamp
// and a ballot of the ways holding it; the lowest set bit is the first
// index, as the reference's argmax/argmin take.
struct LaneRow {
  uint32_t hi, lo, ep;
  int32_t st;

  __device__ __forceinline__ void load(const uint32_t* row, int w, int lane) {
    const bool in = lane < w;
    hi = in ? row[lane] : 0u;
    lo = in ? row[w + lane] : 0u;
    st = in ? static_cast<int32_t>(row[2 * w + lane]) : INT_MAX;
    ep = in ? row[3 * w + lane] : 0u;
  }

  // One conflict round (kernel.py:66); returns 1 << the request's way.
  __device__ __forceinline__ unsigned round(const Op& o, int w, int lane, bool& refresh) {
    const bool in = lane < w;
    const unsigned hit = __ballot_sync(
        kFull, in && !(o.flags & kPad) && hi == o.hi && lo == o.lo && hi != 0u);
    const unsigned stale = __ballot_sync(kFull, ep < o.minep);
    // a miss takes the first way with the smallest stamp (computed on every
    // round: a branch around it was slower)
    const int32_t mn = __reduce_min_sync(kFull, st);  // INT_MAX past w
    const unsigned lru = __ballot_sync(kFull, in && st == mn);
    const unsigned sel = hit != 0u ? hit : lru;
    const unsigned low = sel & (0u - sel);
    bool do_write;
    write_rule(o, hit != 0u, (stale & low) != 0u, do_write, refresh);
    const bool mine = (low >> lane) & 1u;
    if (mine && do_write) {
      hi = o.hi;
      lo = o.lo;
      st = o.stamp;
    }
    if (mine && refresh) ep = o.ep;
    return low;
  }

  // The way (as 1 << way) of each lane's own request against the row as it
  // stands, for requests that do not write: every lane at once, the row's
  // ways broadcast by shuffles.
  template <int MAXW>
  __device__ __forceinline__ unsigned way_of(uint32_t qhi, uint32_t qlo, bool qpad,
                                             int w) const {
    unsigned hits = 0u, lru = 1u;
    int32_t mn = INT_MAX;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      const uint32_t h = __shfl_sync(kFull, hi, k);
      const uint32_t l = __shfl_sync(kFull, lo, k);
      const int32_t s = __shfl_sync(kFull, st, k);
      if (k < w) {
        if (!qpad && h == qhi && l == qlo && h != 0u) hits |= 1u << k;
        if (s < mn) {
          mn = s;
          lru = 1u << k;
        }
      }
    }
    return hits != 0u ? hits & (0u - hits) : lru;
  }

  __device__ __forceinline__ void store(uint32_t* row, int w, int lane) const {
    if (lane < w) {
      row[lane] = hi;
      row[w + lane] = lo;
      row[2 * w + lane] = static_cast<uint32_t>(st);
      row[3 * w + lane] = ep;
    }
  }
};

struct Args {
  uint32_t* ks;          // (n_sets, 4W) packed state, updated in place
  int n_sets;
  int w;
  const int32_t* order;  // (B,) sorted position -> arrival position
  const int32_t* leader; // (B,) first sorted position of each segment
  const int32_t* seg_len;// (B,) requests per segment (0 = no segment)
  const int32_t* seg_set;// (B,) set of each segment
  const uint32_t* h_hi;  // (B,) request hashes, arrival order
  const uint32_t* h_lo;
  const uint8_t* admit;  // (B,) bool
  const uint8_t* stat;   // (B,) bool: static-layer hits never write
  const uint32_t* epochs;// (B,) write epochs
  const uint32_t* minep; // (B,) freshness floors
  const int32_t* clock;  // () the cache clock
  int b;
  uint8_t* pre_hit;      // (B,) outputs, arrival order
  int32_t* pre_way;
  uint8_t* pre_stale;
  uint32_t* pre_epoch;
  uint8_t* wrote;
  int32_t* way;
  const int32_t* value;  // (n_sets * W, V) post-fill value table (serve only)
  int v;
  int32_t* vals;         // (B, V) probed value rows (serve only)
};

// One request's fields, loaded by the lane that owns it in a chunk.
struct Req {
  int pos;  // arrival position; -1 past the segment's end
  uint32_t hi, lo, epoch, minep;
  bool admit, stat;
};

__device__ __forceinline__ int order_at(const Args& a, int lead, int len, int j) {
  return j < len ? __ldg(a.order + lead + j) : -1;
}

__device__ __forceinline__ Req fields_at(const Args& a, int pos) {
  Req q{pos, 0u, 0u, 0u, 0u, false, false};
  if (pos >= 0) {
    q.hi = __ldg(a.h_hi + pos);
    q.lo = __ldg(a.h_lo + pos);
    q.epoch = __ldg(a.epochs + pos);
    q.minep = __ldg(a.minep + pos);
    q.admit = __ldg(a.admit + pos) != 0;
    q.stat = __ldg(a.stat + pos) != 0;
  }
  return q;
}

template <int MAXW, bool GATHER>
__global__ void __launch_bounds__(kThreads)
probe_and_commit_kernel(Args a) {
  __shared__ uint32_t pristine[kWarps][4 * MAXW];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wid;
  if (s >= a.b) return;  // warp-uniform from here on
  // the segment's plan in one round trip
  const int len = __ldg(a.seg_len + s);
  const int set = __ldg(a.seg_set + s);
  const int lead = __ldg(a.leader + s);
  if (len == 0) return;
  const int w = a.w;
  const int row_i = set < a.n_sets ? set : a.n_sets - 1;
  // the first two chunks' positions are in flight beside the row
  int pos_next = order_at(a, lead, len, lane);
  const int pos_after = order_at(a, lead, len, 32 + lane);
  uint32_t* prow = pristine[wid];
  const uint32_t* src = a.ks + static_cast<size_t>(row_i) * 4 * w;
  for (int k = lane; k < 4 * w; k += 32) prow[k] = src[k];
  const uint32_t clk = static_cast<uint32_t>(__ldg(a.clock));
  __syncwarp();
  LaneRow row;
  row.load(prow, w, lane);
  Req cur = fields_at(a, pos_next);
  pos_next = pos_after;
  for (int base = 0; base < len; base += 32) {
    // next chunk's fields and the one after's positions, in flight across
    // this chunk's walk
    const Req nxt = fields_at(a, pos_next);
    pos_next = order_at(a, lead, len, base + 64 + lane);
    const bool real = cur.pos >= 0;
    const bool pad = cur.hi == kPadHi && cur.lo == kPadLo;
    // probe against the pristine row: duplicates inside the batch miss
    bool pm_any = false;
    int pm_way = 0;
    uint32_t pm_ep = 0u;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      if (k < w && !pad && prow[k] == cur.hi && prow[w + k] == cur.lo && prow[k] != 0u) {
        if (!pm_any) pm_way = k;
        pm_any = true;
        pm_ep = prow[3 * w + k] > pm_ep ? prow[3 * w + k] : pm_ep;
      }
    }
    // effective write epoch (ops.py:286-292): a pristine fresh hit keeps
    // its resident epoch, so a mid-batch evict + re-insert cannot launder
    // the entry's age
    const bool fresh = pm_any && pm_ep >= cur.minep;
    const Op op{cur.hi, cur.lo, fresh ? pm_ep : cur.epoch, cur.minep,
                (cur.admit ? kAdmit : 0u) | (cur.stat ? kStatic : 0u) | (pad ? kPad : 0u),
                static_cast<int32_t>(clk + 1u + static_cast<uint32_t>(cur.pos))};
    if (real) {
      a.pre_hit[cur.pos] = pm_any;
      a.pre_way[cur.pos] = pm_way;
      a.pre_stale[cur.pos] = pm_any && pm_ep < cur.minep;
      a.pre_epoch[cur.pos] = pm_ep;
    }
    const int n = len - base < 32 ? len - base : 32;
    // the probed value rows: word t * 32 + lane of the chunk's n x V block,
    // loaded now and stored after the walk
    const int32_t* table = a.value + static_cast<size_t>(row_i) * w * a.v;
    int32_t gval[kGatherRegs];
    int gpos[kGatherRegs];  // the request's arrival position, -1 for none
    if (GATHER) {
#pragma unroll
      for (int t = 0; t < kGatherRegs; ++t) {
        const int i = t * 32 + lane;
        const int r = i / a.v;
        const int src_lane = r < 32 ? r : 31;
        const int p = __shfl_sync(kFull, cur.pos, src_lane);
        const int way = __shfl_sync(kFull, pm_way, src_lane);
        const bool ok = t < a.v && r < n;
        gval[t] = ok ? __ldg(table + way * a.v + i - r * a.v) : 0;
        gpos[t] = ok ? p : -1;
      }
    }
    // the serial part: one conflict round per request, in arrival order, its
    // operands by shuffle (the next request's while this one runs).  A chunk
    // in which no request can write (static hits and pads only, as a serving
    // batch's head query is) leaves the row as it is: every lane probes its
    // own request against the row at once.
    unsigned my_way;
    bool my_refresh = false;
    if (__ballot_sync(kFull, real && !cur.stat && !pad) == 0u) {
      my_way = row.way_of<MAXW>(cur.hi, cur.lo, pad, w);
    } else {
      my_way = 1u;
      Op o = shfl_op(op, 0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const Op next = shfl_op(op, j + 1 < 32 ? j + 1 : 31);
        bool refresh;
        const unsigned way = row.round(o, w, lane, refresh);
        if (lane == j) {
          my_way = way;
          my_refresh = refresh;
        }
        o = next;
      }
    }
    if (real) {
      a.wrote[cur.pos] = my_refresh;
      a.way[cur.pos] = __ffs(my_way) - 1;
    }
    if (GATHER) {
#pragma unroll
      for (int t = 0; t < kGatherRegs; ++t) {
        const int i = t * 32 + lane;
        if (gpos[t] >= 0) a.vals[static_cast<size_t>(gpos[t]) * a.v + i % a.v] = gval[t];
      }
      // value rows wider than kGatherRegs words: the rest, after the walk
      for (int t = kGatherRegs; t < a.v; ++t) {
        const int i = t * 32 + lane;
        const int r = i / a.v;
        const int src_lane = r < 32 ? r : 31;
        const int p = __shfl_sync(kFull, cur.pos, src_lane);
        const int way = __shfl_sync(kFull, pm_way, src_lane);
        const int c = i - r * a.v;
        if (r < n) a.vals[static_cast<size_t>(p) * a.v + c] = __ldg(table + way * a.v + c);
      }
    }
    cur = nxt;
  }
  if (set < a.n_sets) row.store(a.ks + static_cast<size_t>(set) * 4 * w, w, lane);
}

// Deferred value fill: value[f_slot[e]] = f_vals[e] for every slot in
// range.  Slots are unique, so threads never race.
__global__ void fill_kernel(int32_t* value, int nslots, int v,
                            const int32_t* f_slot, const int32_t* f_vals,
                            int f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(f) * v) return;
  const int e = static_cast<int>(i / v);
  const int c = static_cast<int>(i % v);
  const int slot = f_slot[e];
  if (slot < 0 || slot >= nslots) return;
  value[static_cast<size_t>(slot) * v + c] = f_vals[i];
}

// A launch of the commit kernel's grid that does nothing: the floor no
// launch of that shape beats.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

int commit_blocks(int b) { return (b + kWarps - 1) / kWarps; }

template <bool GATHER>
int launch_commit(const Args& a, cudaStream_t stream) {
  if (a.b == 0) return 0;
  const int blocks = commit_blocks(a.b);
  if (a.w <= 4) {
    probe_and_commit_kernel<4, GATHER><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.w <= 8) {
    probe_and_commit_kernel<8, GATHER><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.w <= 16) {
    probe_and_commit_kernel<16, GATHER><<<blocks, kThreads, 0, stream>>>(a);
  } else if (a.w <= 32) {
    probe_and_commit_kernel<32, GATHER><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int cache_ops_probe_and_commit(
    void* ks, int n_sets, int w, const void* order, const void* leader,
    const void* seg_len, const void* seg_set, const void* h_hi,
    const void* h_lo, const void* admit, const void* stat, const void* epochs,
    const void* minep, const void* clock, int b, void* pre_hit, void* pre_way,
    void* pre_stale, void* pre_epoch, void* wrote, void* way, void* stream) {
  Args a{static_cast<uint32_t*>(ks), n_sets, w,
         static_cast<const int32_t*>(order), static_cast<const int32_t*>(leader),
         static_cast<const int32_t*>(seg_len), static_cast<const int32_t*>(seg_set),
         static_cast<const uint32_t*>(h_hi), static_cast<const uint32_t*>(h_lo),
         static_cast<const uint8_t*>(admit), static_cast<const uint8_t*>(stat),
         static_cast<const uint32_t*>(epochs), static_cast<const uint32_t*>(minep),
         static_cast<const int32_t*>(clock), b,
         static_cast<uint8_t*>(pre_hit), static_cast<int32_t*>(pre_way),
         static_cast<uint8_t*>(pre_stale), static_cast<uint32_t*>(pre_epoch),
         static_cast<uint8_t*>(wrote), static_cast<int32_t*>(way),
         nullptr, 0, nullptr};
  return launch_commit<false>(a, static_cast<cudaStream_t>(stream));
}

int cache_ops_serve_fused(
    void* ks, int n_sets, int w, void* value, int v, const void* f_slot,
    const void* f_vals, int f, const void* order, const void* leader,
    const void* seg_len, const void* seg_set, const void* h_hi,
    const void* h_lo, const void* admit, const void* stat, const void* epochs,
    const void* minep, const void* clock, int b, void* vals, void* pre_hit,
    void* pre_way, void* pre_stale, void* pre_epoch, void* wrote, void* way,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t fill_n = static_cast<int64_t>(f) * v;
  if (fill_n > 0) {
    const int blocks = static_cast<int>((fill_n + 255) / 256);
    fill_kernel<<<blocks, 256, 0, st>>>(static_cast<int32_t*>(value),
                                        n_sets * w, v,
                                        static_cast<const int32_t*>(f_slot),
                                        static_cast<const int32_t*>(f_vals), f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{static_cast<uint32_t*>(ks), n_sets, w,
         static_cast<const int32_t*>(order), static_cast<const int32_t*>(leader),
         static_cast<const int32_t*>(seg_len), static_cast<const int32_t*>(seg_set),
         static_cast<const uint32_t*>(h_hi), static_cast<const uint32_t*>(h_lo),
         static_cast<const uint8_t*>(admit), static_cast<const uint8_t*>(stat),
         static_cast<const uint32_t*>(epochs), static_cast<const uint32_t*>(minep),
         static_cast<const int32_t*>(clock), b,
         static_cast<uint8_t*>(pre_hit), static_cast<int32_t*>(pre_way),
         static_cast<uint8_t*>(pre_stale), static_cast<uint32_t*>(pre_epoch),
         static_cast<uint8_t*>(wrote), static_cast<int32_t*>(way),
         static_cast<const int32_t*>(value), v, static_cast<int32_t*>(vals)};
  // rows of no words have nothing to gather: the commit alone
  return v > 0 ? launch_commit<true>(a, st) : launch_commit<false>(a, st);
}

// One launch of the commit kernel's grid for a batch of b that does
// nothing, on the given stream.
int cache_ops_empty_launch(int b, void* stream) {
  if (b <= 0) return 0;
  empty_kernel<<<commit_blocks(b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
