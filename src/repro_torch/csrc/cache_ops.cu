// Hopper kernels of the STD cache's serving step (sm_90a, plain C interface).
//
// Replaces the two Pallas TPU kernels of repro.kernels.cache_ops:
//
//   probe_and_commit_kernel  <- kernel.py::probe_and_commit (body _kernel)
//   serve_fused (fill_kernel + probe_and_commit_kernel<GATHER=true>)
//                            <- serve_kernel.py::serve_fused (body _serve_kernel)
//
// Both share conflict_round (kernel.py::conflict_round) as one __device__
// function, so the two kernels agree by construction.
//
// What bounds them on an H100: bytes.  A batch of B requests touches at
// most B cache sets; per request the kernels read ~22 bytes of request
// fields plus 16 bytes of segment plan, per touched set they read and write
// one packed (4W) uint32 row, and the serve kernel also gathers one V-word
// value row per request.  At B = 4096, W = 8, V = 8 that is ~2 MB, well
// under a microsecond at 3.35 TB/s; the integer work (~10 compares per way
// per request) is smaller still.  At that size the launch itself dominates.
//
// Design:
//  * One thread per segment (a run of requests to the same set, in arrival
//    order).  The thread keeps its set's pristine and evolving rows in
//    registers and walks its own requests sequentially.  The TPU kernel's
//    tile-wide max(seg_len) round count and inactive-lane scatter drops
//    disappear: a thread runs exactly its segment's length.
//  * Sets are owned by exactly one segment, so the thread gathers its row
//    from the state and scatters the resolved row back in place.  The
//    request fields are read in arrival order through the sort permutation
//    and every per-request output is written at its arrival position, so
//    neither a sorted copy of the batch nor an un-sort pass is needed.
//  * The TPU kernel recomputes the post-fill value table in every grid
//    step because its grid runs in order on one core.  Blocks here run in
//    no order, so the deferred fill is its own launch (fill_kernel) on the
//    same stream, before the probe/commit/gather launch reads any value
//    row.  Its slots are unique (the host glue dedupes them), so it writes
//    the value table in place with no ordering between threads.
//  * State words are uint32: keys, epochs and min_epoch compare unsigned;
//    stamps are int32 and compare signed (argmin of the LRU stamp).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPadHi = 0xFFFFFFFFu;
constexpr uint32_t kPadLo = 0xFFFFFFFFu;
constexpr int kThreads = 64;

template <int MAXW>
struct Row {
  uint32_t hi[MAXW];
  uint32_t lo[MAXW];
  int32_t st[MAXW];
  uint32_t ep[MAXW];
};

// One exact sequential LRU step on a set's evolving row (kernel.py:66).
// A hit refreshes the first matching way; an admitted miss evicts the
// first way with the smallest stamp.  A hit whose way's epoch is below
// minep is stale: it refreshes the stamp and takes the new epoch.  The pad
// key neither matches nor writes.
template <int MAXW>
__device__ __forceinline__ void conflict_round(Row<MAXW>& r, int w, uint32_t hi,
                                               uint32_t lo, bool admit, bool stat,
                                               uint32_t ep, uint32_t minep,
                                               int32_t stamp, int& way,
                                               bool& refresh) {
  const bool pad = hi == kPadHi && lo == kPadLo;
  int hit_way = -1;
  int min_way = 0;
  int32_t min_st = r.st[0];
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    if (k < w) {
      const bool m = !pad && r.hi[k] == hi && r.lo[k] == lo && r.hi[k] != 0u;
      if (m && hit_way < 0) hit_way = k;
      if (r.st[k] < min_st) {
        min_st = r.st[k];
        min_way = k;
      }
    }
  }
  const bool is_hit = hit_way >= 0;
  way = is_hit ? hit_way : min_way;
  uint32_t ep_way = 0u;
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    if (k == way) ep_way = r.ep[k];
  }
  const bool stale = is_hit && ep_way < minep;
  const bool do_write = !stat && !pad && (is_hit || admit);
  refresh = do_write && (!is_hit || stale);
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    if (k == way && do_write) {
      r.hi[k] = hi;
      r.lo[k] = lo;
      r.st[k] = stamp;
    }
    if (k == way && refresh) r.ep[k] = ep;
  }
}

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

template <int MAXW, bool GATHER>
__global__ void __launch_bounds__(kThreads)
probe_and_commit_kernel(Args a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.b) return;
  const int len = a.seg_len[s];
  if (len == 0) return;
  const int w = a.w;
  const int set = a.seg_set[s];
  // out-of-range sets clamp on the gather and drop on the scatter, as
  // jnp's gather/scatter(mode="drop") do in the reference
  const int row_i = set < a.n_sets ? set : a.n_sets - 1;
  const uint32_t* src = a.ks + static_cast<size_t>(row_i) * 4 * w;
  Row<MAXW> p;
#pragma unroll
  for (int k = 0; k < MAXW; ++k) {
    const bool in = k < w;
    p.hi[k] = in ? src[k] : 0u;
    p.lo[k] = in ? src[w + k] : 0u;
    p.st[k] = in ? static_cast<int32_t>(src[2 * w + k]) : 0;
    p.ep[k] = in ? src[3 * w + k] : 0u;
  }
  Row<MAXW> r = p;
  const uint32_t clk = static_cast<uint32_t>(*a.clock);
  const int lead = a.leader[s];
  for (int j = 0; j < len; ++j) {
    const int pos = a.order[lead + j];
    const uint32_t hi = a.h_hi[pos];
    const uint32_t lo = a.h_lo[pos];
    const uint32_t minep = a.minep[pos];
    const bool pad = hi == kPadHi && lo == kPadLo;
    // probe against the pristine row: duplicates inside the batch miss
    bool pm_any = false;
    int pm_way = 0;
    uint32_t pm_ep = 0u;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      if (k < w && !pad && p.hi[k] == hi && p.lo[k] == lo && p.hi[k] != 0u) {
        if (!pm_any) pm_way = k;
        pm_any = true;
        pm_ep = p.ep[k] > pm_ep ? p.ep[k] : pm_ep;
      }
    }
    // effective write epoch (ops.py:286-292): a pristine fresh hit keeps
    // its resident epoch, so a mid-batch evict + re-insert cannot launder
    // the entry's age
    const bool fresh = pm_any && pm_ep >= minep;
    const uint32_t ep = fresh ? pm_ep : a.epochs[pos];
    const int32_t stamp = static_cast<int32_t>(clk + 1u + static_cast<uint32_t>(pos));
    int way;
    bool refresh;
    conflict_round<MAXW>(r, w, hi, lo, a.admit[pos] != 0, a.stat[pos] != 0, ep,
                         minep, stamp, way, refresh);
    a.pre_hit[pos] = pm_any;
    a.pre_way[pos] = pm_way;
    a.pre_stale[pos] = pm_any && pm_ep < minep;
    a.pre_epoch[pos] = pm_ep;
    a.wrote[pos] = refresh;
    a.way[pos] = way;
    if (GATHER) {
      const int32_t* vrow =
          a.value + (static_cast<size_t>(row_i) * w + pm_way) * a.v;
      int32_t* out = a.vals + static_cast<size_t>(pos) * a.v;
      for (int c = 0; c < a.v; ++c) out[c] = vrow[c];
    }
  }
  if (set < a.n_sets) {
    uint32_t* dst = a.ks + static_cast<size_t>(set) * 4 * w;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
      if (k < w) {
        dst[k] = r.hi[k];
        dst[w + k] = r.lo[k];
        dst[2 * w + k] = static_cast<uint32_t>(r.st[k]);
        dst[3 * w + k] = r.ep[k];
      }
    }
  }
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

template <bool GATHER>
int launch_commit(const Args& a, cudaStream_t stream) {
  if (a.b == 0) return 0;
  const int blocks = (a.b + kThreads - 1) / kThreads;
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
  return launch_commit<true>(a, st);
}

}  // extern "C"
