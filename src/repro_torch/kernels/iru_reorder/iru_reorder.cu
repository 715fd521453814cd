// IRU reordering hash (kernel B3): the paper's hash of num_sets x slots
// entries keyed on hash(idx // epb), over an int32 index stream with an
// f32 or int32 [n] payload and a ragged live prefix n_live (read from device
// memory).  The merge op is none, add, min, max or tagged: the fused min+add
// family fold of the serving stack, where each arrival's family is
// tag_table[clamp(idx, 0, T-1)] (1 = add), as in the batched engine's
// _lane_tags.  The result equals ragged_oracle(hash_reorder_ref, ...) of
// repro_torch/kernels/iru_reorder/ref.py (tagged: its add result on add
// lanes and its min result on min lanes; the layout does not depend on the
// op), buffer order:
//   1. flushed groups, by their trigger's stream position, each `slots`
//      entries in insertion order with merged payloads;
//   2. drained sets in set-id order, each in insertion order;
//   3. dead lanes (n_live..n-1) in stream order, original values, inactive;
//   4. filtered lanes with their original payload, the first detected at
//      n-1 (reverse detection order), inactive.
//
// Replaces the TPU kernel repro/kernels/iru_reorder/iru_reorder.py
// (hash_reorder_pallas, _kernel, _hash_set): there one core streamed the
// elements through a VMEM table one at a time.  Here sets are independent,
// so the stream is binned set-major and each set is walked by its own warp:
//   bin     a stable counting sort by set: per-chunk histograms (one warp
//           per 8192-lane chunk, __match_any_sync ranks lanes of one set
//           within a 32-lane step) and an exclusive scan of the set-major
//           histogram; then one CTA per chunk ranks the chunk's lanes by set
//           in shared memory (each warp counts its stretch, a scan over warps
//           and sets gives each (warp, set) its local offset, a second
//           ranking places the lanes) and writes each set's run of the chunk
//           to its global offset, consecutive threads to consecutive
//           addresses, as packed 8-byte (index, payload) words and positions;
//   walk    one warp per set, lane j holding slot j.  Arrivals are taken 32
//           at a time (the next batch loads meanwhile).  A batch is cut into
//           sub-steps at triggers; in each, an arrival is filtered if its
//           index equals a resident's (every lane scans the warp's shared
//           copy of the resident indices, 16 bytes a load) or an earlier
//           arrival's of the sub-step (__match_any_sync), and the others
//           take slots in lane order, the one that fills the set being the
//           trigger.  Each slot's owner folds its filtered arrivals in lane
//           order from the warp's shared copy of the batch, so f32 sums add
//           in the oracle's (stream) order.  Tagged, each slot folds under
//           its resident's family, which the binning packs into bit 31 of
//           the arrival's position (positions are below 2^31).  A full set is written back into
//           its own (already consumed) stretch of the binned arrays and its
//           trigger's stream position is marked;
//   emit    no sorts: a flush group's rank is an exclusive scan of the
//           trigger marks over stream positions (triggers are distinct
//           positions), a filtered lane's tail slot a scan of the filtered
//           marks, drain offsets a scan of the per-set drain counts.
//
// What bounds it on an H100: the walk.  It is sequential within a set, so
// the busiest set's arrival count sets the time: one sub-step per batch of
// 32 arrivals plus one per flush (kron-20 PageRank: 86,047 arrivals and
// about a thousand flushes in the busiest of 1024 sets, against a mean of
// 30,666 arrivals), each a chain of shared-memory loads, ballots and folds
// in one warp.  The byte bound is 8 B read and 13 B written a lane.
// Spreading a hot set over several warps is later work.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the wrapper passes one workspace buffer).

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kBinWarps = 4;      // warps per CTA of the binning count
constexpr int kChunk = 8192;      // lanes of one histogram column (a count warp, a scatter CTA)
constexpr int kMaxSets = 8192;    // binning keeps num_sets counters a warp
constexpr int kScatterMaxWarps = 8;
constexpr long long kMaxSmem = 232448;  // shared memory a block can use (227 KB)
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kWalkWarps = 4;
constexpr int kEmitThreads = 256;

enum Op { kNone = 0, kAdd = 1, kMin = 2, kMax = 3, kTagged = 4 };
enum Mark : uint8_t { kKept = 0, kTrigger = 1, kFiltered = 2 };

__device__ __forceinline__ int live_count(const int* n_live, long long n) {
  if (n_live == nullptr) return (int)n;
  const int m = *n_live;
  return m < 0 ? 0 : (m > n ? (int)n : m);
}

// uint32 Knuth hash of the block key idx // epb (floor division)
__device__ __forceinline__ int hash_set(int idx, int epb, int num_sets) {
  int q = idx / epb;
  if (idx % epb != 0 && idx < 0) --q;
  unsigned h = (unsigned)q * 2654435761u;
  h ^= h >> 16;
  return (int)(h % (unsigned)num_sets);
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMin) return b < a ? b : a;
  if (OP == kMax) return b > a ? b : a;
  return a;
}

// a slot's fold of one filtered arrival; tagged, by the slot's family
template <typename T, int OP>
__device__ __forceinline__ T fold(T a, T b, bool add) {
  if (OP == kTagged) return add ? a + b : (b < a ? b : a);
  return combine<T, OP>(a, b);
}

constexpr int kPosMask = INT_MAX;  // a binned position; bit 31 = the add family

struct Geo {
  long long n;
  int num_sets;
  int slots;
  int epb;
  int nchunks;
  const uint8_t* tags;  // op = tagged: the family of each index (1 = add)
  int ntags;
};

// bit 31 of a binned position: set when idx's family is add
__device__ __forceinline__ int family_bit(int idx, const Geo& g) {
  if (g.tags == nullptr) return 0;
  const int i = idx < 0 ? 0 : (idx >= g.ntags ? g.ntags - 1 : idx);
  return g.tags[i] != 0 ? INT_MIN : 0;
}

// ---------------------------------------------------------------- binning
// One warp adds the lanes [p0, p1) of each set to cnt[set]; lanes of one set
// within a 32-lane step are ranked with __match_any_sync.
template <typename C>
__device__ void count_sets(const int* idx, long long p0, long long p1, const Geo& g, C* cnt) {
  const int lane = threadIdx.x % kWarp;
  for (long long base = p0; base < p1; base += kWarp) {
    const long long p = base + lane;
    const bool live = p < p1;
    const int s = live ? hash_set(idx[p], g.epb, g.num_sets) : g.num_sets;
    const unsigned peers = __match_any_sync(kFull, s);
    if (live && __popc(peers & ((1u << lane) - 1u)) == 0) cnt[s] += __popc(peers);
    __syncwarp();
  }
}

// Count: one warp per kChunk-lane chunk counts each set's live lanes into
// hist[s * nchunks + c].
__global__ void __launch_bounds__(kBinWarps * kWarp)
bin_count(const int* idx, const int* n_live, Geo g, int* hist) {
  extern __shared__ int counters[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kBinWarps + warp;
  if (chunk >= g.nchunks) return;  // whole warps only; no block barrier below
  int* cnt = counters + warp * g.num_sets;
  for (int s = lane; s < g.num_sets; s += kWarp) cnt[s] = 0;
  __syncwarp();
  const long long p0 = (long long)chunk * kChunk;
  count_sets(idx, p0, min(p0 + kChunk, (long long)live_count(n_live, g.n)), g, cnt);
  for (int s = lane; s < g.num_sets; s += kWarp) hist[(long long)s * g.nchunks + chunk] = cnt[s];
}

// set_start[s] = first set-major slot of set s; set_start[num_sets] = n_live
__global__ void set_starts(const int* hist, const int* n_live, Geo g, int* set_start) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < g.num_sets) set_start[s] = hist[(long long)s * g.nchunks];
  if (s == g.num_sets) set_start[s] = live_count(n_live, g.n);
}

// shared memory of bin_scatter with `warps` warps: the chunk's lanes laid
// out set-major (packed (index, payload) words and 16-bit chunk positions),
// each set's global-minus-local offset, and each warp's 16-bit counters
long long scatter_smem(int num_sets, int warps) {
  return (long long)kChunk * (8 + 2) + num_sets * 4LL + (long long)warps * num_sets * 2;
}

// Scatter: one CTA per chunk ranks the chunk's lanes by set in shared memory,
// stable by stream position, then writes each set's run of the chunk to the
// set's scanned offset hist[s * nchunks + c], so consecutive threads write
// consecutive addresses.  Warp w takes the w-th stretch of the chunk: it
// counts its lanes per set, a per-set scan over the warps and a block scan
// over the sets give each (warp, set) its local offset, and a second ranking
// places the lanes.
__global__ void __launch_bounds__(kScatterMaxWarps * kWarp)
bin_scatter(const int* idx, const uint32_t* val, const int* n_live, Geo g, const int* hist,
            uint2* b_iv, int* b_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kScatterMaxWarps];
  const int warps = blockDim.x / kWarp;
  uint2* buf_iv = reinterpret_cast<uint2*>(smem);
  int* delta = reinterpret_cast<int*>(buf_iv + kChunk);  // global slot - local slot, by set
  uint16_t* buf_pos = reinterpret_cast<uint16_t*>(delta + g.num_sets);
  uint16_t* wcnt = buf_pos + kChunk;  // [warps][num_sets]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x;
  const long long m = live_count(n_live, g.n);
  const long long p0 = (long long)chunk * kChunk;
  const int len = (int)max(0LL, min((long long)kChunk, m - p0));
  if (len == 0) return;  // the whole block
  const int per = kChunk / warps;
  const int w0 = warp * per, w1 = min(w0 + per, len);  // this warp's stretch
  uint16_t* cnt = wcnt + warp * g.num_sets;
  for (int s = lane; s < g.num_sets; s += kWarp) cnt[s] = 0;
  __syncwarp();
  count_sets(idx, p0 + w0, p0 + w1, g, cnt);
  __syncthreads();
  // local layout: set-major, warps in order within a set
  const int sper = (g.num_sets + blockDim.x - 1) / blockDim.x;
  const int s0 = min((int)threadIdx.x * sper, g.num_sets), s1 = min(s0 + sper, g.num_sets);
  int mine = 0;
  for (int s = s0; s < s1; ++s)
    for (int w = 0; w < warps; ++w) mine += wcnt[w * g.num_sets + s];
  int inc = mine;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == kWarp - 1) warp_sum[warp] = inc;
  __syncthreads();
  int run = inc - mine;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int s = s0; s < s1; ++s) {
    delta[s] = hist[(long long)s * g.nchunks + chunk] - run;
    for (int w = 0; w < warps; ++w) {
      const int c = wcnt[w * g.num_sets + s];
      wcnt[w * g.num_sets + s] = (uint16_t)run;
      run += c;
    }
  }
  __syncthreads();
  for (int q0 = w0; q0 < w1; q0 += kWarp) {
    const int q = q0 + lane;
    const bool live = q < w1;
    const int x = live ? idx[p0 + q] : 0;
    const int s = live ? hash_set(x, g.epb, g.num_sets) : g.num_sets;
    const unsigned peers = __match_any_sync(kFull, s);
    const int before = __popc(peers & ((1u << lane) - 1u));
    if (live) {
      const int at = cnt[s] + before;
      buf_iv[at] = make_uint2((uint32_t)x, val[p0 + q]);
      buf_pos[at] = (uint16_t)q;
    }
    __syncwarp();
    if (live && before == 0) cnt[s] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    const uint2 iv = buf_iv[q];
    const int at = q + delta[hash_set((int)iv.x, g.epb, g.num_sets)];
    b_iv[at] = iv;
    b_pos[at] = (int)(p0 + buf_pos[q]) | family_bit((int)iv.x, g);
  }
}

// ------------------------------------------------------------------ walk
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ int from_bits<int>(uint32_t b) { return (int)b; }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t to_bits(int v) { return (uint32_t)v; }

// lanes up to and including `last`
__device__ __forceinline__ unsigned upto(int last) { return last >= 31 ? kFull : (2u << last) - 1u; }

// One warp per set, lane j holding slot j; the set's arrivals are taken 32
// at a time (the next batch loads while this one is folded).  A batch is cut
// into sub-steps at triggers.  In a sub-step that starts at lane a with cnt
// residents, an arrival is filtered if its index equals a resident's (each
// lane scans the warp's shared copy of the resident indices) or an earlier
// arrival's of the sub-step (__match_any_sync); the others are new, take
// slots cnt, cnt+1, ... in lane order (each writes itself into its slot's
// shared entry, which the slot's lane reads), and the new arrival that takes
// slot `slots`-1 is the trigger, which ends the sub-step: the set flushes into
// its own consumed stretch of the binned arrays and the next sub-step
// starts after it with an empty set.  Each slot's owner folds the
// sub-step's filtered arrivals that name its slot, in lane order (stream
// order), from the warp's shared copy of the batch, so f32 sums add in the
// oracle's order.
template <typename T, int OP>
__global__ void __launch_bounds__(kWalkWarps * kWarp)
walk(const int* set_start, Geo g, uint2* b_iv, int* b_pos, uint8_t* mark, int* nflush,
     int* ndrain) {
  // the warp's shared copies: the batch's payload bits and positions, each
  // slot's index, the lane a new slot takes its arrival from, and the slot
  // each filtered arrival folds into
  __shared__ __align__(16) uint32_t payload[kWalkWarps][kWarp];
  __shared__ int position[kWalkWarps][kWarp];
  __shared__ __align__(16) int resident[kWalkWarps][kWarp];
  __shared__ int taken_from[kWalkWarps][kWarp];
  __shared__ __align__(16) int folds_into[kWalkWarps][kWarp];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int s = blockIdx.x * kWalkWarps + wid;
  if (s >= g.num_sets) return;
  int* res = resident[wid];
  const int4* res4 = reinterpret_cast<const int4*>(res);
  const uint4* pay4 = reinterpret_cast<const uint4*>(payload[wid]);
  const int4* into4 = reinterpret_cast<const int4*>(folds_into[wid]);
  const unsigned below = (1u << lane) - 1u;
  const int start = set_start[s];
  const int len = set_start[s + 1] - start;
  int r_idx = 0, r_pos = 0;  // slot `lane` of this set
  T r_val = T(0);
  bool r_add = false;        // tagged: the slot's family
  int cnt = 0, wc = 0, flushes = 0;  // warp-uniform
  uint2 nx_iv = make_uint2(0, 0);
  int nx_pos = 0;
  if (lane < len) {
    nx_iv = b_iv[start + lane];
    nx_pos = b_pos[start + lane];
  }
  for (int k0 = 0; k0 < len; k0 += kWarp) {
    const int steps = min(kWarp, len - k0);
    const unsigned valid = upto(steps - 1);
    const bool have = lane < steps;
    const int ei = (int)nx_iv.x;
    const int ep = nx_pos & kPosMask;
    payload[wid][lane] = nx_iv.y;
    position[wid][lane] = nx_pos;
    // the next batch lies past every write-back of this one (a flush group
    // is `slots` arrivals already consumed)
    if (k0 + kWarp + lane < len) {
      nx_iv = b_iv[start + k0 + kWarp + lane];
      nx_pos = b_pos[start + k0 + kWarp + lane];
    }
    const unsigned peers = OP != kNone ? __match_any_sync(kFull, ei) & valid : 0u;
    unsigned filtered = 0, triggers = 0;
    int a = 0;
    while (a < steps) {
      const unsigned sub = valid & ~((1u << a) - 1u);
      unsigned newm = sub;
      int own = -1;  // the slot this lane's arrival folds into
      if (OP != kNone) {
        // residents hold distinct indices, so at most one matches
        // (all eight loads first: no branch between them)
#pragma unroll
        for (int q = 0; q < kWarp / 4; ++q) {
          const int4 r = res4[q];
          if (4 * q < cnt && r.x == ei) own = 4 * q;
          if (4 * q + 1 < cnt && r.y == ei) own = 4 * q + 1;
          if (4 * q + 2 < cnt && r.z == ei) own = 4 * q + 2;
          if (4 * q + 3 < cnt && r.w == ei) own = 4 * q + 3;
        }
        const unsigned hit = __ballot_sync(kFull, own >= 0) & sub;
        newm = __ballot_sync(kFull, (peers & sub & below) == 0) & sub & ~hit;
      }
      // new arrivals take slots cnt, cnt+1, ... in lane order; the one that
      // takes slot `slots`-1 is the trigger
      const bool is_new = newm >> lane & 1u;
      const int rank = __popc(newm & below);
      const unsigned tmask = __ballot_sync(kFull, is_new && rank == g.slots - cnt - 1);
      const bool trig = tmask != 0;
      const int last = trig ? __ffs(tmask) - 1 : steps - 1;
      const unsigned range = sub & upto(last);
      const unsigned ins = newm & range;
      const int nins = __popc(ins);
      if (ins >> lane & 1u) {
        res[cnt + rank] = ei;
        taken_from[wid][cnt + rank] = lane;
      }
      unsigned fm = 0;  // the sub-step's filtered arrivals
      if (OP != kNone) {
        fm = range & ~ins;
        filtered |= fm;
        if (own < 0 && (fm >> lane & 1u))  // a duplicate of a new arrival
          own = cnt + __popc(ins & ((1u << (__ffs(peers & sub) - 1)) - 1u));
        folds_into[wid][lane] = (fm >> lane & 1u) ? own : -1;
      }
      __syncwarp();
      if (lane >= cnt && lane < cnt + nins) {  // a new slot
        const int t = taken_from[wid][lane];
        r_idx = res[lane];
        r_val = from_bits<T>(payload[wid][t]);
        r_pos = position[wid][t] & kPosMask;
        r_add = position[wid][t] < 0;
      }
      if (OP != kNone && fm) {
        // each slot's owner folds the arrivals that name it, in lane order
#pragma unroll
        for (int q = 0; q < kWarp / 4; ++q) {
          const int4 o = into4[q];
          const uint4 b = pay4[q];
          if (o.x == lane) r_val = fold<T, OP>(r_val, from_bits<T>(b.x), r_add);
          if (o.y == lane) r_val = fold<T, OP>(r_val, from_bits<T>(b.y), r_add);
          if (o.z == lane) r_val = fold<T, OP>(r_val, from_bits<T>(b.z), r_add);
          if (o.w == lane) r_val = fold<T, OP>(r_val, from_bits<T>(b.w), r_add);
        }
      }
      __syncwarp();  // the shared copies are read before they change
      cnt += nins;
      if (trig) {
        if (lane < g.slots) {
          b_iv[start + wc + lane] = make_uint2((uint32_t)r_idx, to_bits(r_val));
          b_pos[start + wc + lane] = r_pos;
        }
        triggers |= 1u << last;
        wc += g.slots;
        cnt = 0;
        ++flushes;
      }
      a = last + 1;
    }
    if (have && ((filtered | triggers) >> lane & 1u))
      mark[ep] = (filtered >> lane & 1u) ? kFiltered : kTrigger;
  }
  if (lane < cnt) {  // drain group: the residents at end of stream
    b_iv[start + wc + lane] = make_uint2((uint32_t)r_idx, to_bits(r_val));
    b_pos[start + wc + lane] = r_pos;
  }
  if (lane == 0) {
    nflush[s] = flushes;
    ndrain[s] = cnt;
  }
}

// ------------------------------------------------------------------ scans
__device__ __forceinline__ int2 add2(int2 a, int2 b) { return make_int2(a.x + b.x, a.y + b.y); }

// exclusive block scan of int2 sums over kScanThreads threads
__device__ int2 block_scan(int2 v, int2& total) {
  __shared__ int2 warp_sum[kScanThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int2 inc = v;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, off), y = __shfl_up_sync(kFull, inc.y, off);
    if (lane >= off) inc = add2(inc, make_int2(x, y));
  }
  if (lane == kWarp - 1) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < kScanThreads / kWarp ? warp_sum[lane] : make_int2(0, 0);
    for (int off = 1; off < kWarp; off <<= 1) {
      const int x = __shfl_up_sync(kFull, w.x, off), y = __shfl_up_sync(kFull, w.y, off);
      if (lane >= off) w = add2(w, make_int2(x, y));
    }
    if (lane < kScanThreads / kWarp) warp_sum[lane] = w;
  }
  __syncthreads();
  const int2 before = warp > 0 ? warp_sum[warp - 1] : make_int2(0, 0);
  total = warp_sum[kScanThreads / kWarp - 1];
  __syncthreads();
  return make_int2(inc.x - v.x + before.x, inc.y - v.y + before.y);
}

// in-place exclusive scan of the set-major histogram
struct HistScan {
  int* data;
  long long n;
  __device__ int2 load(long long j) const { return make_int2(data[j], 0); }
  __device__ void store(long long j, int2 before, int2) const { data[j] = before.x; }
};

// scan of the walk's marks over stream positions: x counts triggers, y
// filtered lanes.  store() records each trigger's flush rank and places the
// filtered and dead lanes (their final slots need only these counts).
template <typename T>
struct MarkScan {
  const uint8_t* mark;
  long long n;
  const int* idx;
  const T* val;
  const int* n_live;
  const int* meta;  // [1] = survivors
  int* rank;
  int* out_idx;
  T* out_val;
  int* out_pos;
  uint8_t* out_act;
  __device__ int2 load(long long j) const {
    const uint8_t k = mark[j];
    return make_int2(k == kTrigger, k == kFiltered);
  }
  __device__ void store(long long j, int2 before, int2 x) const {
    const long long m = live_count(n_live, n);
    long long o;
    if (j >= m) {
      o = meta[1] + (j - m);  // dead lane
    } else if (x.y) {
      o = n - 1 - before.y;   // filtered lane
    } else {
      if (x.x) rank[j] = before.x;
      return;
    }
    out_idx[o] = idx[j];
    out_val[o] = val[j];
    out_pos[o] = (int)j;
    out_act[o] = 0;
  }
};

template <class F>
__device__ __forceinline__ int2 thread_sum(const F& f, long long j0) {
  int2 v = make_int2(0, 0);
  for (int k = 0; k < kScanItems; ++k)
    if (j0 + k < f.n) v = add2(v, f.load(j0 + k));
  return v;
}

template <class F>
__global__ void __launch_bounds__(kScanThreads) scan_reduce(F f, int2* agg) {
  const long long j0 = (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  int2 total;
  block_scan(thread_sum(f, j0), total);
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// one CTA: agg[t] becomes the exclusive prefix of tile t
__global__ void __launch_bounds__(kScanThreads) scan_tiles(int2* agg, long long tiles) {
  const long long per = (tiles + kScanThreads - 1) / kScanThreads;
  const long long t0 = (long long)threadIdx.x * per;
  const long long t1 = min(t0 + per, tiles);
  int2 v = make_int2(0, 0);
  for (long long t = t0; t < t1; ++t) v = add2(v, agg[t]);
  int2 total;
  int2 run = block_scan(v, total);
  for (long long t = t0; t < t1; ++t) {
    const int2 x = agg[t];
    agg[t] = run;
    run = add2(run, x);
  }
}

template <class F>
__global__ void __launch_bounds__(kScanThreads) scan_apply(F f, const int2* agg) {
  const long long j0 = (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  int2 total;
  int2 run = add2(agg[blockIdx.x], block_scan(thread_sum(f, j0), total));
  for (int k = 0; k < kScanItems; ++k) {
    const long long j = j0 + k;
    if (j >= f.n) break;
    const int2 x = f.load(j);
    f.store(j, run, x);
    run = add2(run, x);
  }
}

template <class F>
int scan(const F& f, int2* agg, cudaStream_t st) {
  const long long tiles = (f.n + kScanTile - 1) / kScanTile;
  if (tiles == 0) return 0;
  scan_reduce<F><<<(unsigned)tiles, kScanThreads, 0, st>>>(f, agg);
  scan_tiles<<<1, kScanThreads, 0, st>>>(agg, tiles);
  scan_apply<F><<<(unsigned)tiles, kScanThreads, 0, st>>>(f, agg);
  return (int)cudaGetLastError();
}

// one CTA: drain offsets by set id, and meta = {flush groups, survivors}
__global__ void __launch_bounds__(kScanThreads)
finalize(const int* nflush, const int* ndrain, Geo g, int* drain_off, int* meta) {
  const int per = (g.num_sets + kScanThreads - 1) / kScanThreads;
  const int s0 = threadIdx.x * per, s1 = min(s0 + per, g.num_sets);
  int2 v = make_int2(0, 0);
  for (int s = s0; s < s1; ++s) v = add2(v, make_int2(ndrain[s], nflush[s]));
  int2 total;
  int2 run = block_scan(v, total);
  for (int s = s0; s < s1; ++s) {
    drain_off[s] = run.x;
    run.x += ndrain[s];
  }
  if (threadIdx.x == 0) {
    meta[0] = total.y;
    meta[1] = total.y * g.slots + total.x;
  }
}

// ------------------------------------------------------------------ emit
// one thread per set-major slot q < n_live: kept entries go to the front
template <typename T>
__global__ void __launch_bounds__(kEmitThreads)
emit_kept(const int* set_start, const int* nflush, const int* ndrain, const int* drain_off,
          const int* meta, const int* rank, const uint2* b_iv, const int* b_pos, Geo g,
          int* out_idx, T* out_val, int* out_pos, uint8_t* out_act) {
  const long long q = (long long)blockIdx.x * kEmitThreads + threadIdx.x;
  if (q >= set_start[g.num_sets]) return;
  int lo = 0, hi = g.num_sets;  // last s with set_start[s] <= q
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (set_start[mid] <= q) lo = mid; else hi = mid;
  }
  const int s = lo, start = set_start[s];
  const int local = (int)(q - start);
  const int nf = nflush[s] * g.slots;
  if (local >= nf + ndrain[s]) return;  // consumed arrivals past the kept entries
  long long o;
  if (local < nf) {
    const int grp = local / g.slots, j = local % g.slots;
    const int trig = b_pos[start + grp * g.slots + g.slots - 1];
    o = (long long)rank[trig] * g.slots + j;
  } else {
    o = (long long)meta[0] * g.slots + drain_off[s] + (local - nf);
  }
  const uint2 iv = b_iv[q];
  out_idx[o] = (int)iv.x;
  out_val[o] = from_bits<T>(iv.y);
  out_pos[o] = b_pos[q];
  out_act[o] = 1;
}

// ------------------------------------------------------------- workspace
struct Work {
  int* hist;
  int2* agg;
  int* set_start;
  int* nflush;
  int* ndrain;
  int* drain_off;
  int* meta;
  uint2* b_iv;  // binned (index, payload bits), set-major
  int* b_pos;
  uint8_t* mark;
  int* rank;
};

long long align(long long b) { return (b + 255) / 256 * 256; }

long long carve(char* base, long long n, int num_sets, Work* w) {
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long h = nchunks * num_sets;
  const long long tiles = (std::max(h, n) + kScanTile - 1) / kScanTile;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += align(bytes);
    return p;
  };
  Work v;
  v.hist = (int*)take(h * 4);
  v.agg = (int2*)take(std::max(tiles, 1LL) * 8);
  v.set_start = (int*)take((num_sets + 1) * 4LL);
  v.nflush = (int*)take(num_sets * 4LL);
  v.ndrain = (int*)take(num_sets * 4LL);
  v.drain_off = (int*)take(num_sets * 4LL);
  v.meta = (int*)take(16);
  v.b_iv = (uint2*)take(n * 8);
  v.b_pos = (int*)take(n * 4);
  v.mark = (uint8_t*)take(n);
  v.rank = (int*)take(n * 4);
  if (w) *w = v;
  return off;
}

template <typename T, int OP>
int walk_one(const Work& w, Geo g, cudaStream_t st) {
  const unsigned blocks = (g.num_sets + kWalkWarps - 1) / kWalkWarps;
  walk<T, OP><<<blocks, kWalkWarps * kWarp, 0, st>>>(w.set_start, g, w.b_iv, w.b_pos, w.mark,
                                                     w.nflush, w.ndrain);
  return (int)cudaGetLastError();
}

template <typename T>
int walk_launch(int op, const Work& w, Geo g, cudaStream_t st) {
  switch (op) {
    case kNone: return walk_one<T, kNone>(w, g, st);
    case kAdd: return walk_one<T, kAdd>(w, g, st);
    case kMin: return walk_one<T, kMin>(w, g, st);
    case kMax: return walk_one<T, kMax>(w, g, st);
    case kTagged: return walk_one<T, kTagged>(w, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const int* idx, const T* val, const int* n_live, int* out_idx, T* out_val, int* out_pos,
        uint8_t* out_act, const Work& w, Geo g, int op, cudaStream_t st) {
  const int count_smem = kBinWarps * g.num_sets * 4;  // above 48 KB past 3072 sets
  int warps = kScatterMaxWarps;
  while (warps > 1 && scatter_smem(g.num_sets, warps) > kMaxSmem) warps /= 2;
  const int smem = (int)scatter_smem(g.num_sets, warps);
  int e;
  if ((e = (int)cudaFuncSetAttribute(bin_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     count_smem)) ||
      (e = (int)cudaFuncSetAttribute(bin_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem)))
    return e;
  const uint32_t* vbits = reinterpret_cast<const uint32_t*>(val);
  if ((e = (int)cudaMemsetAsync(w.mark, 0, g.n, st))) return e;
  bin_count<<<(g.nchunks + kBinWarps - 1) / kBinWarps, kBinWarps * kWarp, count_smem, st>>>(
      idx, n_live, g, w.hist);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = scan(HistScan{w.hist, (long long)g.nchunks * g.num_sets}, w.agg, st))) return e;
  set_starts<<<(g.num_sets + 256) / 256, 256, 0, st>>>(w.hist, n_live, g, w.set_start);
  bin_scatter<<<g.nchunks, warps * kWarp, smem, st>>>(idx, vbits, n_live, g, w.hist, w.b_iv,
                                                      w.b_pos);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = walk_launch<T>(op, w, g, st))) return e;
  finalize<<<1, kScanThreads, 0, st>>>(w.nflush, w.ndrain, g, w.drain_off, w.meta);
  MarkScan<T> ms{w.mark, g.n, idx, val, n_live, w.meta, w.rank, out_idx, out_val, out_pos, out_act};
  if ((e = scan(ms, w.agg, st))) return e;
  const unsigned emit_blocks = (unsigned)((g.n + kEmitThreads - 1) / kEmitThreads);
  emit_kept<T><<<emit_blocks, kEmitThreads, 0, st>>>(w.set_start, w.nflush, w.ndrain,
                                                     w.drain_off, w.meta, w.rank, w.b_iv,
                                                     w.b_pos, g, out_idx, out_val, out_pos,
                                                     out_act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int iru_hash_reorder_max_sets(void) { return kMaxSets; }

// bytes of the workspace iru_hash_reorder needs for n lanes and num_sets sets
long long iru_hash_reorder_workspace(long long n, int num_sets) {
  return carve(nullptr, n, num_sets, nullptr);
}

// dtype: 0 = float32, 1 = int32; op: 0 = none, 1 = add, 2 = min, 3 = max,
// 4 = tagged (tag_table: ntags bytes on the device, nonzero = the add family;
// null for other ops).
// n_live: device pointer to one int32, or null for a padded stream.
// Returns a cudaError_t code (0 on success).
int iru_hash_reorder(const int* idx, const void* val, const int* n_live, const uint8_t* tag_table,
                     int ntags, int* out_idx, void* out_val, int* out_pos, uint8_t* out_act,
                     void* workspace, long long n, int num_sets, int slots, int epb, int dtype,
                     int op, void* stream) {
  if (n <= 0) return 0;
  if (n >= INT_MAX || num_sets < 1 || num_sets > kMaxSets || slots < 1 || slots > kWarp ||
      epb < 1 || op < kNone || op > kTagged ||
      (op == kTagged) != (tag_table != nullptr && ntags > 0))
    return (int)cudaErrorInvalidValue;
  Work w;
  carve((char*)workspace, n, num_sets, &w);
  Geo g{n, num_sets, slots, epb, (int)((n + kChunk - 1) / kChunk),
        op == kTagged ? tag_table : nullptr, ntags};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(idx, (const float*)val, n_live, out_idx, (float*)out_val, out_pos,
                      out_act, w, g, op, st);
  if (dtype == 1)
    return run<int>(idx, (const int*)val, n_live, out_idx, (int*)out_val, out_pos, out_act, w,
                    g, op, st);
  return (int)cudaErrorInvalidValue;
}

const char* iru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
