// IRU reordering hash (kernel B3): the paper's hash of num_sets x slots
// entries keyed on hash(idx // epb), over an int32 index stream with an
// f32 or int32 [n] payload and a ragged live prefix n_live (read from device
// memory).  The merge op is none, add, min, max or tagged: the fused min+add
// family fold of the serving stack, where each arrival's family is
// tag_table[clamp(idx, 0, T-1)] (1 = add), as in the batched engine's
// _lane_tags.  Sets stripe over n_partitions partitions as set % P.  The
// result equals ragged_oracle(hash_reorder_ref_banked, ...) of
// repro_torch/kernels/iru_reorder/ref.py (tagged: its add result on add
// lanes and its min result on min lanes; the layout does not depend on the
// op), buffer order:
//   1. each partition's front, partition by partition: its flushed groups,
//      by their trigger's stream position, each `slots` entries in insertion
//      order with merged payloads, then its drained sets in set-id order,
//      each in insertion order;
//   2. dead lanes (n_live..n-1) in stream order, original values, inactive;
//   3. each partition's filtered lanes, partition by partition, with their
//      original payload, the first detected last (reverse detection order),
//      inactive.
// A stream whose busiest partition holds more live lanes than
// partition_capacity(n_live, P) bypasses the banks: it is laid out as one
// partition (P = 1 is the flat layout).  With a round cap and a merge, a
// partition (after the bypass: the whole stream) one of whose sets holds
// more than round_cap * slots live lanes takes the round-cap fallback
// (ref.dense_merge_ref): its front holds one survivor an index, by (index,
// arrival), with its run's payloads folded in stream order, and every
// other lane of it is filtered, in its tail in reverse stream order.  The
// whole-stream body decides both on the device from the set histogram the
// binning builds.
//
// Replaces the TPU kernel repro/kernels/iru_reorder/iru_reorder.py
// (hash_reorder_pallas, _kernel, _hash_set): there one core streamed the
// elements through a VMEM table one at a time.  Here sets are independent,
// so the stream is binned set-major and each set is walked by its own warp.
// Every stage but the dead lanes' copy works on the live prefix [0, n_live)
// only: the grids are sized from n on the host, and persistent CTAs stride
// over the live chunks, tiles and slots that n_live (read on the device)
// leaves, so a dead tile costs nothing.
//   bin     a stable counting sort by set: per-chunk histograms (one warp
//           per live 8192-lane chunk, __match_any_sync ranks lanes of one
//           set within a 32-lane step) laid out set-major with the live
//           chunk count as the stride, so the live columns are contiguous,
//           and a single-pass scan of them; then one CTA per live chunk
//           ranks the chunk's lanes by set in shared memory (each warp
//           counts its stretch, a scan over warps and sets gives each
//           (warp, set) its local offset, a second ranking places the
//           lanes) and writes each set's run of the chunk to its global
//           offset, consecutive threads to consecutive addresses, as
//           packed 8-byte (index, payload) words and positions;
//   walk    one warp per set, lane j holding slot j.  Arrivals are taken 32
//           at a time (the next batch loads meanwhile).  A batch is cut into
//           sub-steps at triggers; in each, an arrival is filtered if its
//           index equals a resident's (every lane scans the warp's shared
//           copy of the resident indices, 16 bytes a load) or an earlier
//           arrival's of the sub-step (__match_any_sync), and the others
//           take slots in lane order, the one that fills the set being the
//           trigger.  Every arrival's mark (kept, trigger or filtered, and
//           its set's partition) goes to its stream position: no memset.
//           Untagged (walk_set), each slot's owner folds its filtered
//           arrivals in lane order from the warp's shared copy of the batch,
//           so f32 sums add in the oracle's (stream) order, and a full set
//           is written back into its own (already consumed) stretch of the
//           binned arrays.  Tagged, the walk is split in two: the chain
//           (one warp a set) reads indices and positions only, 8 bytes an
//           arrival, and writes each arrival's slot (and whether it was
//           kept) and each flush group's end; the fold (fold_emit) then
//           takes the groups, independent of each other (about 590,000 at
//           kron-20's PageRank stream against 1024 chains), one warp a span
//           of 32 of a set's groups: each slot's filtered arrivals fold in
//           stream order under its resident's family (the tag table's
//           entry for its index), and the group goes to its place in the
//           front;
//   emit    no sorts: a flush group's rank within its partition and a
//           filtered lane's tail slot come from one single-pass scan of the
//           marks over stream positions (decoupled look-back, 4096 lanes a
//           tile, a thread's 16 marks one 16-byte load) that counts up to
//           eight partitions' triggers and filtered lanes at once, from the
//           partition in each mark byte (more partitions take more passes
//           of the same kernel, eight a pass); drain offsets are a scan of
//           the per-set drain counts in partition-major set order; the dead
//           lanes go to [survivors, survivors + n - n_live) in one
//           contiguous copy, 16-byte stores (and loads where the input's
//           alignment allows); kept entries are placed one thread a live
//           binned slot (untagged) or by the fold (tagged).
//   round cap (a capped partition's lanes; the walk and the scatter leave
//           its sets, and the scatter and emission stop at once when every
//           partition is capped) a stable LSD sort by index, 8-bit digits
//           of the sign-flipped index, each pass a counting sort of the
//           binning's kind (count, single-pass scan, scatter by chunk) over
//           256 buckets; pass 0 takes the capped lanes from the stream and
//           gathers their keys' OR and AND, and a later pass whose digit
//           every key shares is skipped on the device (kron-20's ids need
//           three).  Then one single-pass dense scan over the sorted lanes
//           (4096 a tile, decoupled look-back over up to eight partitions'
//           counts) ranks each run's first lane in its partition's front
//           and writes every lane's mark (kept or filtered, and its
//           partition) to its stream position, so the mark scan gives the
//           filtered lanes their tail slots as it does the walk's; last, a
//           run's first lane folds the run (one thread, in sorted order,
//           which is stream order) and writes the survivor.
//
// What bounds it on an H100: the walk.  It is sequential within a set, so
// the busiest set's arrival count sets the time: one sub-step per batch of
// 32 arrivals plus one per flush (kron-20 PageRank: 86,047 arrivals and
// about a thousand flushes in the busiest of 1024 sets, against a mean of
// 30,666 arrivals), each a chain of shared-memory loads and ballots in one
// warp; the tagged chain leaves the folds to a parallel pass.  On a padded
// stream (a serving tick: 2.5e8 lanes, 3.1e7 live) the dead lanes' copy is
// the floor.  The byte bound is 8 B read and 13 B written a lane.
// Spreading a hot set over several warps is later work.  Under a round cap
// that every partition passes (kron-20's PageRank stream at 64 rounds) the
// walk is gone and the sort's passes bound it, each a read and a write of
// 12 B a lane (plus a read of the indices to count), then the longest
// run's fold, one thread's chain of adds.
//
// The windowed body (win_reorder) reorders independent windows of w lanes
// (the streaming lookahead of the paper's geometry: 8192 lanes, 1024 x 32
// sets over 4 partitions, round cap 64) in one launch, one CTA of 512
// threads a window, all in shared memory, positions offset by the window's
// start (a fully dead window is a copy):
//   bin     each lane's set, counted as it loads in its stretch of the
//           window (16 stretches at the paper's geometry, their 16-bit
//           counters where the payloads go later); the per-set totals
//           decide the bank bypass and each partition's round-cap
//           fallback, and a scan over the set keys (partition-major) gives
//           each set's first slot and each stretch's first slot in it; a
//           warp a stretch then places its lanes (ranked within a 32-lane
//           step by __match_any_sync): a stable counting sort into 16-bit
//           lane ids.  Only a capped partition's lanes are then sorted, by
//           (index, lane), for the fallback (ref.dense_merge_ref), which
//           folds runs of equal indices in stream order;
//   walk    the hot sets (past `slots` arrivals) by the whole-stream walk, a
//           warp each, first; the small ones a chunk of 32 set keys a warp,
//           several sets a 32-lane step: such a set fills at most once, at
//           its last arrival, so __match_any_sync on the index marks every
//           first arrival kept and the rest filtered in one step, and each
//           kept lane folds its duplicates in lane (stream) order.  A lane's
//           16-bit aux word holds its set key and its mark.  Tagged, every
//           fold (small set, hot set, fallback) takes its survivor's
//           family from the tag table in device memory when it folds: no
//           shared memory goes to it;
//   emit    one mark scan over the lanes in stream order for up to four
//           partitions (packed 16-bit trigger and filtered counts, a
//           thread's eight lanes one 16-byte load) gives each trigger its
//           flush rank and each filtered lane its tail slot; then a thread
//           a binned slot places the kept entries (consecutive slots of a
//           flush group or of a partition's drains go to consecutive
//           addresses); the filtered lanes, staged by tail slot over the
//           spent binned order, go out with the dead lanes in one
//           contiguous pass.
// What bounds it on an H100: shared-memory work, warp collectives and block
// barriers, not device memory (8 B read and 13 B written a lane).  The
// design keeps each step to one pass over the window (no comparison sort;
// one mark scan for four partitions) and a window to 113968 bytes at 8192
// lanes, 1024 sets and 4 partitions, so two windows reside on an SM and
// one's barriers and loads overlap the other's work.  The longest chains
// left are the small-set walk's __match_any_sync steps and the scatter's.
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
constexpr int kWalkWarps = 4;
constexpr int kFoldWarps = 8;
constexpr int kEmitThreads = 256;
// the single-pass scans: a tile of 4096 entries, 16 a thread
constexpr int kTileThreads = 256;
constexpr int kTileItems = 16;
constexpr int kTile = kTileThreads * kTileItems;
constexpr int kTileWarps = kTileThreads / kWarp;
constexpr int kMarkWords = 8;         // partitions one mark-scan pass counts
constexpr int kMaxMarkParts = 64;     // a mark byte: kind (2 bits), partition (6 bits)
constexpr int kTickHist = 0;          // ticket counters: the histogram scan's,
constexpr int kTickScatter = 1;       // the scatter's,
constexpr int kTickMark = 2;          // then one a mark-scan pass (then, with a
                                      // round cap, two a sort pass and one a
                                      // dense-scan pass)
constexpr unsigned long long kValid = 1ull << 63;  // a published status word
// the round-cap fallback's sort: LSD passes of 10-bit digits over the index
// with its sign bit flipped (so unsigned order is the index's order)
constexpr int kSortBits = 10;
constexpr int kSortBuckets = 1 << kSortBits;
constexpr int kSortPasses = (32 + kSortBits - 1) / kSortBits;
constexpr unsigned kSignFlip = 0x80000000u;
// meta words: flush groups, survivors, partitions of the layout, capped
// partitions, capped live lanes, the OR and the AND of their sort keys
enum Meta { kMetaFlush = 0, kMetaSurvivors, kMetaParts, kMetaCapped, kMetaDense, kMetaOr,
            kMetaAnd, kMetaWords };

enum Op { kNone = 0, kAdd = 1, kMin = 2, kMax = 3, kTagged = 4 };
enum Mark : uint8_t { kKept = 0, kTrigger = 1, kFiltered = 2 };
constexpr int kKeptCode = 32;  // the chain's code of an arrival: its slot, | 32 when kept

__device__ __forceinline__ int live_count(const int* n_live, long long n) {
  if (n_live == nullptr) return (int)n;
  const int m = *n_live;
  return m < 0 ? 0 : (m > n ? (int)n : m);
}

// histogram columns (kChunk-lane chunks) of the live prefix
__device__ __forceinline__ int live_chunks(long long m) { return (int)((m + kChunk - 1) / kChunk); }

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

// the tagged fold of one filtered arrival, by the slot's family (add or min)
template <typename T>
__device__ __forceinline__ T tagged_fold(T a, T b, bool add) {
  return add ? a + b : (b < a ? b : a);
}


struct Geo {
  long long n;
  int num_sets;
  int slots;
  int epb;
  int nchunks;          // histogram columns of n lanes
  int nparts;           // partitions: sets stripe as set % nparts
  const uint8_t* tags;  // op = tagged: the family of each index (1 = add)
  int ntags;
  int round_cap;        // 0: none (always none without a merge)
};

// the family of index x under the tag table (1 = add)
__device__ __forceinline__ bool add_family(const uint8_t* tags, int ntags, int x) {
  return tags[x < 0 ? 0 : min(x, ntags - 1)] != 0;
}

// one filtered arrival folded into its survivor: the op, or the index's
// family when tagged
template <typename T, int OP>
__device__ __forceinline__ T fold_one(T a, T b, bool add) {
  return OP == kTagged ? tagged_fold(a, b, add) : combine<T, OP>(a, b);
}

// the partition field of a set's mark bytes (unused past kMaxMarkParts
// partitions, where the mark scan hashes the lane's index again)
__device__ __forceinline__ uint8_t mark_part(int s, const Geo& g) {
  return (uint8_t)(g.nparts <= kMaxMarkParts ? (s % g.nparts) << 2 : 0);
}

// per-partition layout, written by finalize: the front's first slot, its
// flush groups, the tail's first slot and its length
struct Part {
  int front;
  int flushes;
  int tail;
  int filtered;
};

// ------------------------------------------------------------- workspace
struct Work {
  int* hist;                 // [nchunks * num_sets] set-major, live chunk count as the stride
  unsigned long long* hstat; // the histogram scan's status words, two a tile
  unsigned long long* mstat; // the mark scan's, 2 * kMarkWords a tile, two buffers
  long long mstride;         // words of one mark-scan buffer
  int* tick;                 // ticket counters
  int nticks;
  int* set_start;
  int* nflush;
  int* ndrain;
  int* drain_off;
  int* gkey;                 // [num_sets + 1] the tagged fold's spans before each set key
  int* meta;                 // [kMetaWords], see Meta
  Part* part;
  int* pd;
  int* pf;
  uint2* b_iv;               // binned (index, payload bits), set-major
  int* b_pos;                // binned positions
  uint8_t* mark;             // by stream position: kind | partition << 2
  int* rank;                 // by stream position: a trigger's flush rank in its partition
  uint8_t* code;             // tagged chain, by binned slot: the arrival's slot | kKeptCode
  int* gend;                 // tagged chain: each flush group's end, set s from set_start[s] / slots
  // the round-cap fallback (all null without a cap)
  int* capped;               // [nparts] 1: the layout's partition takes the fallback
  int* dheads;               // [nparts] a capped partition's survivors
  uint2* s_iv[2];            // the sort's (index, payload bits) words, two buffers
  int* s_pos[2];             // and positions
  int* srank;                // by sorted slot: a survivor's rank in its partition's front
  unsigned long long* dstat; // the dense scan's status words, as mstat
  int tick_sort;             // the sort passes' tickets, two a pass,
  int tick_dense;            // then one a dense-scan pass
};

long long align(long long b) { return (b + 255) / 256 * 256; }

long long carve(char* base, long long n, int num_sets, int nparts, bool cap, Work* w) {
  const long long nchunks = (n + kChunk - 1) / kChunk;
  const long long h = nchunks * (cap ? std::max(num_sets, kSortBuckets) : num_sets);
  const long long htiles = (h + kTile - 1) / kTile, mtiles = (n + kTile - 1) / kTile;
  const int passes = (nparts + kMarkWords - 1) / kMarkWords;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += align(bytes);
    return p;
  };
  Work v;
  v.hist = (int*)take(h * 4);
  v.hstat = (unsigned long long*)take(std::max(htiles, 1LL) * 2 * 8);
  v.mstride = std::max(mtiles, 1LL) * 2 * kMarkWords;
  v.mstat = (unsigned long long*)take(2 * v.mstride * 8);
  v.tick_sort = kTickMark + passes;
  v.tick_dense = v.tick_sort + 2 * kSortPasses;
  v.nticks = cap ? v.tick_dense + passes : v.tick_sort;
  v.tick = (int*)take(v.nticks * 4LL);
  v.set_start = (int*)take((num_sets + 1) * 4LL);
  v.nflush = (int*)take(num_sets * 4LL);
  v.ndrain = (int*)take(num_sets * 4LL);
  v.drain_off = (int*)take(num_sets * 4LL);
  v.gkey = (int*)take((num_sets + 1) * 4LL);
  v.meta = (int*)take(kMetaWords * 4LL);
  v.part = (Part*)take(nparts * (long long)sizeof(Part));
  v.pd = (int*)take((nparts + 1) * 4LL);
  v.pf = (int*)take((nparts + 1) * 4LL);
  v.b_iv = (uint2*)take(n * 8);
  v.b_pos = (int*)take(n * 4);
  v.mark = (uint8_t*)take(n);
  v.rank = (int*)take(n * 4);
  v.code = (uint8_t*)take(n);
  v.gend = (int*)take((n / 2 + 1) * 4);  // slots >= 2; one slot needs none
  v.capped = v.dheads = v.srank = nullptr;
  v.s_iv[0] = v.s_iv[1] = nullptr;
  v.s_pos[0] = v.s_pos[1] = nullptr;
  v.dstat = nullptr;
  if (cap) {
    v.capped = (int*)take(nparts * 4LL);
    v.dheads = (int*)take(nparts * 4LL);
    for (int b = 0; b < 2; ++b) {
      v.s_iv[b] = (uint2*)take(n * 8);
      v.s_pos[b] = (int*)take(n * 4);
    }
    v.srank = (int*)take(n * 4);
    v.dstat = (unsigned long long*)take(2 * v.mstride * 8);
  }
  if (w) *w = v;
  return off;
}

// ---------------------------------------------------- single-pass scans
__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// lanes up to and including `last`
__device__ __forceinline__ unsigned upto(int last) { return last >= 31 ? kFull : (2u << last) - 1u; }

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Decoupled look-back of tile t (t > 0) by one warp, over W-word status
// records: st[u * 2W, +W) holds tile u's aggregate, st[u * 2W + W, +W) its
// inclusive prefix, each word published alone (bit 63 valid; the sum
// of any prefix of tiles fits in the other 63 bits).  Lane i reads tile
// t-1-i (then 32 further back while no inclusive prefix was found); the
// nearest inclusive prefix and the aggregates after it make the exclusive
// prefix.  Returns word `lane` of it (lanes < W).  A predecessor that never
// publishes (a fault) traps after about a second instead of hanging.
template <int W>
__device__ unsigned long long look_back(const unsigned long long* st, long long t) {
  const int lane = threadIdx.x % kWarp;
  long long polls = 0;
  unsigned long long acc[W];
#pragma unroll
  for (int q = 0; q < W; ++q) acc[q] = 0;
  for (long long top = t - 1;; top -= kWarp) {
    const long long u = top - lane;
    unsigned long long v[W];
    int state = u < 0 ? 2 : 0;  // 0 not ready, 1 aggregate, 2 inclusive prefix
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = 0;
    bool found;
    for (;;) {
      if (state < 2) {
        unsigned long long x[W];
        bool ok = true;
#pragma unroll
        for (int q = 0; q < W; ++q) {
          x[q] = load_status(st + u * 2 * W + W + q);
          ok = ok && (x[q] & kValid);
        }
        if (!ok && state == 0) {
          ok = true;
#pragma unroll
          for (int q = 0; q < W; ++q) {
            x[q] = load_status(st + u * 2 * W + q);
            ok = ok && (x[q] & kValid);
          }
          if (ok) state = 1;
        } else if (ok) {
          state = 2;
        }
        if (ok) {
#pragma unroll
          for (int q = 0; q < W; ++q) v[q] = x[q] & ~kValid;
        }
      }
      const unsigned ready = __ballot_sync(kFull, state >= 1);
      const unsigned incl = __ballot_sync(kFull, state == 2);
      const int first = incl ? __ffs(incl) - 1 : kWarp;
      const unsigned need = first < kWarp ? upto(first) : kFull;
      if ((ready & need) == need) {
#pragma unroll
        for (int q = 0; q < W; ++q) acc[q] += warp_sum64((need >> lane & 1u) ? v[q] : 0ull);
        found = first < kWarp;
        break;
      }
      if (++polls > (1LL << 25)) __trap();
      __nanosleep(32);
    }
    if (found) break;
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int q = 0; q < W; ++q)
    if (lane == q) mine = acc[q];
  return mine;
}

// Tile t's exclusive prefix by warp 0 (lane q < W holds word q of the
// tile's aggregate in `agg`): publishes the aggregate, looks back, publishes
// the inclusive prefix, and leaves the exclusive prefix in excl[0, W).
template <int W>
__device__ void tile_prefix(unsigned long long* st, long long t, unsigned long long agg,
                            unsigned long long* excl) {
  const int lane = threadIdx.x % kWarp;
  unsigned long long ex = 0;
  if (t > 0) {
    if (lane < W) store_status(st + t * 2 * W + lane, agg | kValid);
    ex = look_back<W>(st, t);
  }
  if (lane < W) {
    store_status(st + t * 2 * W + W + lane, (ex + agg) | kValid);
    excl[lane] = ex;
  }
}

// ---------------------------------------------------------------- binning
// A stable counting sort by a key, over the lanes [0, len) of a source, in
// three kernels: bin_count (per-chunk histograms), hist_scan (their
// exclusive scan) and bin_scatter (each chunk's lanes to their bucket's
// offset).  A policy B names the source, the key and the destination:
//   skip()          the launch has nothing to do (read on the device)
//   len()           the lanes of the source
//   buckets()       the key's range; bucket<PLACE>(x) of a lane's index x,
//                   or buckets() for a lane that takes no part (PLACE: in
//                   the scatter, else in the count)
//   index(p), word(p, x), position(p)   lane p's index, (index, payload
//                   bits) word and stream position
//   store(at, iv, pos)   entry `at` of the sorted order
//   hist(), hstat(), tickets, zero(lc, m)   the histogram, its scan's status
//                   words and tickets, and what the count zeroes first;
//   none_placed()   the scatter has nothing to place (read on the device).
// The binning (SetBins) sorts the stream's live lanes by set; the round-cap
// fallback's sort (DigitBins) takes its passes over the capped partitions'
// lanes one 8-bit digit of the index at a time.

// one more lane of bucket k, by a shared atomic (a 16-bit counter by its
// 32-bit word; a chunk's counts stay below 2^16, so nothing carries)
__device__ __forceinline__ void count_one(int* cnt, int k) { atomicAdd(cnt + k, 1); }
__device__ __forceinline__ void count_one(uint16_t* cnt, int k) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(cnt + k);
  atomicAdd(reinterpret_cast<unsigned*>(a & ~uintptr_t(3)), 1u << (8 * (a & 2)));
}

// One warp adds the lanes [p0, p1) of each bucket to cnt[bucket], by shared
// atomics (a count needs no order).  With KEYS, kor and kand gather the OR
// and the AND of the counted lanes' sort keys.
template <bool PLACE, bool KEYS, class B, typename C>
__device__ void count_keys(const B& b, long long p0, long long p1, C* cnt, unsigned& kor,
                           unsigned& kand) {
  const int lane = threadIdx.x % kWarp;
  const int none = b.buckets();
  for (long long base = p0; base < p1; base += kWarp) {
    const long long p = base + lane;
    const int x = p < p1 ? b.index(p) : 0;
    const int k = p < p1 ? b.template bucket<PLACE>(x) : none;
    if (k < none) {
      count_one(cnt, k);
      if (KEYS) {
        kor |= (unsigned)x ^ kSignFlip;
        kand &= (unsigned)x ^ kSignFlip;
      }
    }
  }
  __syncwarp();
}

// Count: warps stride over the live chunks; each counts its chunk's lanes
// of every bucket into hist[bucket * live chunks + c].  The CTAs first zero
// what the policy's scans use (zero()).
template <class B>
__global__ void __launch_bounds__(kBinWarps * kWarp)
bin_count(B b) {
  extern __shared__ int counters[];
  b.prepare();
  if (b.skip()) return;
  const long long m = b.len();
  const int lc = live_chunks(m);
  b.zero(lc, m);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nb = b.buckets();
  int* cnt = counters + warp * nb;
  int* hist = b.hist();
  unsigned kor = 0u, kand = ~0u;
  for (int c = blockIdx.x * kBinWarps + warp; c < lc; c += gridDim.x * kBinWarps) {
    for (int s = lane; s < nb; s += kWarp) cnt[s] = 0;
    __syncwarp();
    const long long p0 = (long long)c * kChunk;
    count_keys<false, B::kKeys>(b, p0, min(p0 + kChunk, m), cnt, kor, kand);
    __syncwarp();
    for (int s = lane; s < nb; s += kWarp) hist[(long long)s * lc + c] = cnt[s];
    __syncwarp();
  }
  if (B::kKeys) b.keys(__reduce_or_sync(kFull, kor), __reduce_and_sync(kFull, kand));
}

// The live histogram's exclusive scan in place, one pass: persistent CTAs
// take 4096-entry tiles by ticket, a thread's 16 entries four 16-byte loads.
template <class B>
__global__ void __launch_bounds__(kTileThreads)
hist_scan(B b) {
  __shared__ uint32_t warp_tot[kTileWarps];
  __shared__ unsigned long long excl[1];
  __shared__ long long tile_sh;
  b.prepare();
  if (b.skip()) return;
  const long long h = (long long)b.buckets() * live_chunks(b.len());
  const long long tiles = (h + kTile - 1) / kTile;
  int* hist = b.hist();
  int* tick = b.scan_ticket();
  unsigned long long* hstat = b.hstat();
  const int tid = threadIdx.x, lane = tid % kWarp, wid = tid / kWarp;
  for (;;) {
    if (tid == 0) tile_sh = atomicAdd(tick, 1);
    __syncthreads();
    const long long t = tile_sh;
    if (t >= tiles) break;
    const long long j0 = t * kTile + (long long)tid * kTileItems;
    int4 x[kTileItems / 4];
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < kTileItems / 4; ++i) {
      x[i] = j0 < h ? reinterpret_cast<const int4*>(hist + j0)[i] : make_int4(0, 0, 0, 0);
      const long long j = j0 + 4 * i;  // entries past h are another column's garbage
      if (j >= h) x[i].x = 0;
      if (j + 1 >= h) x[i].y = 0;
      if (j + 2 >= h) x[i].z = 0;
      if (j + 3 >= h) x[i].w = 0;
      sum += x[i].x + x[i].y + x[i].z + x[i].w;
    }
    uint32_t inc = sum;
    for (int off = 1; off < kWarp; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += y;
    }
    if (lane == kWarp - 1) warp_tot[wid] = inc;
    __syncthreads();
    uint32_t before = inc - sum, total = 0;
    for (int k = 0; k < kTileWarps; ++k) {
      if (k < wid) before += warp_tot[k];
      total += warp_tot[k];
    }
    if (wid == 0) tile_prefix<1>(hstat, t, total, excl);
    __syncthreads();
    if (j0 < h) {
      uint32_t run = (uint32_t)excl[0] + before;
#pragma unroll
      for (int i = 0; i < kTileItems / 4; ++i) {
        const int4 c = x[i];
        int4 o;
        o.x = (int)run;
        o.y = (int)(run += c.x);
        o.z = (int)(run += c.y);
        o.w = (int)(run += c.z);
        run += c.w;
        reinterpret_cast<int4*>(hist + j0)[i] = o;
      }
    }
    __syncthreads();  // tile_sh and warp_tot are read before the next tile
  }
}

// shared memory of bin_scatter with `warps` warps and `buckets` buckets: the
// chunk's lanes laid out by bucket (packed (index, payload) words and 16-bit
// chunk positions), each bucket's global-minus-local offset, and each
// warp's 16-bit counters
long long scatter_smem(int buckets, int warps) {
  return (long long)kChunk * (8 + 2) + buckets * 4LL + (long long)warps * buckets * 2;
}

// Scatter: persistent CTAs take the live chunks by ticket; a CTA ranks a
// chunk's lanes by bucket in shared memory, stable by stream position, then
// writes each bucket's run of the chunk to the bucket's scanned offset
// hist[bucket * live chunks + c], so consecutive threads write consecutive
// addresses.  Warp w takes the w-th stretch of the chunk: it counts its
// lanes per bucket, a per-bucket scan over the warps and a block scan over
// the buckets give each (warp, bucket) its local offset, and a second
// ranking places the lanes.  Lanes that take no part are left out.
template <class B>
__global__ void __launch_bounds__(kScatterMaxWarps * kWarp)
bin_scatter(B b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[kScatterMaxWarps];
  __shared__ int chunk_sh;
  b.prepare();
  if (b.skip() || b.none_placed()) return;
  const int warps = blockDim.x / kWarp;
  const int nb = b.buckets();
  uint2* buf_iv = reinterpret_cast<uint2*>(smem);
  int* delta = reinterpret_cast<int*>(buf_iv + kChunk);  // global slot - local slot, by bucket
  uint16_t* buf_pos = reinterpret_cast<uint16_t*>(delta + nb);
  uint16_t* wcnt = buf_pos + kChunk;  // [warps][buckets]
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const long long m = b.len();
  const int lc = live_chunks(m);
  const int per = kChunk / warps;
  const int* hist = b.hist();
  int* tick = b.scatter_ticket();
  uint16_t* cnt = wcnt + warp * nb;
  unsigned kor = 0u, kand = ~0u;  // unused: the count gathers the keys
  for (;;) {
    if (threadIdx.x == 0) chunk_sh = atomicAdd(tick, 1);
    __syncthreads();
    const int chunk = chunk_sh;
    if (chunk >= lc) break;
    const long long p0 = (long long)chunk * kChunk;
    const int len = (int)min((long long)kChunk, m - p0);
    const int w0 = warp * per, w1 = min(w0 + per, len);  // this warp's stretch
    for (int s = lane; s < nb; s += kWarp) cnt[s] = 0;
    __syncwarp();
    count_keys<true, false>(b, p0 + w0, p0 + w1, cnt, kor, kand);
    __syncthreads();
    // local layout: by bucket, warps in order within a bucket
    const int sper = (nb + blockDim.x - 1) / blockDim.x;
    const int s0 = min((int)threadIdx.x * sper, nb), s1 = min(s0 + sper, nb);
    int mine = 0;
    for (int s = s0; s < s1; ++s)
      for (int v = 0; v < warps; ++v) mine += wcnt[v * nb + s];
    int inc = mine;
    for (int off = 1; off < kWarp; off <<= 1) {
      const int x = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += x;
    }
    if (lane == kWarp - 1) warp_sum[warp] = inc;
    __syncthreads();
    int run = inc - mine, placed = 0;
    for (int v = 0; v < warps; ++v) {
      if (v < warp) run += warp_sum[v];
      placed += warp_sum[v];
    }
    for (int s = s0; s < s1; ++s) {
      delta[s] = hist[(long long)s * lc + chunk] - run;
      for (int v = 0; v < warps; ++v) {
        const int c = wcnt[v * nb + s];
        wcnt[v * nb + s] = (uint16_t)run;
        run += c;
      }
    }
    __syncthreads();
    for (int q0 = w0; q0 < w1; q0 += kWarp) {
      const int q = q0 + lane;
      const bool live = q < w1;
      const int x = live ? b.index(p0 + q) : 0;
      const int s = live ? b.template bucket<true>(x) : nb;
      const unsigned peers = __match_any_sync(kFull, s);
      const int before = __popc(peers & ((1u << lane) - 1u));
      if (s < nb) {
        const int at = cnt[s] + before;
        buf_iv[at] = b.word(p0 + q, x);
        buf_pos[at] = (uint16_t)q;
      }
      __syncwarp();
      if (s < nb && before == 0) cnt[s] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int q = threadIdx.x; q < placed; q += blockDim.x) {
      const uint2 iv = buf_iv[q];
      const int at = q + delta[b.template bucket<true>((int)iv.x)];
      b.store(at, iv, b.position(p0 + buf_pos[q]));
    }
    __syncthreads();  // the shared buffers and chunk_sh are read before the next chunk
  }
}

// set_start[s] = first set-major slot of set s; set_start[num_sets] = n_live
__global__ void set_starts(const int* n_live, Geo g, Work w) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const long long m = live_count(n_live, g.n);
  const int lc = live_chunks(m);
  if (s < g.num_sets) w.set_start[s] = lc ? w.hist[(long long)s * lc] : 0;
  if (s == g.num_sets) w.set_start[s] = (int)m;
}

// The binning: the stream's live lanes by set.  The count takes every live
// lane (the bypass and the round cap are decided from it); the scatter
// leaves out the lanes of capped partitions (the fallback sorts them).
struct SetBins {
  static constexpr bool kKeys = false;
  const int* idx;
  const uint32_t* val;
  const int* n_live;
  Geo g;
  Work w;
  int parts;  // the layout's partitions (read in prepare, with a cap)
  __device__ void prepare() { parts = w.capped ? w.meta[kMetaParts] : 1; }
  __device__ bool skip() const { return false; }
  // every partition capped: the fallback's sort takes every live lane
  __device__ bool none_placed() const {
    return w.capped && w.meta[kMetaCapped] == parts;
  }
  __device__ long long len() const { return live_count(n_live, g.n); }
  __device__ int buckets() const { return g.num_sets; }
  __device__ int index(long long p) const { return idx[p]; }
  template <bool PLACE>
  __device__ int bucket(int x) const {
    const int s = hash_set(x, g.epb, g.num_sets);
    return PLACE && w.capped && w.capped[s % parts] ? g.num_sets : s;
  }
  __device__ uint2 word(long long p, int x) const { return make_uint2((uint32_t)x, val[p]); }
  __device__ int position(long long p) const { return (int)p; }
  __device__ void store(long long at, uint2 iv, int pos) const {
    w.b_iv[at] = iv;
    w.b_pos[at] = pos;
  }
  __device__ int* hist() const { return w.hist; }
  __device__ unsigned long long* hstat() const { return w.hstat; }
  __device__ int* scan_ticket() const { return w.tick + kTickHist; }
  __device__ int* scatter_ticket() const { return w.tick + kTickScatter; }
  __device__ void keys(unsigned, unsigned) const {}
  // the scans' status words of the live tiles (the histogram's, the mark
  // scan's, the dense scan's) and every ticket counter
  __device__ void zero(int lc, long long m) const {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long hz = 2 * (((long long)g.num_sets * lc + kTile - 1) / kTile);
    const long long mz = 2LL * kMarkWords * ((m + kTile - 1) / kTile);
    for (long long i = tid; i < hz; i += stride) w.hstat[i] = 0;
    for (long long i = tid; i < mz; i += stride) w.mstat[i] = w.mstat[w.mstride + i] = 0;
    if (w.dstat)
      for (long long i = tid; i < mz; i += stride) w.dstat[i] = w.dstat[w.mstride + i] = 0;
    for (long long i = tid; i < w.nticks; i += stride) w.tick[i] = 0;
  }
};

// Digit pass `pass` of the fallback's sort, by the index's `pass`-th 8-bit
// digit (of its sign-flipped bits): pass 0 takes the capped partitions'
// live lanes from the stream into buffer 0 and gathers the OR and the AND
// of their keys; a later pass moves the sorted lanes from one buffer to the
// other, and is skipped when every key has the same digit there (it would
// move nothing).  Nothing runs when no partition is capped.
struct DigitBins {
  static constexpr bool kKeys = true;
  const int* idx;
  const uint32_t* val;
  const int* n_live;
  Geo g;
  Work w;
  int pass;
  int parts, src, dst;  // read in prepare
  __device__ bool trivial(int p) const {
    const unsigned diff = (unsigned)w.meta[kMetaOr] ^ (unsigned)w.meta[kMetaAnd];
    return p > 0 && ((diff >> (kSortBits * p)) & (kSortBuckets - 1)) == 0;
  }
  __device__ void prepare() {
    parts = w.meta[kMetaParts];
    src = 0;
    for (int p = 1; p < pass; ++p)
      if (!trivial(p)) src ^= 1;
    dst = pass == 0 ? 0 : src ^ 1;
  }
  __device__ bool skip() const { return w.meta[kMetaDense] == 0 || trivial(pass); }
  __device__ bool none_placed() const { return false; }
  __device__ long long len() const {
    return pass == 0 ? live_count(n_live, g.n) : (long long)w.meta[kMetaDense];
  }
  __device__ int buckets() const { return kSortBuckets; }
  __device__ int index(long long p) const { return pass == 0 ? idx[p] : (int)w.s_iv[src][p].x; }
  template <bool>
  __device__ int bucket(int x) const {
    if (pass == 0 && !w.capped[hash_set(x, g.epb, g.num_sets) % parts]) return kSortBuckets;
    return (int)((((unsigned)x ^ kSignFlip) >> (kSortBits * pass)) & (kSortBuckets - 1));
  }
  __device__ uint2 word(long long p, int x) const {
    return pass == 0 ? make_uint2((uint32_t)x, val[p]) : w.s_iv[src][p];
  }
  __device__ int position(long long p) const { return pass == 0 ? (int)p : w.s_pos[src][p]; }
  __device__ void store(long long at, uint2 iv, int pos) const {
    w.s_iv[dst][at] = iv;
    w.s_pos[dst][at] = pos;
  }
  __device__ int* hist() const { return w.hist; }
  __device__ unsigned long long* hstat() const { return w.hstat; }
  __device__ int* scan_ticket() const { return w.tick + w.tick_sort + 2 * pass; }
  __device__ int* scatter_ticket() const { return w.tick + w.tick_sort + 2 * pass + 1; }
  __device__ void keys(unsigned kor, unsigned kand) const {
    if (pass == 0 && threadIdx.x % kWarp == 0) {
      atomicOr(reinterpret_cast<unsigned*>(w.meta + kMetaOr), kor);
      atomicAnd(reinterpret_cast<unsigned*>(w.meta + kMetaAnd), kand);
    }
  }
  // this pass's histogram scan's status words
  __device__ void zero(int lc, long long) const {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long hz = 2 * (((long long)kSortBuckets * lc + kTile - 1) / kTile);
    for (long long i = tid; i < hz; i += stride) w.hstat[i] = 0;
  }
};

// the buffer that holds the fallback's sorted lanes after its passes
__device__ __forceinline__ int sorted_buffer(const Work& w) {
  DigitBins d;
  d.w = w;
  d.pass = kSortPasses;
  d.prepare();
  return d.src;
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

// The warp's shared copies of walk_set: the batch's payload bits and
// positions, each slot's index, the lane a new slot takes its arrival from,
// and the slot each filtered arrival folds into (kWarp entries each,
// 16-byte aligned).
struct WalkScratch {
  uint32_t* payload;
  int* position;
  int* resident;
  int* taken_from;
  int* folds_into;
};

// One warp walks one set's `len` arrivals, lane j holding slot j; the
// arrivals are taken 32 at a time (the next batch loads while this one is
// folded).  A batch is cut into sub-steps at triggers.  In a sub-step that
// starts at lane a with cnt residents, an arrival is filtered if its index
// equals a resident's (each lane scans the warp's shared copy of the
// resident indices) or an earlier arrival's of the sub-step
// (__match_any_sync); the others are new, take slots cnt, cnt+1, ... in lane
// order (each writes itself into its slot's shared entry, which the slot's
// lane reads), and the new arrival that takes slot `slots`-1 is the trigger,
// which ends the sub-step: the set's residents are put at the next `slots`
// kept entries and the next sub-step starts after it with an empty set.
// Each slot's owner folds the sub-step's filtered arrivals that name its
// slot, in lane order (stream order), from the warp's shared copy of the
// batch, so f32 sums add in the oracle's order; tagged, under the family
// of the slot's index (Src::family).
//
// Src gives arrival k of the set (load: packed (index, payload bits) and
// position), takes kept entry q of
// the set (put: flush groups first, then the drain group), and marks an
// arrival's position as a trigger or filtered (mark; with Src::kMarkAll
// kept arrivals too).  Returns the number of flush groups; `drained` is the
// drain group's size.
template <typename T, int OP, class Src>
__device__ int walk_set(const Src& src, int len, int slots, const WalkScratch& sh,
                        int& drained) {
  const int lane = threadIdx.x % kWarp;
  const int4* res4 = reinterpret_cast<const int4*>(sh.resident);
  const uint4* pay4 = reinterpret_cast<const uint4*>(sh.payload);
  const int4* into4 = reinterpret_cast<const int4*>(sh.folds_into);
  const unsigned below = (1u << lane) - 1u;
  int r_idx = 0, r_pos = 0;  // slot `lane` of this set
  T r_val = T(0);
  bool r_add = false;  // tagged: the slot's family
  int cnt = 0, wc = 0, flushes = 0;  // warp-uniform
  uint2 nx_iv = make_uint2(0, 0);
  int nx_pos = 0;
  if (lane < len) src.load(lane, nx_iv, nx_pos);
  for (int k0 = 0; k0 < len; k0 += kWarp) {
    const int steps = min(kWarp, len - k0);
    const unsigned valid = upto(steps - 1);
    const bool have = lane < steps;
    const int ei = (int)nx_iv.x;
    const int ep = nx_pos;
    sh.payload[lane] = nx_iv.y;
    sh.position[lane] = nx_pos;
    // the next batch is never put before it is loaded (a flush group is
    // `slots` arrivals already consumed)
    if (k0 + kWarp + lane < len) src.load(k0 + kWarp + lane, nx_iv, nx_pos);
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
      const unsigned tmask = __ballot_sync(kFull, is_new && rank == slots - cnt - 1);
      const bool trig = tmask != 0;
      const int last = trig ? __ffs(tmask) - 1 : steps - 1;
      const unsigned range = sub & upto(last);
      const unsigned ins = newm & range;
      const int nins = __popc(ins);
      if (ins >> lane & 1u) {
        sh.resident[cnt + rank] = ei;
        sh.taken_from[cnt + rank] = lane;
      }
      unsigned fm = 0;  // the sub-step's filtered arrivals
      if (OP != kNone) {
        fm = range & ~ins;
        filtered |= fm;
        if (own < 0 && (fm >> lane & 1u))  // a duplicate of a new arrival
          own = cnt + __popc(ins & ((1u << (__ffs(peers & sub) - 1)) - 1u));
        sh.folds_into[lane] = (fm >> lane & 1u) ? own : -1;
      }
      __syncwarp();
      if (lane >= cnt && lane < cnt + nins) {  // a new slot
        const int t = sh.taken_from[lane];
        r_idx = sh.resident[lane];
        r_val = from_bits<T>(sh.payload[t]);
        r_pos = sh.position[t];
        if constexpr (OP == kTagged) r_add = src.family(r_idx);
      }
      if (OP != kNone && fm) {
        // each slot's owner folds the arrivals that name it, in lane order
#pragma unroll
        for (int q = 0; q < kWarp / 4; ++q) {
          const int4 o = into4[q];
          const uint4 b = pay4[q];
          if (o.x == lane) r_val = fold_one<T, OP>(r_val, from_bits<T>(b.x), r_add);
          if (o.y == lane) r_val = fold_one<T, OP>(r_val, from_bits<T>(b.y), r_add);
          if (o.z == lane) r_val = fold_one<T, OP>(r_val, from_bits<T>(b.z), r_add);
          if (o.w == lane) r_val = fold_one<T, OP>(r_val, from_bits<T>(b.w), r_add);
        }
      }
      __syncwarp();  // the shared copies are read before they change
      cnt += nins;
      if (trig) {
        if (lane < slots) src.put(wc + lane, r_idx, to_bits(r_val), r_pos);
        triggers |= 1u << last;
        wc += slots;
        cnt = 0;
        ++flushes;
      }
      a = last + 1;
    }
    if constexpr (Src::kMarkAll) {
      if (have)
        src.mark(ep, (filtered >> lane & 1u) ? kFiltered
                     : (triggers >> lane & 1u) ? kTrigger : kKept);
    } else if (have && ((filtered | triggers) >> lane & 1u)) {
      src.mark(ep, (filtered >> lane & 1u) ? kFiltered : kTrigger);
    }
  }
  if (lane < cnt) src.put(wc + lane, r_idx, to_bits(r_val), r_pos);  // drain group
  drained = cnt;
  return flushes;
}

// walk_set's view of one set of the whole-stream body: its stretch of the
// binned arrays, into whose consumed part the kept entries are put, and the
// stream's marks (every arrival's: the marks are not cleared first)
struct BinnedSet {
  static constexpr bool kMarkAll = true;
  uint2* b_iv;
  int* b_pos;
  uint8_t* marks;
  int start;
  uint8_t part;  // the set's partition field of a mark byte
  __device__ void load(int k, uint2& iv, int& pos) const {
    iv = b_iv[start + k];
    pos = b_pos[start + k];
  }
  __device__ void put(int q, int idx, uint32_t bits, int pos) const {
    b_iv[start + q] = make_uint2((uint32_t)idx, bits);
    b_pos[start + q] = pos;
  }
  __device__ void mark(int pos, uint8_t kind) const { marks[pos] = kind | part; }
};

// A set of a capped partition is the fallback's: the walk leaves it (no
// flush group, no drain group) and the fallback's sort takes its lanes.
__device__ __forceinline__ bool fallback_set(int s, const Work& w) {
  if (w.capped == nullptr || !w.capped[s % w.meta[kMetaParts]]) return false;
  if (threadIdx.x % kWarp == 0) w.nflush[s] = w.ndrain[s] = 0;
  return true;
}

// One warp per set (kWalkWarps a CTA).
template <typename T, int OP>
__global__ void __launch_bounds__(kWalkWarps * kWarp)
walk(Geo g, Work w) {
  __shared__ __align__(16) uint32_t payload[kWalkWarps][kWarp];
  __shared__ __align__(16) int position[kWalkWarps][kWarp];
  __shared__ __align__(16) int resident[kWalkWarps][kWarp];
  __shared__ __align__(16) int taken_from[kWalkWarps][kWarp];
  __shared__ __align__(16) int folds_into[kWalkWarps][kWarp];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int s = blockIdx.x * kWalkWarps + wid;
  if (s >= g.num_sets || fallback_set(s, w)) return;
  const WalkScratch sh{payload[wid], position[wid], resident[wid], taken_from[wid],
                       folds_into[wid]};
  const BinnedSet src{w.b_iv, w.b_pos, w.mark, w.set_start[s], mark_part(s, g)};
  int drained;
  const int flushes =
      walk_set<T, OP>(src, w.set_start[s + 1] - w.set_start[s], g.slots, sh, drained);
  if (lane == 0) {
    w.nflush[s] = flushes;
    w.ndrain[s] = drained;
  }
}

// The tagged walk's chain: one warp walks one set's arrivals as walk_set
// does (32 a batch, sub-steps cut at triggers), but reads only their
// indices and positions and folds nothing.  Each arrival's code (the slot
// it takes, | kKeptCode, or the slot it folds into) goes to its binned
// slot, its mark (kind and partition) to its stream position, and each
// flush group's end (the arrival after its trigger) to gend; the folds
// are fold_emit's.
__global__ void __launch_bounds__(kWalkWarps * kWarp)
chain(Geo g, Work w) {
  __shared__ __align__(16) int resident[kWalkWarps][kWarp];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int s = blockIdx.x * kWalkWarps + wid;
  if (s >= g.num_sets || fallback_set(s, w)) return;
  int* res = resident[wid];
  const int4* res4 = reinterpret_cast<const int4*>(res);
  const unsigned below = (1u << lane) - 1u;
  const int slots = g.slots;
  const int start = w.set_start[s], len = w.set_start[s + 1] - start;
  int* gend = w.gend + start / slots;
  const uint8_t part = mark_part(s, g);
  const int* b_idx = reinterpret_cast<const int*>(w.b_iv) + 2LL * start;  // the index words
  const int* b_pos = w.b_pos + start;
  int cnt = 0, groups = 0;  // warp-uniform
  // the next two batches load while this one is walked
  int nx_idx = 0, nx_pos = 0, nx2_idx = 0, nx2_pos = 0;
  if (lane < len) {
    nx_idx = b_idx[2 * lane];
    nx_pos = b_pos[lane];
  }
  if (kWarp + lane < len) {
    nx2_idx = b_idx[2 * (kWarp + lane)];
    nx2_pos = b_pos[kWarp + lane];
  }
  for (int k0 = 0; k0 < len; k0 += kWarp) {
    const int steps = min(kWarp, len - k0);
    const unsigned valid = upto(steps - 1);
    const int ei = nx_idx, ep = nx_pos;
    nx_idx = nx2_idx;
    nx_pos = nx2_pos;
    if (k0 + 2 * kWarp + lane < len) {
      nx2_idx = b_idx[2 * (k0 + 2 * kWarp + lane)];
      nx2_pos = b_pos[k0 + 2 * kWarp + lane];
    }
    const unsigned peers = __match_any_sync(kFull, ei) & valid;
    int code = 0;
    uint8_t kind = kKept;
    int a = 0;
    while (a < steps) {
      const unsigned sub = valid & ~((1u << a) - 1u);
      int own = -1;
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) {
        const int4 r = res4[q];
        if (4 * q < cnt && r.x == ei) own = 4 * q;
        if (4 * q + 1 < cnt && r.y == ei) own = 4 * q + 1;
        if (4 * q + 2 < cnt && r.z == ei) own = 4 * q + 2;
        if (4 * q + 3 < cnt && r.w == ei) own = 4 * q + 3;
      }
      const unsigned hit = __ballot_sync(kFull, own >= 0) & sub;
      const unsigned newm = __ballot_sync(kFull, (peers & sub & below) == 0) & sub & ~hit;
      const bool is_new = newm >> lane & 1u;
      const int rank = __popc(newm & below);
      const unsigned tmask = __ballot_sync(kFull, is_new && rank == slots - cnt - 1);
      const bool trig = tmask != 0;
      const int last = trig ? __ffs(tmask) - 1 : steps - 1;
      const unsigned range = sub & upto(last);
      const unsigned ins = newm & range;
      if (ins >> lane & 1u) {
        res[cnt + rank] = ei;
        code = (cnt + rank) | kKeptCode;
      }
      if ((range & ~ins) >> lane & 1u) {
        if (own < 0)  // a duplicate of a new arrival of this sub-step
          own = cnt + __popc(ins & ((1u << (__ffs(peers & sub) - 1)) - 1u));
        code = own;
        kind = kFiltered;
      }
      __syncwarp();  // the residents are written before the next sub-step reads them
      cnt += __popc(ins);
      if (trig) {
        if (lane == last) kind = kTrigger;
        if (lane == 0 && slots > 1) gend[groups] = k0 + last + 1;
        ++groups;
        cnt = 0;
      }
      a = last + 1;
    }
    if (lane < steps) {
      w.code[start + k0 + lane] = (uint8_t)code;
      w.mark[ep] = kind | part;
    }
  }
  if (lane == 0) {
    w.nflush[s] = groups;
    w.ndrain[s] = cnt;
  }
}

// ------------------------------------------------------------------ scans
__device__ __forceinline__ int2 add2(int2 a, int2 b) { return make_int2(a.x + b.x, a.y + b.y); }

// exclusive block scan of int2 sums over NT threads
template <int NT>
__device__ int2 block_scan(int2 v, int2& total) {
  __shared__ int2 warp_sum[NT / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int2 inc = v;
  for (int off = 1; off < kWarp; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, off), y = __shfl_up_sync(kFull, inc.y, off);
    if (lane >= off) inc = add2(inc, make_int2(x, y));
  }
  if (lane == kWarp - 1) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < NT / kWarp ? warp_sum[lane] : make_int2(0, 0);
    for (int off = 1; off < kWarp; off <<= 1) {
      const int x = __shfl_up_sync(kFull, w.x, off), y = __shfl_up_sync(kFull, w.y, off);
      if (lane >= off) w = add2(w, make_int2(x, y));
    }
    if (lane < NT / kWarp) warp_sum[lane] = w;
  }
  __syncthreads();
  const int2 before = warp > 0 ? warp_sum[warp - 1] : make_int2(0, 0);
  total = warp_sum[NT / kWarp - 1];
  __syncthreads();
  return make_int2(inc.x - v.x + before.x, inc.y - v.y + before.y);
}

// exclusive scan over [0, count) by one block of NT threads, each taking a
// contiguous stretch: use(j, prefix before j, load(j)).  Returns the total.
template <int NT, class Load, class Use>
__device__ int2 stretch_scan(int count, const Load& load, const Use& use) {
  const int per = (count + NT - 1) / NT;
  const int j0 = min((int)threadIdx.x * per, count), j1 = min(j0 + per, count);
  int2 v = make_int2(0, 0);
  for (int j = j0; j < j1; ++j) v = add2(v, load(j));
  int2 total;
  int2 run = block_scan<NT>(v, total);
  for (int j = j0; j < j1; ++j) {
    const int2 x = load(j);
    use(j, run, x);
    run = add2(run, x);
  }
  return total;
}

// partition_capacity of ref.py: the most live lanes a partition's bank row
// holds before the stream bypasses the banks
__device__ __forceinline__ long long partition_capacity(long long m, int parts) {
  const long long per = (m + parts - 1) / parts;
  return min(m, per + max(64LL, per / 4));
}

// the set of the k-th slot of partition-major set order (partition k / q,
// then set id), with q = num_sets / parts sets a partition
__device__ __forceinline__ int set_of_key(int k, int q, int parts) { return (k % q) * parts + k / q; }

// One CTA, from the per-set live counts, before the scatter: the bank
// bypass (meta's partitions of the layout) and, with a round cap, each
// partition's fallback.  A partition is capped when one of its sets holds
// more than round_cap * slots live lanes (ref.max_round_bound past the
// cap: each full round takes `slots` arrivals); after a bypass the whole
// stream is the one partition.  Leaves the capped live lanes' count, zeroed
// survivor counts and the sort keys' OR and AND identities in meta.
__global__ void __launch_bounds__(kScanThreads)
decide(const int* n_live, Geo g, Work w) {
  __shared__ unsigned long long worst_sh;
  __shared__ int parts_sh;
  const long long m = live_count(n_live, g.n);
  const int* set_start = w.set_start;
  if (threadIdx.x == 0) worst_sh = 0;
  __syncthreads();
  if (g.nparts > 1) {
    unsigned long long worst = 0;
    for (int p = threadIdx.x; p < g.nparts; p += blockDim.x) {
      unsigned long long c = 0;
      for (int s = p; s < g.num_sets; s += g.nparts) c += set_start[s + 1] - set_start[s];
      worst = max(worst, c);
    }
    atomicMax(&worst_sh, worst);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int parts = g.nparts;
    if (parts > 1 && (long long)worst_sh > partition_capacity(m, parts)) parts = 1;  // bank bypass
    parts_sh = parts;
    w.meta[kMetaParts] = parts;
  }
  __syncthreads();
  if (w.capped == nullptr) return;
  const int parts = parts_sh;
  for (int p = threadIdx.x; p < parts; p += blockDim.x) w.capped[p] = w.dheads[p] = 0;
  __syncthreads();
  const long long most = (long long)g.round_cap * g.slots;
  for (int s = threadIdx.x; s < g.num_sets; s += blockDim.x)
    if (set_start[s + 1] - set_start[s] > most) w.capped[s % parts] = 1;
  __syncthreads();
  int2 mine = make_int2(0, 0);  // capped live lanes, capped partitions
  for (int s = threadIdx.x; s < g.num_sets; s += blockDim.x)
    if (w.capped[s % parts]) mine.x += set_start[s + 1] - set_start[s];
  for (int p = threadIdx.x; p < parts; p += blockDim.x) mine.y += w.capped[p];
  int2 total;
  block_scan<kScanThreads>(mine, total);
  if (threadIdx.x == 0) {
    w.meta[kMetaDense] = total.x;
    w.meta[kMetaCapped] = total.y;
    w.meta[kMetaOr] = 0;
    w.meta[kMetaAnd] = -1;
  }
}

// One CTA, after the walk and the fallback's scan: drain offsets within
// each partition (a scan of the drain counts in partition-major set
// order), the fold's spans before each set key (gkey: 32 of a set's groups
// a span, its flush groups and one drain group; none for a capped
// partition's set) and each partition's front and tail (a capped
// partition keeps its dheads survivors); meta's flush groups and
// survivors.  pd and pf (nparts+1 entries each) hold the drain and flush
// prefixes at each partition's first set.
__global__ void __launch_bounds__(kScanThreads)
finalize(const int* n_live, Geo g, Work w) {
  const long long m = live_count(n_live, g.n);
  const int* set_start = w.set_start;
  const int parts = w.meta[kMetaParts], q = g.num_sets / parts;
  auto capped = [&](int p) { return w.capped != nullptr && w.capped[p] != 0; };
  const int2 total = stretch_scan<kScanThreads>(
      g.num_sets,
      [&](int k) {
        const int s = set_of_key(k, q, parts);
        return make_int2(w.ndrain[s], w.nflush[s]);
      },
      [&](int k, int2 before, int2) {
        w.drain_off[set_of_key(k, q, parts)] = before.x;
        if (k % q == 0) {
          w.pd[k / q] = before.x;
          w.pf[k / q] = before.y;
        }
      });
  const int2 spans = stretch_scan<kScanThreads>(
      g.num_sets,
      [&](int k) {
        const int s = set_of_key(k, q, parts);
        return make_int2(capped(k / q) ? 0 : w.nflush[s] / kWarp + 1, 0);
      },
      [&](int k, int2 before, int2) { w.gkey[k] = before.x; });
  if (threadIdx.x == 0) {
    w.pd[parts] = total.x;
    w.pf[parts] = total.y;
    w.gkey[g.num_sets] = spans.x;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < g.num_sets; s += blockDim.x) w.drain_off[s] -= w.pd[s % parts];
  if (threadIdx.x == 0) {
    long long front = 0, tail = 0, survivors = (long long)total.y * g.slots + total.x;
    for (int p = 0; p < parts; ++p)
      if (capped(p)) survivors += w.dheads[p];
    for (int p = 0; p < parts; ++p) {
      long long lanes = m;  // the partition's live lanes
      if (parts > 1) {
        lanes = 0;
        for (int s = p; s < g.num_sets; s += parts) lanes += set_start[s + 1] - set_start[s];
      }
      const int flushes = w.pf[p + 1] - w.pf[p];
      const long long kept = capped(p) ? (long long)w.dheads[p]
                                       : (long long)flushes * g.slots + (w.pd[p + 1] - w.pd[p]);
      w.part[p] = Part{(int)front, flushes, (int)(g.n - (m - survivors) + tail),
                       (int)(lanes - kept)};
      front += kept;
      tail += lanes - kept;
    }
    w.meta[kMetaFlush] = total.y;
    w.meta[kMetaSurvivors] = (int)survivors;
  }
}

template <typename T>
struct Out {
  int* idx;
  T* val;
  int* pos;
  uint8_t* act;
};

// One pass of the mark scan, for partitions [8 pass, 8 pass + W) of the
// layout's: persistent CTAs take 4096-lane tiles of the live prefix by
// ticket.  A thread loads its 16 marks in one 16-byte load and counts each
// partition's triggers (low 16 bits) and filtered lanes (high 16) in one
// word (a tile's counts stay below 2^16); the warps' sums make the tile's aggregate, and the look-back its
// exclusive prefix (31-bit trigger and filtered counts in one 64-bit word a
// partition).  Then each warp takes its 512 lanes 32 at a time in stream
// order: one ballot a (kind, partition) ranks a lane among the step's, so
// a trigger gets its flush rank and a filtered lane its tail slot (the
// first detected last), written with consecutive lanes on consecutive
// addresses.  A pass zeroes the next pass's status words of its tiles (the
// buffers alternate).
template <typename T, int W>
__global__ void __launch_bounds__(kTileThreads)
mark_scan(const int* idx, const T* val, const int* n_live, Geo g, Work w, Out<T> out, int pass) {
  __shared__ __align__(16) uint8_t smark[kTile];
  __shared__ uint32_t warp_tot[kTileWarps][W];
  __shared__ unsigned long long excl[W];
  __shared__ long long tile_sh;
  const int parts = w.meta[kMetaParts], p0 = pass * kMarkWords;
  if (p0 >= parts) return;
  const long long m = live_count(n_live, g.n);
  const long long tiles = (m + kTile - 1) / kTile;
  unsigned long long* st = w.mstat + (pass & 1) * w.mstride;
  unsigned long long* st_next = w.mstat + ((pass + 1) & 1) * w.mstride;
  const int tid = threadIdx.x, lane = tid % kWarp, wid = tid / kWarp;
  const unsigned below = (1u << lane) - 1u;
  // a marked lane's partition, relative to p0 (-1: past this pass's)
  auto part_of = [&](unsigned b, long long j) {
    int p = parts == 1 ? 0
            : g.nparts <= kMaxMarkParts ? (int)(b >> 2)
                                        : hash_set(idx[j], g.epb, g.num_sets) % parts;
    p -= p0;
    return p < W ? p : -1;
  };
  for (;;) {
    if (tid == 0) tile_sh = atomicAdd(&w.tick[kTickMark + pass], 1);
    __syncthreads();
    const long long t = tile_sh;
    if (t >= tiles) break;
    if (tid < 2 * W) st_next[t * 2 * W + tid] = 0;
    const long long base = t * kTile, j0 = base + (long long)tid * kTileItems;
    uint4 b4[kTileItems / 16];
#pragma unroll
    for (int v = 0; v < kTileItems / 16; ++v) {
      b4[v] = j0 + 16 * v < m ? reinterpret_cast<const uint4*>(w.mark + j0)[v]
                              : make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(smark + tid * kTileItems)[v] = b4[v];
    }
    uint32_t mine[W];
#pragma unroll
    for (int q = 0; q < W; ++q) mine[q] = 0;
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      const uint4 v4 = b4[i / 16];
      const uint32_t word = i % 16 < 4 ? v4.x : i % 16 < 8 ? v4.y : i % 16 < 12 ? v4.z : v4.w;
      const unsigned b = word >> (8 * (i % 4)) & 0xffu;
      const unsigned kind = b & 3u;
      if (kind == kKept || j0 + i >= m) continue;
      const int p = part_of(b, j0 + i);
      const uint32_t inc = kind == kTrigger ? 1u : 0x10000u;
#pragma unroll
      for (int q = 0; q < W; ++q) mine[q] += p == q ? inc : 0u;
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const uint32_t s = __reduce_add_sync(kFull, mine[q]);
      if (lane == 0) warp_tot[wid][q] = s;
    }
    __syncthreads();
    if (wid == 0) {
      // word q of the tile's aggregate: 31-bit trigger count over 31-bit filtered count
      unsigned long long agg = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        uint32_t c = 0;
        for (int k = 0; k < kTileWarps; ++k) c += warp_tot[k][q];
        if (lane == q) agg = (unsigned long long)(c & 0xffffu) << 31 | (c >> 16);
      }
      tile_prefix<W>(st, t, agg, excl);
    }
    __syncthreads();
    int rt[W], rf[W];  // this warp's running counts, warp-uniform
#pragma unroll
    for (int q = 0; q < W; ++q) {
      uint32_t c = 0;
      for (int k = 0; k < wid; ++k) c += warp_tot[k][q];
      rt[q] = (int)(excl[q] >> 31) + (int)(c & 0xffffu);
      rf[q] = (int)(excl[q] & 0x7fffffffu) + (int)(c >> 16);
    }
    // eight steps at a time: ranks and tail slots, the filtered lanes'
    // loads all issued, then the stores
    constexpr int kSteps = kTile / kTileWarps / kWarp, kBatch = 8;
    for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
      int what[kBatch], at[kBatch], xi[kBatch];  // what: kKept (none), kTrigger, kFiltered
      T xv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int l = wid * (kTile / kTileWarps) + (s0 + u) * kWarp + lane;
        const long long j = base + l;
        const unsigned b = smark[l];
        const unsigned kind = j < m ? b & 3u : (unsigned)kKept;
        const int p = kind != kKept ? part_of(b, j) : -1;
        int before = 0;
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const unsigned tm = __ballot_sync(kFull, kind == kTrigger && p == q);
          const unsigned fm = __ballot_sync(kFull, kind == kFiltered && p == q);
          if (p == q) before = kind == kTrigger ? rt[q] + __popc(tm & below) : rf[q] + __popc(fm & below);
          rt[q] += __popc(tm);
          rf[q] += __popc(fm);
        }
        what[u] = p < 0 ? (int)kKept : (int)kind;
        at[u] = before;
        if (what[u] == kFiltered) {
          const Part pt = w.part[p0 + p];
          at[u] = pt.tail + pt.filtered - 1 - before;
          xi[u] = idx[j];
          xv[u] = val[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long j = base + wid * (kTile / kTileWarps) + (s0 + u) * kWarp + lane;
        if (what[u] == kTrigger) {
          w.rank[j] = at[u];
        } else if (what[u] == kFiltered) {
          out.idx[at[u]] = xi[u];
          out.val[at[u]] = xv[u];
          out.pos[at[u]] = (int)j;
          out.act[at[u]] = 0;
        }
      }
    }
    __syncthreads();  // smark, warp_tot and tile_sh are read before the next tile
  }
}

// ------------------------------------------------------------------ emit
// The dead lanes [n_live, n) to [survivors, survivors + n - n_live) in
// stream order, inactive: a thread four consecutive lanes, 16-byte stores
// aligned on the output (survivors has no alignment), 16-byte loads when
// the input is aligned the same way, else four 4-byte loads (each warp's
// loads still consecutive).
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
copy_dead(const int* __restrict__ idx, const T* __restrict__ val, const int* n_live, long long n,
          const int* meta, Out<T> out) {
  const long long m = live_count(n_live, n), d = n - m;
  if (d <= 0) return;
  const long long s = meta[1];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long head = min(d, (4 - s % 4) % 4);  // lanes before an aligned output
  const long long quads = (d - head) / 4, tail = head + 4 * quads;
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(val);
  uint32_t* ob = reinterpret_cast<uint32_t*>(out.val);
  auto one = [&](long long k) {
    out.idx[s + k] = idx[m + k];
    ob[s + k] = vb[m + k];
    out.pos[s + k] = (int)(m + k);
    out.act[s + k] = 0;
  };
  if (tid < head) one(tid);
  if (tid < d - tail) one(tail + tid);
  const long long o0 = s + head, j0 = m + head;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out.idx + o0) |
                        reinterpret_cast<uintptr_t>(ob + o0) |
                        reinterpret_cast<uintptr_t>(out.pos + o0)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out.act + o0) % 4 == 0;
  const bool vec_in = (reinterpret_cast<uintptr_t>(idx + j0) |
                       reinterpret_cast<uintptr_t>(vb + j0)) % 16 == 0;
  for (long long qi = tid; qi < quads; qi += stride) {
    const long long k = head + 4 * qi;
    if (!vec_out) {
      for (int i = 0; i < 4; ++i) one(k + i);
      continue;
    }
    const long long j = m + k, o = s + k;
    int4 xi;
    uint4 xv;
    if (vec_in) {
      xi = *reinterpret_cast<const int4*>(idx + j);
      xv = *reinterpret_cast<const uint4*>(vb + j);
    } else {
      xi = make_int4(idx[j], idx[j + 1], idx[j + 2], idx[j + 3]);
      xv = make_uint4(vb[j], vb[j + 1], vb[j + 2], vb[j + 3]);
    }
    *reinterpret_cast<int4*>(out.idx + o) = xi;
    *reinterpret_cast<uint4*>(ob + o) = xv;
    *reinterpret_cast<int4*>(out.pos + o) =
        make_int4((int)j, (int)(j + 1), (int)(j + 2), (int)(j + 3));
    *reinterpret_cast<uint32_t*>(out.act + o) = 0u;
  }
}

// threads stride over the live set-major slots: kept entries go to their
// partition's front (a capped partition's sets hold none)
template <typename T>
__global__ void __launch_bounds__(kEmitThreads)
emit_kept(const int* n_live, Geo g, Work w, Out<T> out) {
  const int* set_start = w.set_start;
  const long long m = live_count(n_live, g.n);
  const int parts = w.meta[kMetaParts];
  if (w.capped && w.meta[kMetaCapped] == parts) return;  // all the fallback's
  for (long long q = (long long)blockIdx.x * kEmitThreads + threadIdx.x; q < m;
       q += (long long)gridDim.x * kEmitThreads) {
    int lo = 0, hi = g.num_sets;  // last s with set_start[s] <= q
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (set_start[mid] <= q) lo = mid; else hi = mid;
    }
    const int s = lo, start = set_start[s];
    const int local = (int)(q - start);
    const int nf = w.nflush[s] * g.slots;
    if (local >= nf + w.ndrain[s]) continue;  // consumed arrivals past the kept entries
    const Part pt = w.part[s % parts];
    long long o;
    if (local < nf) {
      const int grp = local / g.slots, j = local % g.slots;
      const int trig = w.b_pos[start + grp * g.slots + g.slots - 1];
      o = pt.front + (long long)w.rank[trig] * g.slots + j;
    } else {
      o = pt.front + (long long)pt.flushes * g.slots + w.drain_off[s] + (local - nf);
    }
    const uint2 iv = w.b_iv[q];
    out.idx[o] = (int)iv.x;
    out.val[o] = from_bits<T>(iv.y);
    out.pos[o] = w.b_pos[q];
    out.act[o] = 1;
  }
}

// The tagged walk's fold: one warp a span of up to 32 consecutive groups of
// one set (its flush groups, then its drain group; set keys in
// partition-major order), warps striding over the spans gkey counts.  Lane
// i holds group i of the span: its end and its place in the partition's
// front (a flush group at its trigger's rank, the drain group after the
// partition's flush groups), all loaded at once.  The warp then walks the
// span's groups in order, each group's arrivals 32 at a time (the next
// step's load issued before this one is folded), lane j holding slot j:
// the step's payloads go to shared memory, a kept arrival's index and
// position to its slot's entry, and five ballots (one a bit of the slot)
// give each slot's lane its arrivals of the step.  The slot's lane takes
// its kept arrival first (it precedes the slot's other arrivals of the
// group: slots fill in stream order), looks up its family, then folds each
// filtered arrival in lane (stream) order under the family, so f32 sums
// add in the oracle's order.  A group goes out in one coalesced write.
template <typename T>
__global__ void __launch_bounds__(kFoldWarps * kWarp)
fold_emit(Geo g, Work w, Out<T> out) {
  __shared__ uint32_t pay[kFoldWarps][kWarp];   // the step's payload bits, by lane
  __shared__ int kept_idx[kFoldWarps][kWarp];   // the step's kept arrivals, by slot
  __shared__ int kept_pos[kFoldWarps][kWarp];
  __shared__ uint32_t kept_val[kFoldWarps][kWarp];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int parts = w.meta[kMetaParts], q = g.num_sets / parts, slots = g.slots;
  const int total = w.gkey[g.num_sets];
  for (int span = blockIdx.x * kFoldWarps + wid; span < total;
       span += gridDim.x * kFoldWarps) {
    int lo_k = 0, hi_k = g.num_sets;  // the last set key with gkey <= span
    while (hi_k - lo_k > 1) {
      const int mid = (lo_k + hi_k) / 2;
      if (w.gkey[mid] <= span) lo_k = mid; else hi_k = mid;
    }
    const int s = set_of_key(lo_k, q, parts);
    const int start = w.set_start[s], len = w.set_start[s + 1] - start, nf = w.nflush[s];
    const int g0 = (span - w.gkey[lo_k]) * kWarp, gn = min(kWarp, nf + 1 - g0);
    const int* gend = w.gend + start / slots;
    const uint2* b_iv = w.b_iv + start;
    const int* b_pos = w.b_pos + start;
    const uint8_t* code = w.code + start;
    int hi_l = 0, o_l = 0;  // group g0 + lane: its end and its first output slot
    if (lane < gn) {
      const int grp = g0 + lane;
      const Part pt = w.part[s % parts];
      if (grp < nf) {
        hi_l = slots == 1 ? grp + 1 : gend[grp];
        o_l = pt.front + w.rank[b_pos[hi_l - 1]] * slots;
      } else {
        hi_l = len;
        o_l = pt.front + pt.flushes * slots + w.drain_off[s];
      }
    }
    const int end = __shfl_sync(kFull, hi_l, gn - 1);  // the span's last arrival + 1
    int k0 = g0 == 0 ? 0 : slots == 1 ? g0 : gend[g0 - 1];
    auto load = [&](int k, int& c, uint2& iv, int& p) {
      if (k < end) {
        c = code[k];
        iv = b_iv[k];
        p = b_pos[k];
      }
    };
    int c = 0, p = 0;
    uint2 iv = make_uint2(0, 0);
    load(k0 + lane, c, iv, p);
    for (int gi = 0; gi < gn; ++gi) {
      const int hi = __shfl_sync(kFull, hi_l, gi);
      const long long o = __shfl_sync(kFull, o_l, gi);
      int r_idx = 0, r_pos = 0;  // slot `lane` of this group
      T r_val = T(0);
      bool r_add = false;
      for (; k0 < hi;) {
        const bool valid = k0 + lane < hi;
        const int nk0 = min(k0 + kWarp, hi);  // the next step: this group's, or the next one's
        int nc = 0, np = 0;
        uint2 niv = make_uint2(0, 0);
        load(nk0 + lane, nc, niv, np);
        const int slot = c & (kKeptCode - 1);
        const bool kept = valid && (c & kKeptCode);
        pay[wid][lane] = iv.y;
        if (kept) {
          kept_idx[wid][slot] = (int)iv.x;
          kept_pos[wid][slot] = p;
          kept_val[wid][slot] = iv.y;
        }
        const unsigned kmask = __ballot_sync(kFull, kept);
        // the step's arrivals of slot `lane`: one ballot a bit of the slot
        unsigned rest = __ballot_sync(kFull, valid);
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          const unsigned has = __ballot_sync(kFull, slot >> b & 1);
          rest &= lane >> b & 1 ? has : ~has;
        }
        __syncwarp();  // the shared copies are written before they are read
        if (rest & kmask) {  // the slot's kept arrival: the first of them
          r_idx = kept_idx[wid][lane];
          r_pos = kept_pos[wid][lane];
          r_val = from_bits<T>(kept_val[wid][lane]);
          r_add = g.tags[r_idx < 0 ? 0 : min(r_idx, g.ntags - 1)] != 0;
          rest &= rest - 1u;
        }
        for (; rest; rest &= rest - 1u)
          r_val = tagged_fold(r_val, from_bits<T>(pay[wid][__ffs(rest) - 1]), r_add);
        __syncwarp();  // the shared copies are read before the next step writes them
        k0 = nk0;
        c = nc;
        iv = niv;
        p = np;
      }
      const int kept = gi + g0 < nf ? slots : w.ndrain[s];
      if (lane < kept) {
        out.idx[o + lane] = r_idx;
        out.val[o + lane] = r_val;
        out.pos[o + lane] = r_pos;
        out.act[o + lane] = 1;
      }
    }
  }
}

// ------------------------------------------------------ round-cap fallback
// A capped partition is reordered as ref.dense_merge_ref does: its
// survivors are its runs' first lanes, at its front by (index, arrival),
// each with its run's payloads folded in stream order, and the other lanes
// are filtered, in the partition's tail in reverse stream order.  The
// sort (DigitBins) leaves the capped partitions' live lanes by (index,
// stream position); equal indices share a set, hence a partition, so a run
// is contiguous there whatever the partitions.

// One pass of the dense scan over the sorted lanes, for partitions [8 pass,
// 8 pass + W) of the layout's: persistent CTAs take 4096-lane tiles by
// ticket; warp v of a tile takes its 512 lanes as 16 rows of 32, lane l
// lane l of each row, so every load is coalesced.  A lane is its run's
// first when its index differs from the previous lane's (the lane to its
// left, or the previous row's last); each partition's firsts are counted
// (a decoupled look-back over W words), and one ballot a row and a
// partition ranks each first in its partition's front (srank).  The first
// pass also writes every sorted lane's mark (kept for a first, else
// filtered, and its partition) to its stream position, where the mark scan
// gives the filtered lanes their tail slots.  The last tile leaves each
// partition's survivors in dheads.  A pass zeroes the next pass's status
// words of its tiles (the buffers alternate).
template <int W>
__global__ void __launch_bounds__(kTileThreads)
dense_scan(Geo g, Work w, int pass) {
  __shared__ uint32_t warp_tot[kTileWarps][W];
  __shared__ unsigned long long excl[W];
  __shared__ long long tile_sh;
  constexpr int kRows = kTileItems;  // a warp's 512 lanes: 16 rows of 32
  const int parts = w.meta[kMetaParts], p0 = pass * kMarkWords;
  const long long nc = w.meta[kMetaDense];
  if (p0 >= parts || nc == 0) return;
  const int buf = sorted_buffer(w);
  const uint2* s_iv = w.s_iv[buf];
  const int* s_pos = w.s_pos[buf];
  const long long tiles = (nc + kTile - 1) / kTile;
  unsigned long long* st = w.dstat + (pass & 1) * w.mstride;
  unsigned long long* st_next = w.dstat + ((pass + 1) & 1) * w.mstride;
  const int tid = threadIdx.x, lane = tid % kWarp, wid = tid / kWarp;
  const unsigned below = (1u << lane) - 1u;
  for (;;) {
    if (tid == 0) tile_sh = atomicAdd(&w.tick[w.tick_dense + pass], 1);
    __syncthreads();
    const long long t = tile_sh;
    if (t >= tiles) break;
    if (tid < 2 * W) st_next[t * 2 * W + tid] = 0;
    const long long base = t * kTile + (long long)wid * (kRows * kWarp);
    int x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long j = base + i * kWarp + lane;
      x[i] = j < nc ? (int)s_iv[j].x : 0;
    }
    // the lane before the warp's first: the previous warp's (or tile's) last
    int before_first = lane == 0 && base > 0 && base <= nc ? (int)s_iv[base - 1].x : 0;
    unsigned first[kRows];  // per row, the ballot of its runs' first lanes
    int part[kRows];        // relative to p0
    uint32_t mine[W];
#pragma unroll
    for (int q = 0; q < W; ++q) mine[q] = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long j = base + i * kWarp + lane;
      int prev = __shfl_up_sync(kFull, x[i], 1);
      const int last = __shfl_sync(kFull, i ? x[i - 1] : before_first, kWarp - 1);
      if (lane == 0) prev = i ? last : before_first;
      const bool live = j < nc;
      const bool head = live && (j == 0 || x[i] != prev);
      first[i] = __ballot_sync(kFull, head);
      const int s = hash_set(x[i], g.epb, g.num_sets);
      part[i] = s % parts - p0;
      if (pass == 0 && live) w.mark[s_pos[j]] = (head ? kKept : kFiltered) | mark_part(s, g);
#pragma unroll
      for (int q = 0; q < W; ++q) mine[q] += head && part[i] == q ? 1u : 0u;
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const uint32_t c = __reduce_add_sync(kFull, mine[q]);
      if (lane == 0) warp_tot[wid][q] = c;
    }
    __syncthreads();
    if (wid == 0) {
      unsigned long long agg = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        uint32_t c = 0;
        for (int k = 0; k < kTileWarps; ++k) c += warp_tot[k][q];
        if (lane == q) agg = c;
      }
      tile_prefix<W>(st, t, agg, excl);
    }
    __syncthreads();
    int run[W];  // this warp's running counts, warp-uniform
#pragma unroll
    for (int q = 0; q < W; ++q) {
      uint32_t c = 0;
      for (int k = 0; k < wid; ++k) c += warp_tot[k][q];
      run[q] = (int)excl[q] + (int)c;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      int rank = 0;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const unsigned m = __ballot_sync(kFull, (first[i] >> lane & 1u) && part[i] == q);
        if (part[i] == q) rank = run[q] + __popc(m & below);
        run[q] += __popc(m);
      }
      if (first[i] >> lane & 1u && part[i] >= 0 && part[i] < W)
        w.srank[base + i * kWarp + lane] = rank;
    }
    if (t == tiles - 1 && tid < W && p0 + tid < parts) {
      uint32_t c = 0;
      for (int k = 0; k < kTileWarps; ++k) c += warp_tot[k][tid];
      w.dheads[p0 + tid] = (int)(excl[tid] + c);
    }
    __syncthreads();  // warp_tot, excl and tile_sh are read before the next tile
  }
}

// The capped partitions' survivors: warps stride over 32-lane steps of the
// sorted lanes, a step's (index, payload) words one coalesced load.  Each
// run that starts in the step (its first lane's index differs from the
// lane before) is folded by the whole warp in lane order, each payload
// shuffled to every lane, so every lane holds the same accumulator (the
// op, or, tagged, its index's family); a run that reaches the step's end
// goes on through the next steps, 32 lanes a load (the next load issued
// before the fold), until its index changes.  Its first lane writes the
// survivor at its rank in its partition's front.  The longest run
// (kron-20's hub: tens of thousands of lanes) is one warp's chain of adds,
// 32 of them a load.
template <typename T, int OP>
__global__ void __launch_bounds__(kEmitThreads)
dense_emit(Geo g, Work w, Out<T> out) {
  const long long nc = w.meta[kMetaDense];
  if (nc == 0) return;
  const int parts = w.meta[kMetaParts];
  const int buf = sorted_buffer(w);
  const uint2* s_iv = w.s_iv[buf];
  const int lane = threadIdx.x % kWarp;
  const long long steps = (nc + kWarp - 1) / kWarp;
  const long long warps = (long long)gridDim.x * (kEmitThreads / kWarp);
  auto load = [&](long long j) { return j < nc ? s_iv[j] : make_uint2(0u, 0u); };
  for (long long step = (long long)blockIdx.x * (kEmitThreads / kWarp) + threadIdx.x / kWarp;
       step < steps; step += warps) {
    const long long j0 = step * kWarp;
    const uint2 a = load(j0 + lane);
    uint32_t prev = __shfl_up_sync(kFull, a.x, 1);
    if (lane == 0) prev = j0 > 0 ? s_iv[j0 - 1].x : ~a.x;
    const int valid = (int)min((long long)kWarp, nc - j0);  // lanes of the step
    const unsigned heads = __ballot_sync(kFull, lane < valid && a.x != prev);
    for (unsigned hm = heads; hm; hm &= hm - 1) {
      const int h = __ffs(hm) - 1;
      const uint32_t x = __shfl_sync(kFull, a.x, h);
      const bool add = OP == kTagged && add_family(g.tags, g.ntags, (int)x);
      T acc = from_bits<T>(__shfl_sync(kFull, a.y, h));
      const unsigned later = hm & (hm - 1);
      const int end = later ? __ffs(later) - 1 : valid;  // the run's lanes of this step: [h, end)
      for (int u = h + 1; u < end; ++u)
        acc = fold_one<T, OP>(acc, from_bits<T>(__shfl_sync(kFull, a.y, u)), add);
      if (!later && valid == kWarp) {  // it may go on past the step
        long long k = j0 + kWarp;
        uint2 b = load(k + lane);
        for (;;) {
          const uint2 nb = load(k + kWarp + lane);  // in flight during the fold
          const unsigned same = __ballot_sync(kFull, k + lane < nc && b.x == x);
          const int len = ~same ? __ffs(~same) - 1 : kWarp;  // the run's leading lanes
          if (len == kWarp) {
#pragma unroll
            for (int u = 0; u < kWarp; ++u)
              acc = fold_one<T, OP>(acc, from_bits<T>(__shfl_sync(kFull, b.y, u)), add);
          } else {
            for (int u = 0; u < len; ++u)
              acc = fold_one<T, OP>(acc, from_bits<T>(__shfl_sync(kFull, b.y, u)), add);
            break;
          }
          k += kWarp;
          b = nb;
        }
      }
      if (lane == h) {
        const long long j = j0 + h;
        const long long o =
            w.part[hash_set((int)x, g.epb, g.num_sets) % parts].front + (long long)w.srank[j];
        out.idx[o] = (int)x;
        out.val[o] = acc;
        out.pos[o] = w.s_pos[buf][j];
        out.act[o] = 1;
      }
    }
  }
}

// ------------------------------------------------------------------ launch
int sm_count() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1)
      return 132;
    cached[dev] = sms;
  }
  return cached[dev];
}

// blocks of a persistent grid: as many as reside on the card, at most `want`
template <class K>
int persistent(K kernel, int threads, long long smem, long long want, unsigned& grid) {
  int per_sm = 0;
  const int e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                   (size_t)smem);
  if (e) return e;
  grid = (unsigned)std::max(1LL, std::min(want, (long long)std::max(per_sm, 1) * sm_count()));
  return 0;
}

// the mark scan's passes, W partitions each (W: 1, 2, 4 or 8)
template <typename T, int W>
int mark_passes(const int* idx, const T* val, const int* n_live, const Work& w, Geo g,
                const Out<T>& out, cudaStream_t st) {
  unsigned grid;
  int e;
  if ((e = persistent(mark_scan<T, W>, kTileThreads, 0, (g.n + kTile - 1) / kTile, grid)))
    return e;
  for (int pass = 0; pass * kMarkWords < g.nparts; ++pass) {
    mark_scan<T, W><<<grid, kTileThreads, 0, st>>>(idx, val, n_live, g, w, out, pass);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

// One stable counting sort (count, scan, scatter) by the policy's key over
// `buckets` buckets and at most `chunks` chunks; `between` launches what
// runs between the scan and the scatter.
template <class B, class Between>
int bin(const B& b, int buckets, long long chunks, cudaStream_t st, const Between& between) {
  const int count_smem = kBinWarps * buckets * 4;  // above 48 KB past 3072 buckets
  int warps = kScatterMaxWarps;
  while (warps > 1 && scatter_smem(buckets, warps) > kMaxSmem) warps /= 2;
  const int smem = (int)scatter_smem(buckets, warps);
  int e;
  if ((e = (int)cudaFuncSetAttribute(bin_count<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     count_smem)) ||
      (e = (int)cudaFuncSetAttribute(bin_scatter<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem)))
    return e;
  unsigned grid;
  if ((e = persistent(bin_count<B>, kBinWarps * kWarp, count_smem,
                      (chunks + kBinWarps - 1) / kBinWarps, grid)))
    return e;
  bin_count<B><<<grid, kBinWarps * kWarp, count_smem, st>>>(b);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = persistent(hist_scan<B>, kTileThreads, 0, (chunks * buckets + kTile - 1) / kTile,
                      grid)))
    return e;
  hist_scan<B><<<grid, kTileThreads, 0, st>>>(b);
  if ((e = (int)cudaGetLastError()) || (e = between())) return e;
  if ((e = persistent(bin_scatter<B>, warps * kWarp, smem, chunks, grid))) return e;
  bin_scatter<B><<<grid, warps * kWarp, smem, st>>>(b);
  return (int)cudaGetLastError();
}

// the dense scan's passes, W partitions each (W: 1, 2, 4 or 8)
template <int W>
int dense_passes(const Work& w, Geo g, cudaStream_t st) {
  unsigned grid;
  int e;
  if ((e = persistent(dense_scan<W>, kTileThreads, 0, (g.n + kTile - 1) / kTile, grid))) return e;
  for (int pass = 0; pass * kMarkWords < g.nparts; ++pass) {
    dense_scan<W><<<grid, kTileThreads, 0, st>>>(g, w, pass);
    if ((e = (int)cudaGetLastError())) return e;
  }
  return 0;
}

template <typename T, int OP>
int run(const int* idx, const T* val, const int* n_live, const Out<T>& out, const Work& w, Geo g,
        cudaStream_t st) {
  constexpr bool kSplit = OP == kTagged;  // the tagged walk: a chain, then the folds
  const uint32_t* vbits = reinterpret_cast<const uint32_t*>(val);
  unsigned grid;
  int e;
  // binning; the bypass and the round cap are decided between its scan and
  // its scatter, which leaves the capped partitions' lanes out
  const SetBins sb{idx, vbits, n_live, g, w, 1};
  if ((e = bin(sb, g.num_sets, g.nchunks, st, [&]() {
         set_starts<<<(g.num_sets + 256) / 256, 256, 0, st>>>(n_live, g, w);
         decide<<<1, kScanThreads, 0, st>>>(n_live, g, w);
         return (int)cudaGetLastError();
       })))
    return e;
  // walk
  const unsigned walk_blocks = (g.num_sets + kWalkWarps - 1) / kWalkWarps;
  if constexpr (kSplit)
    chain<<<walk_blocks, kWalkWarps * kWarp, 0, st>>>(g, w);
  else
    walk<T, OP><<<walk_blocks, kWalkWarps * kWarp, 0, st>>>(g, w);
  if ((e = (int)cudaGetLastError())) return e;
  // the round-cap fallback: the capped partitions' lanes sorted by (index,
  // stream position), their runs' firsts ranked and every lane marked
  if constexpr (OP != kNone) {
    if (w.capped) {
      for (int pass = 0; pass < kSortPasses; ++pass) {
        const DigitBins db{idx, vbits, n_live, g, w, pass, 1, 0, 0};
        if ((e = bin(db, kSortBuckets, g.nchunks, st, []() { return 0; }))) return e;
      }
      e = g.nparts == 1   ? dense_passes<1>(w, g, st)
          : g.nparts == 2 ? dense_passes<2>(w, g, st)
          : g.nparts <= 4 ? dense_passes<4>(w, g, st)
                          : dense_passes<8>(w, g, st);
      if (e) return e;
    }
  }
  finalize<<<1, kScanThreads, 0, st>>>(n_live, g, w);
  if ((e = (int)cudaGetLastError())) return e;
  // emit: the mark scan, the dead lanes, the kept entries, the fallback's survivors
  e = g.nparts == 1   ? mark_passes<T, 1>(idx, val, n_live, w, g, out, st)
      : g.nparts == 2 ? mark_passes<T, 2>(idx, val, n_live, w, g, out, st)
      : g.nparts <= 4 ? mark_passes<T, 4>(idx, val, n_live, w, g, out, st)
                      : mark_passes<T, 8>(idx, val, n_live, w, g, out, st);
  if (e) return e;
  if ((e = persistent(copy_dead<T>, kTileThreads, 0, (g.n + 4 * kTileThreads - 1) /
                                                         (4 * kTileThreads), grid)))
    return e;
  copy_dead<T><<<grid, kTileThreads, 0, st>>>(idx, val, n_live, g.n, w.meta, out);
  if ((e = (int)cudaGetLastError())) return e;
  if constexpr (kSplit) {
    const long long spans = g.n / g.slots / kWarp + g.num_sets;
    if ((e = persistent(fold_emit<T>, kFoldWarps * kWarp, 0,
                        (spans + kFoldWarps - 1) / kFoldWarps, grid)))
      return e;
    fold_emit<T><<<grid, kFoldWarps * kWarp, 0, st>>>(g, w, out);
  } else {
    if ((e = persistent(emit_kept<T>, kEmitThreads, 0, (g.n + kEmitThreads - 1) / kEmitThreads,
                        grid)))
      return e;
    emit_kept<T><<<grid, kEmitThreads, 0, st>>>(n_live, g, w, out);
  }
  if constexpr (OP != kNone) {
    if (w.capped) {
      if ((e = (int)cudaGetLastError()) ||
          (e = persistent(dense_emit<T, OP>, kEmitThreads, 0,
                          (g.n + kEmitThreads - 1) / kEmitThreads, grid)))
        return e;
      dense_emit<T, OP><<<grid, kEmitThreads, 0, st>>>(g, w, out);
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_op(int op, const int* idx, const T* val, const int* n_live, const Out<T>& out,
           const Work& w, Geo g, cudaStream_t st) {
  switch (op) {
    case kNone: return run<T, kNone>(idx, val, n_live, out, w, g, st);
    case kAdd: return run<T, kAdd>(idx, val, n_live, out, w, g, st);
    case kMin: return run<T, kMin>(idx, val, n_live, out, w, g, st);
    case kMax: return run<T, kMax>(idx, val, n_live, out, w, g, st);
    case kTagged: return run<T, kTagged>(idx, val, n_live, out, w, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- windowed body
constexpr int kWinThreads = 512;
constexpr int kWinWarps = kWinThreads / kWarp;
constexpr int kWinWalkWarps = 8;   // warps with walk_set's scratch: the hot-set walkers
constexpr int kWinMaxRankers = kWinWarps;
constexpr int kMaxWindow = 8192;
constexpr int kWinMaxSets = 1 << 14;  // a lane's set key and its mark share 16 bits
// Half of an SM's 228 KB, less the 1 KB the card reserves for each block and
// 1 KB for the kernel's static shared memory: two windows reside on an SM.
constexpr long long kWinMaxSmem = 233472 / 2 - 2048;
// the stamped build's phases: load + histogram, binning, small-set walk,
// hot-set walk, fallback, scans, emission
constexpr int kWinPhases = 7;

// division of a non-negative int by d: a shift and a mask when d is a
// power of two, as the paper's geometry's are
struct Div {
  int d;
  int shift;  // log2(d), or -1
  __host__ __device__ static Div of(int d) {
    int shift = -1;
    for (int b = 0; b < 31; ++b)
      if (d == 1 << b) shift = b;
    return Div{d, shift};
  }
  __device__ __forceinline__ int div(int x) const { return shift >= 0 ? x >> shift : x / d; }
  __device__ __forceinline__ int mod(int x) const { return shift >= 0 ? x & (d - 1) : x % d; }
};

struct WinGeo {
  long long n;
  int w;
  int num_sets;
  int slots;
  int epb;
  int nparts;
  int round_cap;  // 0: none
  int epb_shift;  // log2(epb) when epb is a power of two, else -1
  int sets_pow2;  // num_sets is a power of two
  Div per_group;  // slots
  const uint8_t* tags;  // op = tagged: the family of each index (1 = add)
  int ntags;
};

// hash_set with the window's shortcuts: a shift for a power-of-two epb
// (an arithmetic shift floors, as the division does) and a mask for a
// power-of-two set count
__device__ __forceinline__ int win_hash(int idx, const WinGeo& g) {
  int q;
  if (g.epb_shift >= 0) {
    q = idx >> g.epb_shift;
  } else {
    q = idx / g.epb;
    if (idx % g.epb != 0 && idx < 0) --q;
  }
  unsigned h = (unsigned)q * 2654435761u;
  h ^= h >> 16;
  return (int)(g.sets_pow2 ? h & (unsigned)(g.num_sets - 1) : h % (unsigned)g.num_sets);
}

// the stamped build: every CTA's clock64() at each phase boundary, after a
// block barrier, into stamps[window][kWinPhases + 1]; compiled out otherwise
template <bool STAMP>
__device__ __forceinline__ void win_stamp(long long* stamps, int at) {
  if (!STAMP) return;
  __syncthreads();
  if (threadIdx.x == 0) stamps[(long long)blockIdx.x * (kWinPhases + 1) + at] = clock64();
}

// Shared memory of one window's CTA.  A lane's aux word is its set's key in
// partition-major order shifted left by 2 over its mark (kKept, kTrigger,
// kFiltered); before the scatter it holds the lane's set, and after the mark
// scan a trigger's holds its flush rank within its partition.  Region R
// holds the binning's counters, then the walk's per-set arrays and scratch.
struct WinSmem {
  int* s_idx;           // [w] the window's live lanes
  uint32_t* s_val;      // [w] payload bits; a kept lane's merged payload after the walk
  uint16_t* order;      // [w] binned order: lanes by (set key, stream); a set's kept entries
                        //     are put over its consumed arrivals
  uint16_t* aux;        // [w] by lane, see above
  uint16_t* start;      // [num_sets + 1] first binned slot, by set key
  // R, binning: live arrivals by set, then each ranking warp's counters by set
  uint16_t* cnt;        // [num_sets]
  uint16_t* rank;       // [rankers][num_sets]
  // R, walk and after: by set key
  uint16_t* nflush;     // [num_sets] flush groups
  uint16_t* ndrain;     // [num_sets] drain group size
  uint16_t* drain_off;  // [num_sets] drain offset within the partition
  uint16_t* hot;        // [num_sets] the sets walked by walk_set
  uint32_t* walk;       // [kWinWalkWarps][5][kWarp] walk_set's shared copies
  int* pc;              // [nparts + 1] live lanes, by partition
  int* dense;           // [nparts + 1] 1: the partition takes the round-cap fallback
  int* heads;           // [nparts + 1] a capped partition's survivors
  int* pfront;          // [nparts + 1] a partition's first front slot
  int* ptail;           // [nparts + 1] a partition's first tail slot
  int* pfilt;           // [nparts + 1] a partition's filtered lanes
  int* phead;           // [nparts + 1] capped partitions' survivors before the partition
  int* pd;              // [nparts + 1] drain prefix at a partition's first set
  int* pf;              // [nparts + 1] flush prefix at a partition's first set
  int rankers;          // warps that rank the binning, one stretch of lanes each
};

__host__ __device__ inline unsigned char* smem_take(unsigned char* base, long long& off,
                                                    long long bytes) {
  unsigned char* p = base ? base + off : nullptr;
  off += (bytes + 15) / 16 * 16;
  return p;
}

__host__ __device__ inline long long win_carve(unsigned char* b, int w, int num_sets, int nparts,
                                               WinSmem* sm) {
  long long off = 0;
  WinSmem v;
  v.s_idx = (int*)smem_take(b, off, 4LL * w);
  v.s_val = (uint32_t*)smem_take(b, off, 4LL * w);
  v.order = (uint16_t*)smem_take(b, off, 2LL * w);
  v.aux = (uint16_t*)smem_take(b, off, 2LL * w);
  v.start = (uint16_t*)smem_take(b, off, 2LL * (num_sets + 1));
  const long long per_set = (2LL * num_sets + 15) / 16 * 16;
  const long long r_bytes = 4 * per_set + 4LL * kWinWalkWarps * 5 * kWarp;
  unsigned char* r = smem_take(b, off, r_bytes);
  uint16_t** walk_sets[] = {&v.nflush, &v.ndrain, &v.drain_off, &v.hot};
  for (int i = 0; i < 4; ++i) *walk_sets[i] = r ? (uint16_t*)(r + i * per_set) : nullptr;
  v.walk = r ? (uint32_t*)(r + 4 * per_set) : nullptr;
  // the ranking warps' counters: in the payload region (payloads load
  // after the binning) or in R after cnt, whichever holds more warps
  v.cnt = (uint16_t*)r;
  const long long in_val = 4LL * w / (2LL * num_sets);
  const long long in_r = (r_bytes - per_set) / (2LL * num_sets);
  const long long rankers = in_val > in_r ? in_val : in_r;
  v.rankers = (int)(rankers < kWinMaxRankers ? rankers : kWinMaxRankers);
  v.rank = in_val > in_r ? (uint16_t*)v.s_val : r ? (uint16_t*)(r + per_set) : nullptr;
  int** per_part[] = {&v.pc,    &v.dense, &v.heads, &v.pfront, &v.ptail,
                      &v.pfilt, &v.phead, &v.pd,    &v.pf};
  for (int** a : per_part) *a = (int*)smem_take(b, off, 4LL * (nparts + 1));
  if (sm) *sm = v;
  return off;
}

// ascending sort of the lanes a[0, n), any n, by (index, lane), one block:
// the bitonic network whose first step of each merge compares mirrored
// pairs, so that every comparator is ascending and the padding past n
// (larger than every lane) never moves; the caller synchronises before
__device__ void sort_lanes_by_index(uint16_t* a, int n, const int* s_idx) {
  auto swap_if = [&](int lo, int hi) {
    if (hi >= n) return;
    const int x = a[lo], y = a[hi], ix = s_idx[x], iy = s_idx[y];
    if (ix > iy || (ix == iy && x > y)) {
      a[lo] = (uint16_t)y;
      a[hi] = (uint16_t)x;
    }
  };
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
      const int lo = i / (k / 2) * k + i % (k / 2);
      swap_if(lo, lo ^ (k - 1));
    }
    __syncthreads();
    for (int j = k >> 2; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1));
        swap_if(lo, lo + j);
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// walk_set's view of one hot set of a window: its arrivals are the binned
// order's lanes; a kept entry's lane is put at its kept slot (over an
// arrival already loaded) and its merged payload over its own
struct WindowSet {
  static constexpr bool kMarkAll = false;  // the binning marked every lane kept
  const int* s_idx;
  uint32_t* s_val;
  uint16_t* order;
  uint16_t* aux;
  int start;
  int key;
  const uint8_t* tags;
  int ntags;
  __device__ bool family(int x) const { return add_family(tags, ntags, x); }
  __device__ void load(int k, uint2& iv, int& pos) const {
    pos = order[start + k];
    iv = make_uint2((uint32_t)s_idx[pos], s_val[pos]);
  }
  __device__ void put(int q, int, uint32_t bits, int pos) const {
    order[start + q] = (uint16_t)pos;
    s_val[pos] = bits;
  }
  __device__ void mark(int pos, uint8_t kind) const { aux[pos] = (uint16_t)(key << 2 | kind); }
};

// the position of the (n+1)-th set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// One warp walks the small sets (1 to `slots` arrivals, in a hash
// partition) among the keys [k0, k0 + 32), several sets a step: a step takes
// the next pending sets whose arrivals fit in 32 lanes, lane l one arrival.
// A small set fills at most once, at its last arrival, so one round is its
// whole walk: an arrival is kept if no earlier arrival has its index
// (__match_any_sync; an index has one set), else it is filtered and its
// first arrival folds it, in lane (stream) order.  The kept entries are put
// in arrival order over the set's arrivals; the set flushes when all
// `slots` are kept, the last one the trigger, else it drains.
template <typename T, int OP>
__device__ void walk_small_sets(const WinSmem& sm, const WinGeo& g, int k0, const Div& qdiv) {
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  const int key = k0 + lane;
  int st = 0, len = 0;
  if (key < g.num_sets) {
    st = sm.start[key];
    len = sm.start[key + 1] - st;
  }
  const bool small = len > 0 && len <= g.slots && !sm.dense[qdiv.div(key)];
  unsigned pending = __ballot_sync(kFull, small);
  int upto_me = small ? len : 0;  // the chunk's small sets' arrivals up to mine
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, upto_me, off);
    if (lane >= off) upto_me += y;
  }
  int done = 0;  // arrivals of the sets already walked
  while (pending) {
    // lanes the pending sets take, the first pending set first
    const int c = upto_me - done;
    const unsigned take = __ballot_sync(kFull, (pending >> lane & 1u) && c <= kWarp);
    pending &= ~take;
    done = __shfl_sync(kFull, upto_me, 31 - __clz(take));
    // bit e of ends: a taken set's last arrival is at lane e
    const unsigned ends =
        __reduce_or_sync(kFull, (take >> lane & 1u) ? 1u << (c - 1) : 0u);
    const bool valid = lane < 32 - __clz(ends);
    const unsigned ends_below = ends & below;
    const int first = ends_below ? 32 - __clz(ends_below) : 0;  // my set's first lane
    const int last = __ffs(ends & ~below) - 1;                   // and its last
    const int src = valid ? nth_bit(take, __popc(ends_below)) : 0;
    const int set_st = __shfl_sync(kFull, st, src);
    const int set_key = k0 + src;
    const unsigned in_set = valid ? upto(last) & ~((1u << first) - 1u) : 0u;
    const int ln = valid ? sm.order[set_st + lane - first] : 0;
    const int x = valid ? sm.s_idx[ln] : 0;
    const uint32_t vb = valid ? sm.s_val[ln] : 0u;
    const unsigned peers = OP != kNone ? __match_any_sync(kFull, x) & in_set : 1u << lane;
    const bool kept = valid && (peers & below) == 0;
    const unsigned kmask = __ballot_sync(kFull, kept);
    const int rank = __popc(kmask & in_set & below);
    const int nk = __popc(kmask & in_set);
    T acc = from_bits<T>(vb);
    if (OP != kNone) {  // the first arrival of an index folds the rest, in lane order
      unsigned rest = kept ? peers & ~(1u << lane) : 0u;
      const bool add = OP == kTagged && rest && add_family(g.tags, g.ntags, x);
      while (__any_sync(kFull, rest != 0)) {
        const int d = rest ? __ffs(rest) - 1 : lane;
        const uint32_t b = __shfl_sync(kFull, vb, d);
        if (rest) {
          acc = fold_one<T, OP>(acc, from_bits<T>(b), add);
          rest &= rest - 1u;
        }
      }
    }
    __syncwarp();  // the arrivals are read before the kept entries are put
    if (valid) {
      const bool flush = nk == g.slots;
      if (kept) {
        sm.order[set_st + rank] = (uint16_t)ln;
        sm.s_val[ln] = to_bits(acc);
        if (flush && rank == g.slots - 1) sm.aux[ln] = (uint16_t)(set_key << 2 | kTrigger);
      } else {
        sm.aux[ln] = (uint16_t)(set_key << 2 | kFiltered);
      }
      if (lane == first) {
        sm.nflush[set_key] = flush ? 1 : 0;
        sm.ndrain[set_key] = (uint16_t)(flush ? 0 : nk);
      }
    }
    __syncwarp();
  }
}

// A lane's contribution to the mark scan's packed counters of partitions
// p0..p0+3: word p - p0 counts triggers in its low 16 bits and filtered
// lanes in its high 16 (a window's counts stay below 2^16).  A marked
// lane's partition comes from its index: an earlier pass may have put its
// rank or tail slot in its aux word.
struct MarkCounts {
  uint32_t c[4];
};

__device__ __forceinline__ MarkCounts mark_zero() { return MarkCounts{{0u, 0u, 0u, 0u}}; }

__device__ __forceinline__ void mark_add(MarkCounts& m, int p, uint32_t inc) {
  m.c[0] += p == 0 ? inc : 0u;
  m.c[1] += p == 1 ? inc : 0u;
  m.c[2] += p == 2 ? inc : 0u;
  m.c[3] += p == 3 ? inc : 0u;
}

__device__ __forceinline__ uint32_t mark_get(const MarkCounts& m, int p) {
  return p == 0 ? m.c[0] : p == 1 ? m.c[1] : p == 2 ? m.c[2] : m.c[3];
}

__device__ __forceinline__ MarkCounts mark_sum(MarkCounts a, const MarkCounts& b) {
  for (int i = 0; i < 4; ++i) a.c[i] += b.c[i];
  return a;
}

__device__ __forceinline__ MarkCounts mark_shfl_up(const MarkCounts& m, int off) {
  MarkCounts r;
  for (int i = 0; i < 4; ++i) r.c[i] = __shfl_up_sync(kFull, m.c[i], off);
  return r;
}

// partition (relative to p0) and increment of lane j with aux word a, or
// inc 0 when it counts for none of p0..p0+3
__device__ __forceinline__ uint32_t mark_of(const WinSmem& sm, const WinGeo& g, int j, unsigned a,
                                            const Div& pdiv, int p0, int& p) {
  const unsigned mk = a & 3u;
  if (mk == kKept) return 0u;
  p = pdiv.mod(win_hash(sm.s_idx[j], g));
  p -= p0;
  if (p < 0 || p >= 4) return 0u;
  return mk == kTrigger ? 1u : 0x10000u;
}

// One CTA per window of g.w lanes (the last one ragged).  The result of a
// window equals ragged_oracle(hash_reorder_ref_banked, ...) of ref.py on it
// (round_cap included), positions offset by the window's start.
template <typename T, int OP, bool STAMP>
__global__ void __launch_bounds__(kWinThreads, 2)
win_reorder(const int* __restrict__ idx, const uint32_t* __restrict__ val, const int* n_live,
            WinGeo g, int* out_idx, uint32_t* out_val, int* out_pos, uint8_t* out_act,
            long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int parts_sh, any_dense, nhot, hot_q, small_q, survivors_sh;
  __shared__ MarkCounts warp_marks[kWinWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, wid = tid / kWarp;
  const long long base = (long long)blockIdx.x * g.w;
  const int span = (int)min((long long)g.w, g.n - base);
  const int m = (int)max(0LL, min((long long)span, live_count(n_live, g.n) - base));
  win_stamp<STAMP>(stamps, 0);
  if (m == 0) {  // a dead window is the identity layout
    for (int ph = 1; ph <= kWinPhases; ++ph) win_stamp<STAMP>(stamps, ph);
    for (int j = tid; j < span; j += kWinThreads) {
      out_idx[base + j] = idx[base + j];
      out_val[base + j] = val[base + j];
      out_pos[base + j] = (int)(base + j);
      out_act[base + j] = 0;
    }
    return;
  }
  WinSmem sm;
  win_carve(smem, g.w, g.num_sets, g.nparts, &sm);
  const int S = g.num_sets, P = g.nparts, G = sm.rankers;
  // ---- load + histogram: warp w < G loads its stretch of the window
  // (whole 32-lane steps, eight loads in flight a thread) and counts its
  // lanes' sets into its own 16-bit counters (shared atomics)
  const int per = ((m + G - 1) / G + kWarp - 1) / kWarp * kWarp;  // lanes a stretch
  const int r0 = wid * per, r1 = min(m, r0 + per);                  // this warp's
  for (int i = tid; i < (G * S + 1) / 2; i += kWinThreads)
    reinterpret_cast<uint32_t*>(sm.rank)[i] = 0;
  for (int p = tid; p <= P; p += kWinThreads) sm.pc[p] = sm.dense[p] = sm.heads[p] = 0;
  if (tid == 0) any_dense = nhot = hot_q = small_q = 0;
  __syncthreads();
  constexpr int kLoads = 8;
  if (wid < G) {
    for (int jb = r0; jb < r1; jb += kLoads * kWarp) {
      int x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = jb + u * kWarp + lane;
        x[u] = j < r1 ? idx[base + j] : 0;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = jb + u * kWarp + lane;
        if (j >= r1) break;
        const int s = win_hash(x[u], g);
        sm.s_idx[j] = x[u];
        sm.aux[j] = (uint16_t)s;
        const int c = wid * S + s;  // the 16-bit counter, in its 32-bit word
        atomicAdd(reinterpret_cast<uint32_t*>(sm.rank) + c / 2, 1u << (16 * (c % 2)));
      }
    }
  }
  __syncthreads();
  for (int s0 = wid * kWarp; s0 < S; s0 += kWinThreads) {  // per-set and per-partition counts
    const int s = s0 + lane;
    int c = 0;  // the set's lanes; each stretch's counter becomes its first
    if (s < S) {  // rank in the set
      for (int r = 0; r < G; ++r) {
        const int n = sm.rank[r * S + s];
        sm.rank[r * S + s] = (uint16_t)c;
        c += n;
      }
      sm.cnt[s] = (uint16_t)c;
    }
    const int p = s < S ? s % P : P;
    const unsigned peers = __match_any_sync(kFull, p);
    const int sum = __reduce_add_sync(peers, c);
    if (p < P && sum && lane == __ffs(peers) - 1) atomicAdd(&sm.pc[p], sum);
  }
  __syncthreads();
  if (tid == 0) {  // the bank bypass: the window laid out as one partition
    int parts = P, worst = 0;
    for (int p = 0; p < P; ++p) worst = max(worst, sm.pc[p]);
    if (P > 1 && worst > partition_capacity(m, P)) parts = 1;
    parts_sh = parts;
  }
  __syncthreads();
  const int parts = parts_sh, q = S / parts;
  const Div pdiv = Div::of(parts), qdiv = Div::of(q);
  if (OP != kNone && g.round_cap > 0) {  // the round-cap fallback, by partition
    const long long most = (long long)g.round_cap * g.slots;
    for (int s = tid; s < S; s += kWinThreads)
      if (sm.cnt[s] > most) {
        sm.dense[pdiv.mod(s)] = 1;
        any_dense = 1;
      }
  }
  __syncthreads();
  win_stamp<STAMP>(stamps, 1);
  // ---- binning: a stable counting sort by set key.  Each set's first
  // slot (a scan over the set keys); then a warp a stretch places its
  // lanes in stream order after the earlier stretches' lanes of their set,
  // ranked within a 32-lane step by __match_any_sync.
  stretch_scan<kWinThreads>(
      S, [&](int k) { return make_int2(sm.cnt[qdiv.mod(k) * parts + qdiv.div(k)], 0); },
      [&](int k, int2 before, int2) { sm.start[k] = (uint16_t)before.x; });
  if (tid == 0) sm.start[S] = (uint16_t)m;
  // the payloads go where the counters may lie: loaded now, stored after
  constexpr int kPerThread = kMaxWindow / kWinThreads;
  uint32_t v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = tid + u * kWinThreads;
    v[u] = j < m ? val[base + j] : 0u;
  }
  __syncthreads();
  if (wid < G) {
    uint16_t* rc = sm.rank + wid * S;
    for (int j0 = r0; j0 < r1; j0 += kWarp) {
      const int j = j0 + lane;
      const int s = j < r1 ? sm.aux[j] : S;
      const unsigned peers = __match_any_sync(kFull, s);
      const int before = __popc(peers & ((1u << lane) - 1u));
      if (s < S) {
        const int k = pdiv.mod(s) * q + pdiv.div(s);
        sm.order[sm.start[k] + rc[s] + before] = (uint16_t)j;
        sm.aux[j] = (uint16_t)(k << 2);
      }
      __syncwarp();
      if (s < S && before == 0) rc[s] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = tid + u * kWinThreads;
    if (j < m) sm.s_val[j] = v[u];
  }
  for (int k = tid; k < S; k += kWinThreads) {  // R now holds the walk's arrays
    sm.nflush[k] = sm.ndrain[k] = 0;
    if (sm.start[k + 1] - sm.start[k] > g.slots && !sm.dense[qdiv.div(k)])
      sm.hot[atomicAdd(&nhot, 1)] = k;
  }
  if (any_dense)  // a capped partition's lanes by (index, lane)
    for (int p = 0; p < parts; ++p)
      if (sm.dense[p])
        sort_lanes_by_index(sm.order + sm.start[p * q], sm.start[(p + 1) * q] - sm.start[p * q],
                            sm.s_idx);
  __syncthreads();
  win_stamp<STAMP>(stamps, 2);
  // ---- walk the hash partitions' sets: the hot ones (past `slots`
  // arrivals) by walk_set, a warp each, first, since the longest set bounds
  // the window; the small ones a chunk of 32 set keys a warp
  auto walk_hot = [&]() {
    if (wid >= kWinWalkWarps) return;
    uint32_t* ws = sm.walk + wid * 5 * kWarp;
    const WalkScratch sh{ws, (int*)ws + kWarp, (int*)ws + 2 * kWarp, (int*)ws + 3 * kWarp,
                         (int*)ws + 4 * kWarp};
    for (;;) {
      int i = lane == 0 ? atomicAdd(&hot_q, 1) : 0;
      i = __shfl_sync(kFull, i, 0);
      if (i >= nhot) break;
      const int k = sm.hot[i];
      const WindowSet src{sm.s_idx, sm.s_val, sm.order, sm.aux, sm.start[k], k, g.tags, g.ntags};
      int drained;
      const int flushes =
          walk_set<T, OP>(src, sm.start[k + 1] - sm.start[k], g.slots, sh, drained);
      if (lane == 0) {
        sm.nflush[k] = (uint16_t)flushes;
        sm.ndrain[k] = (uint16_t)drained;
      }
    }
  };
  auto walk_small = [&]() {
    for (;;) {
      int c = lane == 0 ? atomicAdd(&small_q, 1) : 0;
      c = __shfl_sync(kFull, c, 0);
      if (c * kWarp >= S) break;
      walk_small_sets<T, OP>(sm, g, c * kWarp, qdiv);
    }
  };
  if (STAMP) {
    walk_small();
    win_stamp<STAMP>(stamps, 3);
    walk_hot();
  } else {
    walk_hot();
    walk_small();
  }
  __syncthreads();
  win_stamp<STAMP>(stamps, 4);
  // ---- a capped partition (ref.dense_merge_ref): each run of equal
  // indices folds into its first lane, in stream order
  if (any_dense) {
    for (int p = 0; p < parts; ++p) {
      if (!sm.dense[p]) continue;
      const int lo = sm.start[p * q], hi = sm.start[(p + 1) * q];
      for (int r = lo + tid; r < hi; r += kWinThreads) {
        const int ln = sm.order[r], x = sm.s_idx[ln];
        if (r > lo && sm.s_idx[sm.order[r - 1]] == x) continue;
        atomicAdd(&sm.heads[p], 1);
        T acc = from_bits<T>(sm.s_val[ln]);
        const bool add = OP == kTagged && add_family(g.tags, g.ntags, x);
        for (int r2 = r + 1; r2 < hi; ++r2) {
          const int d = sm.order[r2];
          if (sm.s_idx[d] != x) break;
          sm.aux[d] |= kFiltered;
          acc = fold_one<T, OP>(acc, from_bits<T>(sm.s_val[d]), add);
        }
        sm.s_val[ln] = to_bits(acc);
      }
    }
  }
  __syncthreads();
  win_stamp<STAMP>(stamps, 5);
  // ---- scans.  Drain offsets within each partition, and the partitions'
  // fronts and tails
  const int2 tot = stretch_scan<kWinThreads>(
      S,
      [&](int k) {
        return sm.dense[qdiv.div(k)] ? make_int2(0, 0) : make_int2(sm.ndrain[k], sm.nflush[k]);
      },
      [&](int k, int2 before, int2) {
        sm.drain_off[k] = (uint16_t)before.x;
        if (qdiv.mod(k) == 0) {
          sm.pd[qdiv.div(k)] = before.x;
          sm.pf[qdiv.div(k)] = before.y;
        }
      });
  if (tid == 0) {
    sm.pd[parts] = tot.x;
    sm.pf[parts] = tot.y;
  }
  __syncthreads();
  for (int k = tid; k < S; k += kWinThreads) sm.drain_off[k] -= (uint16_t)sm.pd[qdiv.div(k)];
  if (tid == 0) {
    int survivors = 0;
    for (int p = 0; p < parts; ++p)
      survivors += sm.dense[p] ? sm.heads[p]
                               : (sm.pf[p + 1] - sm.pf[p]) * g.slots + sm.pd[p + 1] - sm.pd[p];
    int front = 0, tail = 0, heads = 0;
    for (int p = 0; p < parts; ++p) {
      const int lanes = parts == 1 ? m : sm.pc[p];
      const int kept = sm.dense[p]
                           ? sm.heads[p]
                           : (sm.pf[p + 1] - sm.pf[p]) * g.slots + sm.pd[p + 1] - sm.pd[p];
      sm.pfront[p] = front;
      sm.pfilt[p] = lanes - kept;
      sm.ptail[p] = tail;  // within the window's tail
      sm.phead[p] = heads;
      front += kept;
      tail += lanes - kept;
      heads += sm.dense[p] ? sm.heads[p] : 0;
    }
    survivors_sh = survivors;
  }
  __syncthreads();
  // a capped partition's survivors: its runs' first lanes, by index
  if (any_dense)
    for (int p = 0; p < parts; ++p) {
      if (!sm.dense[p]) continue;
      const int lo = sm.start[p * q];
      stretch_scan<kWinThreads>(
          sm.start[(p + 1) * q] - lo,
          [&](int r) {
            return make_int2(r == 0 || sm.s_idx[sm.order[lo + r - 1]] !=
                                           sm.s_idx[sm.order[lo + r]], 0);
          },
          [&](int r, int2 before, int2 x) {
            if (!x.x) return;
            const int ln = sm.order[lo + r];
            const long long o = base + sm.pfront[p] + before.x;
            out_idx[o] = sm.s_idx[ln];
            out_val[o] = sm.s_val[ln];
            out_pos[o] = (int)(base + ln);
            out_act[o] = 1;
          });
    }
  // One mark scan over the lanes in stream order for four partitions at a
  // time (one pass at the paper's geometry): each trigger's flush rank
  // within its partition, and each filtered lane's slot in the window's
  // tail (the first detected last), go to its aux word.  Warp w takes `rounds` runs of 256
  // lanes from lane 256 * rounds * w, a thread eight consecutive lanes a
  // run: one 16-byte load of aux words, a warp's loads on distinct banks.
  const int rounds = (m + kWinThreads * 8 - 1) / (kWinThreads * 8);  // 1 or 2
  for (int p0 = 0; p0 < parts; p0 += 4) {
    MarkCounts mine[2], incl[2], wtot = mark_zero();
#pragma unroll
    for (int rd = 0; rd < 2; ++rd) {
      mine[rd] = mark_zero();
      const int j = ((wid * rounds + rd) * kWarp + lane) * 8;
      if (rd < rounds && j < m) {
        const uint4 a4 = *reinterpret_cast<const uint4*>(sm.aux + j);
        const uint32_t words[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          int p;
          const uint32_t inc = j + i < m ? mark_of(sm, g, j + i, words[i / 2] >> (16 * (i % 2)) &
                                                   0xffffu, pdiv, p0, p)
                                         : 0u;
          if (inc) mark_add(mine[rd], p, inc);
        }
      }
      incl[rd] = mine[rd];
      for (int off = 1; off < kWarp; off <<= 1) {
        const MarkCounts y = mark_shfl_up(incl[rd], off);
        if (lane >= off) incl[rd] = mark_sum(incl[rd], y);
      }
      MarkCounts last;
      for (int i = 0; i < 4; ++i) last.c[i] = __shfl_sync(kFull, incl[rd].c[i], kWarp - 1);
      wtot = mark_sum(wtot, last);
    }
    if (lane == 0) warp_marks[wid] = wtot;
    __syncthreads();
    MarkCounts run;  // the earlier warps' total: every warp scans the totals
    {
      const MarkCounts mw = lane < kWinWarps ? warp_marks[lane] : mark_zero();
      MarkCounts iw = mw;
      for (int off = 1; off < kWinWarps; off <<= 1) {
        const MarkCounts y = mark_shfl_up(iw, off);
        if (lane >= off) iw = mark_sum(iw, y);
      }
      for (int i = 0; i < 4; ++i) run.c[i] = __shfl_sync(kFull, iw.c[i] - mw.c[i], wid);
    }
#pragma unroll
    for (int rd = 0; rd < 2; ++rd) {
      const int j = ((wid * rounds + rd) * kWarp + lane) * 8;
      if (rd < rounds && j < m) {
        MarkCounts at = run;  // this thread's exclusive prefix
        for (int i = 0; i < 4; ++i) at.c[i] += incl[rd].c[i] - mine[rd].c[i];
        const uint4 a4 = *reinterpret_cast<const uint4*>(sm.aux + j);
        const uint32_t words[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          int p;
          const int ln = j + i;
          const uint32_t inc = ln < m ? mark_of(sm, g, ln, words[i / 2] >> (16 * (i % 2)) &
                                                0xffffu, pdiv, p0, p)
                                      : 0u;
          if (!inc) continue;
          const uint32_t before = mark_get(at, p);
          const int rank = inc == 1u ? (int)(before & 0xffffu)
                                     : sm.ptail[p0 + p] + sm.pfilt[p0 + p] - 1 - (int)(before >> 16);
          sm.aux[ln] = (uint16_t)(rank << 2 | (inc == 1u ? kTrigger : kFiltered));
          mark_add(at, p, inc);
        }
      }
      MarkCounts last;
      for (int i = 0; i < 4; ++i) last.c[i] = __shfl_sync(kFull, incl[rd].c[i], kWarp - 1);
      run = mark_sum(run, last);
    }
    __syncthreads();  // warp_marks is read before the next pass writes it
  }
  win_stamp<STAMP>(stamps, 6);
  // ---- emission: the hash partitions' kept entries, one thread a binned
  // slot (a flush group's slots and a partition's drained slots are
  // consecutive, so consecutive threads write consecutive addresses)
  for (int r = tid; r < m; r += kWinThreads) {
    const int ln = sm.order[r];
    const unsigned a = sm.aux[ln];
    const unsigned mk = a & 3u;
    if (mk == kFiltered) continue;
    int p;
    long long o;
    if (mk == kTrigger) {  // the last entry of its flush group; a
      // consumed arrival's slot may hold it too, and writes the same
      int lo = 0, hi = parts;  // the partition whose binned slots hold r
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (sm.start[mid * q] <= r) lo = mid; else hi = mid;
      }
      p = lo;
      o = sm.pfront[p] + (long long)(a >> 2) * g.slots + g.slots - 1;
    } else {
      const int k = (int)(a >> 2);
      p = qdiv.div(k);
      if (sm.dense[p]) continue;
      const int st = sm.start[k], local = r - st, nf = sm.nflush[k] * g.slots;
      if (local < nf) {
        const int grp = g.per_group.div(local);
        const int trig = sm.order[st + grp * g.slots + g.slots - 1];
        o = sm.pfront[p] + (long long)(sm.aux[trig] >> 2) * g.slots + (local - grp * g.slots);
      } else if (local < nf + sm.ndrain[k]) {
        o = sm.pfront[p] + (long long)(sm.pf[p + 1] - sm.pf[p]) * g.slots + sm.drain_off[k] +
            (local - nf);
      } else {
        continue;  // a consumed arrival past the set's kept entries
      }
    }
    out_idx[base + o] = sm.s_idx[ln];
    out_val[base + o] = sm.s_val[ln];
    out_pos[base + o] = (int)(base + ln);
    out_act[base + o] = 1;
  }
  // the filtered lanes, staged by tail slot in the binned order's place,
  // then the dead lanes and the tail in one contiguous pass
  __syncthreads();
  for (int j = tid; j < m; j += kWinThreads) {
    const unsigned a = sm.aux[j];
    if ((a & 3u) == kFiltered) sm.order[a >> 2] = (uint16_t)j;
  }
  __syncthreads();
  for (int o = survivors_sh + tid; o < span; o += kWinThreads) {
    const int t = o - survivors_sh - (span - m);  // < 0: a dead lane
    const int j = t < 0 ? m + (o - survivors_sh) : sm.order[t];
    out_idx[base + o] = t < 0 ? idx[base + j] : sm.s_idx[j];
    out_val[base + o] = t < 0 ? val[base + j] : sm.s_val[j];
    out_pos[base + o] = (int)(base + j);
    out_act[base + o] = 0;
  }
  win_stamp<STAMP>(stamps, 7);
}

long long win_smem(int w, int num_sets, int nparts) {
  if (num_sets > kWinMaxSets) return LLONG_MAX;  // a set key must fit beside the mark
  return win_carve(nullptr, w, num_sets, nparts, nullptr);
}

// One launch of the windowed body; with `stamps` (windows x (kWinPhases +
// 1) int64 on the device) its stamped build, else `occupancy` (when not
// null) takes the CTAs resident per SM and nothing launches.
template <typename T, int OP>
int win_one(const int* idx, const uint32_t* val, const int* n_live, WinGeo g, int* out_idx,
            uint32_t* out_val, int* out_pos, uint8_t* out_act, long long* stamps,
            int* occupancy, cudaStream_t st) {
  const long long smem = win_smem(g.w, g.num_sets, g.nparts);
  auto kernel = stamps ? win_reorder<T, OP, true> : win_reorder<T, OP, false>;
  int e;
  if ((e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem)))
    return e;
  if (occupancy)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kWinThreads,
                                                              (size_t)smem);
  const long long windows = (g.n + g.w - 1) / g.w;
  kernel<<<(unsigned)windows, kWinThreads, (size_t)smem, st>>>(idx, val, n_live, g, out_idx,
                                                               out_val, out_pos, out_act, stamps);
  return (int)cudaGetLastError();
}

template <typename T>
int win_launch(int op, const int* idx, const uint32_t* val, const int* n_live, WinGeo g,
               int* out_idx, uint32_t* out_val, int* out_pos, uint8_t* out_act,
               long long* stamps, int* occupancy, cudaStream_t st) {
  switch (op) {
#define WIN_CASE(OP)                                                                        \
  case OP:                                                                                  \
    return win_one<T, OP>(idx, val, n_live, g, out_idx, out_val, out_pos, out_act, stamps, \
                          occupancy, st);
    WIN_CASE(kNone)
    WIN_CASE(kAdd)
    WIN_CASE(kMin)
    WIN_CASE(kMax)
    WIN_CASE(kTagged)
#undef WIN_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int iru_hash_reorder_max_sets(void) { return kMaxSets; }

// the revision of this interface: 2 gave iru_hash_reorder its round_cap and
// the windowed entries their tag table
int iru_reorder_abi(void) { return 2; }

// bytes of the workspace iru_hash_reorder needs for n lanes, num_sets sets,
// nparts partitions and a round cap (0: none; pass 0 without a merge)
long long iru_hash_reorder_workspace(long long n, int num_sets, int nparts, int round_cap) {
  return carve(nullptr, n, num_sets, nparts, round_cap > 0, nullptr);
}

// dtype: 0 = float32, 1 = int32; op: 0 = none, 1 = add, 2 = min, 3 = max,
// 4 = tagged (tag_table: ntags bytes on the device, nonzero = the add family;
// null for other ops).  nparts: partitions (num_sets % nparts == 0).
// round_cap: 0 for none (a cap takes effect with a merge only; the
// workspace must be sized with the same cap).  n_live: device pointer to
// one int32, or null for a padded stream.  Returns a cudaError_t code (0
// on success).
int iru_hash_reorder(const int* idx, const void* val, const int* n_live, const uint8_t* tag_table,
                     int ntags, int* out_idx, void* out_val, int* out_pos, uint8_t* out_act,
                     void* workspace, long long n, int num_sets, int slots, int epb, int nparts,
                     int round_cap, int dtype, int op, void* stream) {
  if (n <= 0) return 0;
  if (n >= INT_MAX || num_sets < 1 || num_sets > kMaxSets || slots < 1 || slots > kWarp ||
      epb < 1 || nparts < 1 || num_sets % nparts != 0 || round_cap < 0 || op < kNone ||
      op > kTagged || (op == kTagged) != (tag_table != nullptr && ntags > 0))
    return (int)cudaErrorInvalidValue;
  if (op == kNone) round_cap = 0;
  Work w;
  carve((char*)workspace, n, num_sets, nparts, round_cap > 0, &w);
  Geo g{n,     num_sets, slots, epb, (int)((n + kChunk - 1) / kChunk), nparts,
        op == kTagged ? tag_table : nullptr, ntags, round_cap};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run_op<float>(op, idx, (const float*)val, n_live,
                         Out<float>{out_idx, (float*)out_val, out_pos, out_act}, w, g, st);
  if (dtype == 1)
    return run_op<int>(op, idx, (const int*)val, n_live,
                       Out<int>{out_idx, (int*)out_val, out_pos, out_act}, w, g, st);
  return (int)cudaErrorInvalidValue;
}

// bytes of shared memory the windowed body takes for a window of w lanes
long long iru_win_reorder_smem(int w, int num_sets, int nparts) {
  return win_smem(w, num_sets, nparts);
}

// bytes of shared memory a window's CTA may take
long long iru_win_reorder_smem_limit(void) { return kWinMaxSmem; }

// the largest window of the windowed body at this geometry (0: none)
int iru_win_reorder_max_window(int num_sets, int nparts) {
  int w = kMaxWindow;
  while (w > 0 && win_smem(w, num_sets, nparts) > kWinMaxSmem) --w;
  return w;
}

static int win_entry(const int* idx, const void* val, const int* n_live, const uint8_t* tag_table,
                     int ntags, int* out_idx, void* out_val, int* out_pos, uint8_t* out_act,
                     long long n, int w, int num_sets, int slots, int epb, int nparts,
                     int round_cap, int dtype, int op, long long* stamps, int* occupancy,
                     void* stream) {
  if (n <= 0 && occupancy == nullptr) return 0;
  if (n >= INT_MAX || w < 1 || w > kMaxWindow || num_sets < 1 || slots < 1 || slots > kWarp ||
      epb < 1 || nparts < 1 || num_sets % nparts != 0 || round_cap < 0 || op < kNone ||
      op > kTagged || win_smem(w, num_sets, nparts) > kWinMaxSmem ||
      (occupancy == nullptr && (op == kTagged) != (tag_table != nullptr && ntags > 0)))
    return (int)cudaErrorInvalidValue;
  int shift = -1;
  for (int b = 0; b < 31; ++b)
    if (epb == 1 << b) shift = b;
  const WinGeo g{n,     w,     num_sets, slots, epb, nparts, round_cap, shift,
                 (num_sets & (num_sets - 1)) == 0, Div::of(slots),
                 op == kTagged ? tag_table : nullptr, ntags};
  const uint32_t* v = (const uint32_t*)val;
  uint32_t* ov = (uint32_t*)out_val;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return win_launch<float>(op, idx, v, n_live, g, out_idx, ov, out_pos, out_act, stamps,
                             occupancy, st);
  if (dtype == 1)
    return win_launch<int>(op, idx, v, n_live, g, out_idx, ov, out_pos, out_act, stamps,
                           occupancy, st);
  return (int)cudaErrorInvalidValue;
}

// The windowed body: independent windows of w lanes, one CTA each.  dtype,
// op, tag_table and n_live as above; round_cap: 0 for none.  Payloads
// travel as 32-bit words.
int iru_win_reorder(const int* idx, const void* val, const int* n_live, const uint8_t* tag_table,
                    int ntags, int* out_idx, void* out_val, int* out_pos, uint8_t* out_act,
                    long long n, int w, int num_sets, int slots, int epb, int nparts,
                    int round_cap, int dtype, int op, void* stream) {
  return win_entry(idx, val, n_live, tag_table, ntags, out_idx, out_val, out_pos, out_act, n, w,
                   num_sets, slots, epb, nparts, round_cap, dtype, op, nullptr, nullptr, stream);
}

// The same launch through the stamped build: stamps holds windows x
// (kWinPhases + 1) int64 on the device, each CTA's clock64() at its phase
// boundaries (a measurement of where a window's time goes).
int iru_win_reorder_stamped(const int* idx, const void* val, const int* n_live,
                            const uint8_t* tag_table, int ntags, int* out_idx, void* out_val,
                            int* out_pos, uint8_t* out_act, long long n, int w, int num_sets,
                            int slots, int epb, int nparts, int round_cap, int dtype, int op,
                            long long* stamps, void* stream) {
  if (stamps == nullptr) return (int)cudaErrorInvalidValue;
  return win_entry(idx, val, n_live, tag_table, ntags, out_idx, out_val, out_pos, out_act, n, w,
                   num_sets, slots, epb, nparts, round_cap, dtype, op, stamps, nullptr, stream);
}

// the phases of the stamped build
int iru_win_reorder_phases(void) { return kWinPhases; }

// CTAs of the windowed body resident on one SM at this geometry
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a cudaError_t code
int iru_win_reorder_occupancy(int w, int num_sets, int nparts, int dtype, int op, int* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  return win_entry(nullptr, nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr, nullptr, 0, w,
                   num_sets, 1, 1, nparts, 0, dtype, op, nullptr, blocks, nullptr);
}

const char* iru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
