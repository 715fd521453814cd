// IRU reordering hash (kernel B3): the paper's hash of num_sets x slots
// entries keyed on hash(idx // epb), over an int32 index stream with an
// f32 or int32 [n] payload and a ragged live prefix n_live (read from device
// memory).  The result equals ragged_oracle(hash_reorder_ref, ...) of
// repro_torch/kernels/iru_reorder/ref.py, buffer order:
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
//           within a 32-lane step), an exclusive scan of the set-major
//           histogram, then the same ranking again to scatter
//           (index, payload, position) into set-major order;
//   walk    one warp per set, lane j holding slot j.  Arrivals are read 32
//           at a time and broadcast one by one: a duplicate of a resident
//           (one __ballot_sync) folds into the owning lane; otherwise the
//           element takes slot `cnt`, and the `slots`-th insertion writes
//           the group back into the set's own (already consumed) stretch of
//           the binned arrays and marks its trigger's stream position.  The
//           fold runs in stream order, so f32 sums add in the oracle's
//           order;
//   emit    no sorts: a flush group's rank is an exclusive scan of the
//           trigger marks over stream positions (triggers are distinct
//           positions), a filtered lane's tail slot a scan of the filtered
//           marks, drain offsets a scan of the per-set drain counts.
//
// What bounds it on an H100: the walk.  It is sequential within a set, so
// the busiest set's arrival count sets the time (kron-20 PageRank: 86,047
// arrivals in the busiest of 1024 sets against a mean of 30,666).  The
// byte bound is 8 B read and 13 B written a lane.  Spreading a hot set over
// several warps is later work.
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
constexpr int kBinWarps = 4;      // warps per CTA of the binning passes
constexpr int kChunk = 8192;      // lanes of one binning warp
constexpr int kMaxSets = 8192;    // binning keeps num_sets counters a warp
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kWalkWarps = 4;
constexpr int kEmitThreads = 256;

enum Op { kNone = 0, kAdd = 1, kMin = 2, kMax = 3 };
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

struct Geo {
  long long n;
  int num_sets;
  int slots;
  int epb;
  int nchunks;
};

// ---------------------------------------------------------------- binning
// PASS 0 counts each set's live lanes per chunk into hist[s * nchunks + c];
// PASS 1 reads the scanned offsets back and scatters set-major.
template <int PASS>
__global__ void __launch_bounds__(kBinWarps * kWarp)
bin_pass(const int* idx, const uint32_t* val, const int* n_live, Geo g, int* hist,
         int* b_idx, uint32_t* b_val, int* b_pos) {
  extern __shared__ int counters[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int chunk = blockIdx.x * kBinWarps + warp;
  if (chunk >= g.nchunks) return;  // whole warps only; no block barrier below
  int* cnt = counters + warp * g.num_sets;
  for (int s = lane; s < g.num_sets; s += kWarp)
    cnt[s] = PASS == 0 ? 0 : hist[(long long)s * g.nchunks + chunk];
  __syncwarp();
  const long long m = live_count(n_live, g.n);
  const long long p0 = (long long)chunk * kChunk;
  const long long p1 = min(p0 + kChunk, m);
  for (long long base = p0; base < p1; base += kWarp) {
    const long long p = base + lane;
    const bool live = p < p1;
    const int x = live ? idx[p] : 0;
    const int s = live ? hash_set(x, g.epb, g.num_sets) : g.num_sets;
    const unsigned peers = __match_any_sync(kFull, s);
    const int before = __popc(peers & ((1u << lane) - 1u));
    if (live && PASS == 1) {
      const int at = cnt[s] + before;
      b_idx[at] = x;
      b_val[at] = val[p];
      b_pos[at] = (int)p;
    }
    __syncwarp();
    if (live && before == 0) cnt[s] += __popc(peers);
    __syncwarp();
  }
  if (PASS == 0)
    for (int s = lane; s < g.num_sets; s += kWarp) hist[(long long)s * g.nchunks + chunk] = cnt[s];
}

// set_start[s] = first set-major slot of set s; set_start[num_sets] = n_live
__global__ void set_starts(const int* hist, const int* n_live, Geo g, int* set_start) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < g.num_sets) set_start[s] = hist[(long long)s * g.nchunks];
  if (s == g.num_sets) set_start[s] = live_count(n_live, g.n);
}

// ------------------------------------------------------------------ walk
template <typename T, int OP>
__global__ void __launch_bounds__(kWalkWarps * kWarp)
walk(const int* set_start, Geo g, int* b_idx, uint32_t* b_val_bits, int* b_pos, uint8_t* mark,
     int* nflush, int* ndrain) {
  const int lane = threadIdx.x % kWarp;
  const int s = blockIdx.x * kWalkWarps + threadIdx.x / kWarp;
  if (s >= g.num_sets) return;
  T* b_val = reinterpret_cast<T*>(b_val_bits);
  const int start = set_start[s];
  const int len = set_start[s + 1] - start;
  int r_idx = 0, r_pos = 0;  // slot `lane` of this set
  T r_val = T(0);
  int cnt = 0, wc = 0, flushes = 0;  // warp-uniform
  for (int k0 = 0; k0 < len; k0 += kWarp) {
    const bool have = k0 + lane < len;
    const int at = start + k0 + lane;
    const int ei = have ? b_idx[at] : 0;
    const T ev = have ? b_val[at] : T(0);
    const int ep = have ? b_pos[at] : 0;
    const int steps = min(kWarp, len - k0);
    unsigned filtered = 0, triggers = 0;
    for (int t = 0; t < steps; ++t) {
      const int xi = __shfl_sync(kFull, ei, t);
      const T xv = __shfl_sync(kFull, ev, t);
      if (OP != kNone) {
        const unsigned hit = __ballot_sync(kFull, lane < cnt && r_idx == xi);
        if (hit) {
          if (lane == __ffs(hit) - 1) r_val = combine<T, OP>(r_val, xv);
          filtered |= 1u << t;
          continue;
        }
      }
      const int xp = __shfl_sync(kFull, ep, t);
      if (lane == cnt) {
        r_idx = xi;
        r_val = xv;
        r_pos = xp;
      }
      if (++cnt == g.slots) {
        // every element of this chunk is in registers by now (the shuffles
        // above waited on the loads), and the group's stretch lies within
        // the arrivals already consumed
        if (lane < g.slots) {
          b_idx[start + wc + lane] = r_idx;
          b_val[start + wc + lane] = r_val;
          b_pos[start + wc + lane] = r_pos;
        }
        triggers |= 1u << t;
        wc += g.slots;
        cnt = 0;
        ++flushes;
      }
    }
    if (have && ((filtered | triggers) >> lane & 1u))
      mark[ep] = (filtered >> lane & 1u) ? kFiltered : kTrigger;
  }
  if (lane < cnt) {  // drain group: the residents at end of stream
    b_idx[start + wc + lane] = r_idx;
    b_val[start + wc + lane] = r_val;
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
          const int* meta, const int* rank, const int* b_idx, const T* b_val, const int* b_pos,
          Geo g, int* out_idx, T* out_val, int* out_pos, uint8_t* out_act) {
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
  out_idx[o] = b_idx[q];
  out_val[o] = b_val[q];
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
  int* b_idx;
  uint32_t* b_val;
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
  v.b_idx = (int*)take(n * 4);
  v.b_val = (uint32_t*)take(n * 4);
  v.b_pos = (int*)take(n * 4);
  v.mark = (uint8_t*)take(n);
  v.rank = (int*)take(n * 4);
  if (w) *w = v;
  return off;
}

template <typename T, int OP>
int walk_one(const Work& w, Geo g, cudaStream_t st) {
  const unsigned blocks = (g.num_sets + kWalkWarps - 1) / kWalkWarps;
  walk<T, OP><<<blocks, kWalkWarps * kWarp, 0, st>>>(w.set_start, g, w.b_idx, w.b_val, w.b_pos,
                                                     w.mark, w.nflush, w.ndrain);
  return (int)cudaGetLastError();
}

template <typename T>
int walk_launch(int op, const Work& w, Geo g, cudaStream_t st) {
  switch (op) {
    case kNone: return walk_one<T, kNone>(w, g, st);
    case kAdd: return walk_one<T, kAdd>(w, g, st);
    case kMin: return walk_one<T, kMin>(w, g, st);
    case kMax: return walk_one<T, kMax>(w, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const int* idx, const T* val, const int* n_live, int* out_idx, T* out_val, int* out_pos,
        uint8_t* out_act, const Work& w, Geo g, int op, cudaStream_t st) {
  const int smem = kBinWarps * g.num_sets * 4;  // above 48 KB past 3072 sets
  int e;
  if (smem > 48 * 1024 &&
      ((e = (int)cudaFuncSetAttribute(bin_pass<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem)) ||
       (e = (int)cudaFuncSetAttribute(bin_pass<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem))))
    return e;
  const unsigned bin_blocks = (g.nchunks + kBinWarps - 1) / kBinWarps;
  const uint32_t* vbits = reinterpret_cast<const uint32_t*>(val);
  if ((e = (int)cudaMemsetAsync(w.mark, 0, g.n, st))) return e;
  bin_pass<0><<<bin_blocks, kBinWarps * kWarp, smem, st>>>(idx, vbits, n_live, g, w.hist, w.b_idx,
                                                           w.b_val, w.b_pos);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = scan(HistScan{w.hist, (long long)g.nchunks * g.num_sets}, w.agg, st))) return e;
  set_starts<<<(g.num_sets + 256) / 256, 256, 0, st>>>(w.hist, n_live, g, w.set_start);
  bin_pass<1><<<bin_blocks, kBinWarps * kWarp, smem, st>>>(idx, vbits, n_live, g, w.hist, w.b_idx,
                                                           w.b_val, w.b_pos);
  if ((e = (int)cudaGetLastError())) return e;
  if ((e = walk_launch<T>(op, w, g, st))) return e;
  finalize<<<1, kScanThreads, 0, st>>>(w.nflush, w.ndrain, g, w.drain_off, w.meta);
  MarkScan<T> ms{w.mark, g.n, idx, val, n_live, w.meta, w.rank, out_idx, out_val, out_pos, out_act};
  if ((e = scan(ms, w.agg, st))) return e;
  const unsigned emit_blocks = (unsigned)((g.n + kEmitThreads - 1) / kEmitThreads);
  emit_kept<T><<<emit_blocks, kEmitThreads, 0, st>>>(
      w.set_start, w.nflush, w.ndrain, w.drain_off, w.meta, w.rank, w.b_idx,
      reinterpret_cast<const T*>(w.b_val), w.b_pos, g, out_idx, out_val, out_pos, out_act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int iru_hash_reorder_max_sets(void) { return kMaxSets; }

// bytes of the workspace iru_hash_reorder needs for n lanes and num_sets sets
long long iru_hash_reorder_workspace(long long n, int num_sets) {
  return carve(nullptr, n, num_sets, nullptr);
}

// dtype: 0 = float32, 1 = int32; op: 0 = none, 1 = add, 2 = min, 3 = max.
// n_live: device pointer to one int32, or null for a padded stream.
// Returns a cudaError_t code (0 on success).
int iru_hash_reorder(const int* idx, const void* val, const int* n_live, int* out_idx,
                     void* out_val, int* out_pos, uint8_t* out_act, void* workspace,
                     long long n, int num_sets, int slots, int epb, int dtype, int op,
                     void* stream) {
  if (n <= 0) return 0;
  if (n >= INT_MAX || num_sets < 1 || num_sets > kMaxSets || slots < 1 || slots > kWarp ||
      epb < 1 || op < kNone || op > kMax)
    return (int)cudaErrorInvalidValue;
  Work w;
  carve((char*)workspace, n, num_sets, &w);
  Geo g{n, num_sets, slots, epb, (int)((n + kChunk - 1) / kChunk)};
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
