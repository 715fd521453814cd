// Segment merge (kernel B2): merge_sorted(idx, vals, op, active, tags) over a
// sorted index stream, op in {add, min, max, tagged}, payload f32 or int32.
//
// Replaces the TPU kernel segment_merge_pallas
// (src/repro/kernels/segment_merge/segment_merge.py:120, pallas_call at :152),
// both of its bodies: _kernel (:43) for add/min/max and _kernel_tagged (:74)
// for the fused min+add family merge.  There one core walked the chunks in
// reverse and carried an (idx, val) pair from chunk to chunk.
//
// Contract (repro_torch.core.filter.merge_sorted): a lane p continues its
// predecessor's run when c(p) = active[p] && p > 0 && idx[p] == idx[p-1];
// survivor[p] = active[p] && !c(p); merged[p] is the reduction of the run
// holding p on every active lane, and an inactive lane keeps its own value.
// Domain: `active` is a prefix of the stream (what the sort engine passes),
// so the live runs end where the dead tail begins; each dead lane is a run of
// its own that nothing reads.
//
// What bounds it on an H100: bytes.  Per lane it must read idx (4), vals (4)
// and active (1), tagged also the tag (1), and write merged (4) and survivor
// (1): 14 B a lane (15 B tagged), 0.131 ms at PageRank's 3.14e7 lanes.
//
// The design: one pass over the stream, one launch (plus one memset of the
// per-tile status words), each lane read once and written once.
//   * Tiles of kTile = 4096 lanes, 256 threads x 16 lanes, loaded with 16-byte
//     vector loads (idx, vals, and 16 lanes of active and tags a thread).
//     Tile numbers come from an atomic ticket in reverse stream order, as the
//     Pallas grid walks them, so a tile only ever waits on tiles that started
//     before it: no deadlock whatever the order in which CTAs are resident.
//   * In the tile, one forward segmented scan of (last head position, value)
//     pairs: a serial fold over a thread's 16 lanes, a 5-step warp shuffle
//     scan, one cross-warp step in shared memory.  Every run that closes in
//     the tile has its total at its last lane; that lane writes it to a
//     shared-memory slot at the run's first lane, and every lane of the run
//     reads it from there (the forward broadcast of the old second pass).
//   * Each tile publishes one 64-bit status word with one store (valid bit,
//     the length of its leading stretch -- the lanes of a run begun in a tile
//     to the left -- the family and the stretch's 32-bit reduction), right
//     after its scan and before it waits on anything.  A reader therefore
//     never sees a torn (payload, family) pair.
//   * The tile that holds a run's first lane (its head tile) finishes a run
//     that crosses its right edge: one warp looks back over the status words
//     of the tiles to its right (32 at a time), folds their stretch values in
//     stream order, and stops at the first tile whose stretch ends inside it
//     (a tile that contains a head, or the last tile).  Its CTA then writes
//     the run's total over the run's lanes in those tiles; the tiles
//     themselves leave their leading stretch alone.  A hub run of 1e5 lanes
//     chains across the 25 tiles it covers and nowhere else.
//   * No inclusive state is kept: the head tile's look-back must visit every
//     tile of its run anyway, to learn where the run ends, so it folds the
//     aggregates it reads.  A run's total is therefore always the same
//     left-to-right fold: in-tile (thread serial, warp tree, warp prefix),
//     then the tiles' stretch values in stream order.  Repeated calls give
//     bit-identical f32 sums, whatever the order in which tiles ran.
//
// op = tagged: each lane carries a family tag (0 = min, 1 = add, a function
// of the index, so every run is uniform-tag).  The scanned value is then a
// (payload, family) pair whose combine folds under the right operand's
// family, as _kernel_tagged does.  No payload is inert for both families, so
// an inactive lane and the padding past the stream's end are the empty value
// (family 2) that every combine skips, not an identity.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the wrapper passes the status words).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kAdd = 0, kMin = 1, kMax = 2, kTagged = 3 };
enum Family { kMinFamily = 0, kAddFamily = 1, kEmpty = 2 };

// status word: bit 63 valid, bits 45-46 family, bits 32-44 the length of the
// tile's leading stretch (0..kTile), bits 0-31 the stretch's reduction
constexpr unsigned long long kValid = 1ull << 63;
constexpr int kLenShift = 32;
constexpr int kFamShift = 45;
static_assert(kTile < (1 << (kFamShift - kLenShift)), "stretch length field");

// the scanned value under op = tagged: a payload and its family
template <typename T>
struct Tagged {
  T v;
  int fam;
};

// the scanned value type: the payload, or a (payload, family) pair
template <typename T, int OP>
struct ValueOf {
  using type = T;
};
template <typename T>
struct ValueOf<T, kTagged> {
  using type = Tagged<T>;
};
template <typename T, int OP>
using Value = typename ValueOf<T, OP>::type;

template <typename T, int OP>
__device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, kAdd>() { return 0.f; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ float identity<float, kMax>() { return -CUDART_INF_F; }
template <> __device__ __forceinline__ int identity<int, kAdd>() { return 0; }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return INT_MIN; }
template <> __device__ __forceinline__ Tagged<float> identity<Tagged<float>, kTagged>() {
  return {0.f, kEmpty};
}
template <> __device__ __forceinline__ Tagged<int> identity<Tagged<int>, kTagged>() {
  return {0, kEmpty};
}

// int sums wrap, as torch's int32 sums do
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

template <typename V, int OP>
__device__ __forceinline__ V combine(V a, V b) {
  if constexpr (OP == kTagged) {
    if (b.fam == kEmpty) return a;
    if (a.fam == kEmpty) return b;
    return {b.fam == kAddFamily ? add(a.v, b.v) : (b.v < a.v ? b.v : a.v), b.fam};
  } else {
    if (OP == kAdd) return add(a, b);
    if (OP == kMin) return b < a ? b : a;
    return b > a ? b : a;
  }
}

template <typename T>
__device__ __forceinline__ T payload(T v) { return v; }
template <typename T>
__device__ __forceinline__ T payload(Tagged<T> v) { return v.v; }

template <typename V>
__device__ __forceinline__ V shfl_up(V v, int d) {
  return __shfl_up_sync(kFull, v, d);
}
template <typename T>
__device__ __forceinline__ Tagged<T> shfl_up(Tagged<T> v, int d) {
  return {__shfl_up_sync(kFull, v.v, d), __shfl_up_sync(kFull, v.fam, d)};
}

__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(int v) { return (unsigned)v; }
__device__ __forceinline__ void from_bits(unsigned b, float& v) { v = __uint_as_float(b); }
__device__ __forceinline__ void from_bits(unsigned b, int& v) { v = (int)b; }

// four payloads <-> one 16-byte vector
template <typename T>
__device__ __forceinline__ void unpack4(int4 w, T* v) {
  from_bits((unsigned)w.x, v[0]);
  from_bits((unsigned)w.y, v[1]);
  from_bits((unsigned)w.z, v[2]);
  from_bits((unsigned)w.w, v[3]);
}
template <typename T>
__device__ __forceinline__ int4 pack4(T a, T b, T c, T d) {
  return make_int4((int)bits_of(a), (int)bits_of(b), (int)bits_of(c), (int)bits_of(d));
}

template <typename T>
__device__ __forceinline__ unsigned long long pack(T v, int len) {
  return kValid | ((unsigned long long)len << kLenShift) | bits_of(v);
}
template <typename T>
__device__ __forceinline__ unsigned long long pack(Tagged<T> v, int len) {
  return pack(v.v, len) | ((unsigned long long)v.fam << kFamShift);
}
template <typename T>
__device__ __forceinline__ void unpack(unsigned long long w, T& v) {
  from_bits((unsigned)w, v);
}
template <typename T>
__device__ __forceinline__ void unpack(unsigned long long w, Tagged<T>& v) {
  from_bits((unsigned)w, v.v);
  v.fam = (int)((w >> kFamShift) & 3);
}
__device__ __forceinline__ int stretch_len(unsigned long long w) {
  return (int)((w >> kLenShift) & ((1u << (kFamShift - kLenShift)) - 1));
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

template <typename T>
struct Args {
  const int* idx;
  const uint8_t* active;  // nullptr = all lanes active
  const uint8_t* tags;    // op = tagged: each lane's family (nonzero = add)
  const T* vals;
  T* out;
  uint8_t* surv;
  long long n;
  bool vec;  // every input 16-byte aligned: full tiles take vector loads
};

// 4 bytes -> 4 flag bits (nonzero byte = 1), by one multiply
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}
// 4 flag bits -> 4 bytes of 0 or 1
__device__ __forceinline__ unsigned bytes_of(unsigned bits) {
  return ((bits & 0xfu) * 0x00204081u) & 0x01010101u;
}
// 16 bytes -> one flag bit per lane
__device__ __forceinline__ unsigned byte_bits(uint4 b) {
  return nibble(b.x) | nibble(b.y) << 4 | nibble(b.z) << 8 | nibble(b.w) << 12;
}

// One CTA merges one tile.  status[0, tiles) are the tiles' words and
// status[tiles] the ticket counter, all zero at launch.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
merge_tiles(Args<T> a, unsigned long long* status, long long tiles) {
  using V = Value<T, OP>;
  __shared__ long long s_tile;
  __shared__ T s_tot[kTile];  // a closed run's total, at its first lane
  __shared__ int s_wstart[kWarps];
  __shared__ V s_wval[kWarps];
  __shared__ int s_cross;     // first lane of the run crossing the right edge
  __shared__ V s_trail;       // that run's reduction inside this tile
  __shared__ long long s_end;  // where that run ends (exclusive)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_tile = tiles - 1 - (long long)atomicAdd(&status[tiles], 1ull);
    s_cross = -1;
  }
  __syncthreads();
  const long long t = s_tile;
  const long long L = t * kTile;
  const int len = (int)min((long long)kTile, a.n - L);
  const long long R = L + len;
  const int i0 = tid * kItems;
  const long long p0 = L + i0;
  const int mine = max(0, min(kItems, len - i0));  // real lanes of this thread

  // ---- load: 16 lanes a thread, and one halo lane on each side
  int idx[kItems];
  T val[kItems];
  unsigned act = (1u << kItems) - 1, tag = 0;
  if (mine == kItems && a.vec) {
    const int4* ip = reinterpret_cast<const int4*>(a.idx + p0);
    const int4* vp = reinterpret_cast<const int4*>(a.vals + p0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      unpack4(ip[q], &idx[4 * q]);
      unpack4(vp[q], &val[4 * q]);
    }
    if (a.active) act = byte_bits(*reinterpret_cast<const uint4*>(a.active + p0));
    if constexpr (OP == kTagged) tag = byte_bits(*reinterpret_cast<const uint4*>(a.tags + p0));
  } else {
    act = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      idx[k] = 0;
      val[k] = T(0);
      if (k < mine) {
        idx[k] = a.idx[p0 + k];
        val[k] = a.vals[p0 + k];
        act |= (unsigned)(a.active == nullptr || a.active[p0 + k] != 0) << k;
        if constexpr (OP == kTagged) tag |= (unsigned)(a.tags[p0 + k] != 0) << k;
      }
    }
  }
  act &= (1u << mine) - 1;  // lanes past the stream's end are no lanes
  // does the lane after this thread's last continue its run?
  bool next_cont = false;
  int prev = 0;
  if (mine > 0) {
    if (p0 > 0) prev = a.idx[p0 - 1];
    const long long q = p0 + kItems;
    if (mine == kItems && q < a.n)
      next_cont = (a.active == nullptr || a.active[q] != 0) && a.idx[q] == idx[kItems - 1];
  }

  // ---- lane masks: bit k for lane p0 + k
  unsigned eq = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) eq |= (unsigned)(idx[k] == (k == 0 ? prev : idx[k - 1])) << k;
  if (p0 == 0) eq &= ~1u;
  const unsigned valid = (1u << mine) - 1;
  const unsigned cont = eq & act;                // continues its predecessor's run
  const unsigned head = ~cont & valid;           // starts a run (a dead lane: its own)
  const unsigned ends = ~((cont >> 1) | (unsigned)next_cont << (kItems - 1)) & valid;
  const unsigned surv = head & act;              // an active lane that starts a run

  auto input = [&](int k) -> V {
    if (!((act >> k) & 1)) return identity<V, OP>();
    if constexpr (OP == kTagged) {
      return {val[k], ((tag >> k) & 1) ? kAddFamily : kMinFamily};
    } else {
      return val[k];
    }
  };

  // ---- thread fold, then a warp scan and a cross-warp step
  int s = -1;  // tile lane of the last head so far (-1: none)
  V v = identity<V, OP>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((head >> k) & 1) {
      s = i0 + k;
      v = input(k);
    } else {
      v = combine<V, OP>(v, input(k));
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int so = __shfl_up_sync(kFull, s, d);
    const V vo = shfl_up(v, d);
    if (lane >= d) {
      if (s < 0) v = combine<V, OP>(vo, v);
      s = max(s, so);
    }
  }
  if (lane == 31) {
    s_wstart[warp] = s;
    s_wval[warp] = v;
  }
  int es = shfl_up(s, 1);  // exclusive within the warp
  V ev = shfl_up(v, 1);
  if (lane == 0) {
    es = -1;
    ev = identity<V, OP>();
  }
  __syncthreads();
  int cs = -1;  // carry into this thread: the warps before, then the lanes
  V cv = identity<V, OP>();
  for (int w = 0; w < warp; ++w) {
    if (s_wstart[w] >= 0) {
      cs = s_wstart[w];
      cv = s_wval[w];
    } else {
      cv = combine<V, OP>(cv, s_wval[w]);
    }
  }
  if (es >= 0) {
    cs = es;
    cv = ev;
  } else {
    cv = combine<V, OP>(cv, ev);
  }

  // ---- rescan: close runs into s_tot; lanes before the tile's first head
  // are its leading stretch
  const bool in_lead = cs < 0;  // no head in the tile before this thread
  V lead = cv;
  int start[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((head >> k) & 1) {
      cs = i0 + k;
      cv = input(k);
    } else {
      cv = combine<V, OP>(cv, input(k));
    }
    start[k] = cs;
    if (cs < 0) lead = cv;
    if (((ends >> k) & 1) && cs >= 0) s_tot[cs] = payload(cv);  // a run closes
  }
  const bool last = mine > 0 && i0 + mine == len;  // holds the tile's last lane
  if (in_lead && mine > 0 && (head != 0 || last)) {
    // the leading stretch ends in this thread: publish it
    const int lead_len = head != 0 ? i0 + __ffs(head) - 1 : len;
    store_status(&status[t], pack(lead, lead_len));
  }
  if (last && next_cont && cs >= 0) {  // the last run crosses into the next tile
    s_cross = cs;
    s_trail = cv;
  }
  __syncthreads();

  // ---- head tile of a crossing run: look back over the tiles to the right
  const int cross = s_cross;
  if (cross >= 0 && warp == 0) {
    V total = s_trail;
    long long end = 0;
    for (long long base = t + 1;; base += 32) {
      const long long u = base + lane;
      const bool in_range = u < tiles;
      const int u_len = in_range ? (int)min((long long)kTile, a.n - u * kTile) : 0;
      unsigned long long w = 0;
      bool got = !in_range;
      int n_fold;
      bool closed;
      for (;;) {
        if (!got) {
          w = load_status(&status[u]);
          got = (w & kValid) != 0;
        }
        const unsigned ready = __ballot_sync(kFull, got);
        const bool closes = got && in_range && (stretch_len(w) < u_len || u == tiles - 1);
        const unsigned cl = __ballot_sync(kFull, closes);
        const int first_unready = ready == kFull ? 32 : __ffs(~ready) - 1;
        const int first_close = cl ? __ffs(cl) - 1 : 32;
        if (first_close < first_unready) {
          n_fold = first_close + 1;
          closed = true;
          break;
        }
        if (first_unready == 32) {
          n_fold = 32;
          closed = false;
          break;
        }
        __nanosleep(32);
      }
      for (int j = 0; j < n_fold; ++j) {  // stream order: deterministic sums
        const unsigned long long wj = __shfl_sync(kFull, w, j);
        if (stretch_len(wj) > 0) {
          V x;
          unpack(wj, x);
          total = combine<V, OP>(total, x);
        }
        end = (base + j) * kTile + stretch_len(wj);
      }
      if (closed) break;
    }
    if (lane == 0) {
      s_tot[cross] = payload(total);
      s_end = end;
    }
  }
  __syncthreads();

  // ---- write: merged and survivor once a lane (the leading stretch's
  // merged values belong to the head tile of its run)
  // four lanes at a time; the shared-memory loads are unconditional, as
  // predicated ones made the compiler rebuild the address of s_tot each time
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    T o[4];
    bool mask[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * q + j;
      mask[j] = k < mine && start[k] >= 0;
      const T x = s_tot[mask[j] ? start[k] : 0];
      o[j] = ((act >> k) & 1) ? x : val[k];
    }
    if (a.vec && mask[0] && mask[3]) {  // start[] rises: all four lanes
      *reinterpret_cast<int4*>(a.out + p0 + 4 * q) = pack4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (mask[j]) a.out[p0 + 4 * q + j] = o[j];
    }
  }
  if (mine == kItems && a.vec) {
    *reinterpret_cast<uint4*>(a.surv + p0) = make_uint4(
        bytes_of(surv), bytes_of(surv >> 4), bytes_of(surv >> 8), bytes_of(surv >> 12));
  } else {
    for (int k = 0; k < mine; ++k) a.surv[p0 + k] = (surv >> k) & 1;
  }
  if (cross >= 0) {  // the crossing run's lanes in the tiles to the right
    const T x = s_tot[cross];
    const long long end = s_end;
    if (a.vec) {
      const int4 x4 = pack4(x, x, x, x);
      long long q = R + 4ll * tid;  // R is a multiple of kTile: 16-byte aligned
      for (; q + 4 <= end; q += 4ll * kThreads) *reinterpret_cast<int4*>(a.out + q) = x4;
      for (; q < end; ++q) a.out[q] = x;
    } else {
      for (long long q = R + tid; q < end; q += kThreads) a.out[q] = x;
    }
  }
}

template <typename T, int OP>
int run(const Args<T>& a, unsigned long long* status, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  if (cudaError_t e = cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(unsigned long long), s);
      e != cudaSuccess)
    return (int)e;
  merge_tiles<T, OP><<<(unsigned)tiles, kThreads, 0, s>>>(a, status, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args<T>& a, int op, unsigned long long* status, cudaStream_t s) {
  switch (op) {
    case kAdd: return run<T, kAdd>(a, status, s);
    case kMin: return run<T, kMin>(a, status, s);
    case kMax: return run<T, kMax>(a, status, s);
    case kTagged: return a.tags ? run<T, kTagged>(a, status, s) : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// lanes per tile: the wrapper sizes the status words with it
int iru_segment_merge_tile(void) { return kTile; }

// dtype: 0 = float32, 1 = int32; op: 0 = add, 1 = min, 2 = max, 3 = tagged
// (tags: one byte a lane, nonzero = the add family; null for other ops).
// status holds ceil(n / iru_segment_merge_tile()) + 1 eight-byte words; it
// is zeroed here on the stream (one memset) before the one launch.
// Returns a cudaError_t code (0 on success).
int iru_segment_merge(const int* idx, const uint8_t* active, const uint8_t* tags,
                      const void* vals, void* out, uint8_t* surv, void* status, long long n,
                      int dtype, int op, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = aligned(idx) && aligned(active) && aligned(tags) && aligned(vals) &&
                   aligned(out) && aligned(surv);
  unsigned long long* st = (unsigned long long*)status;
  if (dtype == 0) {
    Args<float> a{idx, active, tags, (const float*)vals, (float*)out, surv, n, vec};
    return dispatch<float>(a, op, st, s);
  }
  if (dtype == 1) {
    Args<int> a{idx, active, tags, (const int*)vals, (int*)out, surv, n, vec};
    return dispatch<int>(a, op, st, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* iru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
