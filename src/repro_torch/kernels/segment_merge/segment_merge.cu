// Segment merge (kernel B2): merge_sorted(idx, vals, op, active, tags) over a
// sorted index stream, op in {add, min, max, tagged}, payload f32 or int32.
//
// Replaces the TPU kernel repro/kernels/segment_merge/segment_merge.py
// (segment_merge_pallas, both of its bodies: _kernel for add/min/max and
// _kernel_tagged for the fused min+add family merge).  There a single core
// walked the chunks in reverse and carried an (idx, val) pair from chunk to
// chunk.  Here CTAs run in no order, so the carry becomes a three-phase
// segmented scan:
//   K1  each CTA reduces its tile of kTile lanes to one (has_head, value);
//   K2  one CTA scans those tile aggregates into per-tile prefixes;
//   K3  each CTA rescans its tile in shared memory, seeded by its prefix.
// Runs of any length (about 1e5 lanes on kron hubs) cross tiles this way
// without serialising on a thread per run.
//
// Two such scans make the result:
//   pass 0  a segmented suffix scan with `op` (the reference's reverse
//           walk): lane p gets op over [p, end of its run], so the first
//           lane of each run holds the whole run's reduction;
//   pass 1  a forward segmented broadcast of each run's first lane, so every
//           active lane of the run carries the full reduction, exactly what
//           repro.core.filter.merge_sorted returns.
// Lane semantics: first[p] = active[p] && (p == 0 || idx[p] != idx[p-1]);
// inactive lanes never start a run and keep their own value; survivor =
// first.  Domain: `active` is a prefix of the stream (what the sort engine
// passes); off it the reference indexes segment -1.
//
// op = tagged: each lane carries a family tag (0 = min, 1 = add, a function
// of the index, so every run is uniform-tag).  Pass 0's value is then a
// (payload, family) pair whose combine folds under the right operand's
// family, as _kernel_tagged does.  No payload is inert for both families,
// and the dead tail of a ragged stream lies inside the last run's reverse
// segment with tags of its own, so an inactive lane contributes an empty
// value (family 2) that every combine skips, instead of an identity.
//
// What bounds it on an H100: bytes.  Per lane it reads idx (4), vals (4),
// active (1) and, tagged, the tag (1), and writes merged (4) and survivor
// (1); this version also writes and rereads one scratch payload per lane
// between the passes and rereads idx/active once more.  Single-pass
// decoupled look-back is later work.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing (the wrapper passes the scratch buffers).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

enum Op { kAdd = 0, kMin = 1, kMax = 2, kTagged = 3, kFirst = 4 };
enum Family { kMinFamily = 0, kAddFamily = 1, kEmpty = 2 };

// pass 0's value under op = tagged: a payload and its family
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
template <> __device__ __forceinline__ float identity<float, kFirst>() { return 0.f; }
template <> __device__ __forceinline__ int identity<int, kAdd>() { return 0; }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return INT_MIN; }
template <> __device__ __forceinline__ int identity<int, kFirst>() { return 0; }
template <> __device__ __forceinline__ Tagged<float> identity<Tagged<float>, kTagged>() {
  return {0.f, kEmpty};
}
template <> __device__ __forceinline__ Tagged<int> identity<Tagged<int>, kTagged>() {
  return {0, kEmpty};
}

template <typename V, int OP>
__device__ __forceinline__ V combine(V a, V b) {
  if constexpr (OP == kTagged) {
    if (b.fam == kEmpty) return a;
    if (a.fam == kEmpty) return b;
    return {b.fam == kAddFamily ? a.v + b.v : (b.v < a.v ? b.v : a.v), b.fam};
  } else {
    if (OP == kAdd) return a + b;
    if (OP == kMin) return b < a ? b : a;
    if (OP == kMax) return b > a ? b : a;
    return a;  // kFirst: keep the earlier (run-start) value
  }
}

// the segmented operator on (has_head, value) pairs; associative
template <typename V, int OP>
__device__ __forceinline__ void seg_combine(bool& f, V& v, bool rf, V rv) {
  v = rf ? rv : combine<V, OP>(v, rv);
  f = f || rf;
}

template <typename T>
__device__ __forceinline__ T payload(T v) { return v; }
template <typename T>
__device__ __forceinline__ T payload(Tagged<T> v) { return v.v; }

template <typename T>
struct Args {
  const int* idx;
  const uint8_t* active;  // nullptr = all lanes active
  const uint8_t* tags;    // op = tagged: each lane's family (1 = add)
  const T* vals;
  T* scratch;             // pass 0 output, pass 1 input
  T* out;
  uint8_t* surv;
  long long n;
};

template <typename T>
__device__ __forceinline__ bool is_active(const Args<T>& a, long long p) {
  return a.active == nullptr || a.active[p] != 0;
}

template <typename T>
__device__ __forceinline__ bool is_first(const Args<T>& a, long long p) {
  return is_active(a, p) && (p == 0 || a.idx[p] != a.idx[p - 1]);
}

// an active lane's input value under op OP (its family rides it when tagged)
template <typename T, int OP>
__device__ __forceinline__ Value<T, OP> input(const Args<T>& a, long long p) {
  if constexpr (OP == kTagged) {
    return {a.vals[p], a.tags[p] != 0 ? kAddFamily : kMinFamily};
  } else {
    return a.vals[p];
  }
}

// logical element j of pass PASS: its lane, head flag and input value
template <typename T, int OP, int PASS>
__device__ __forceinline__ long long element(const Args<T>& a, long long j, bool& head,
                                             Value<T, OP>& x) {
  if constexpr (PASS == 0) {  // reverse walk; a run's last lane opens its reverse segment
    const long long p = a.n - 1 - j;
    head = (p == a.n - 1) || is_first(a, p + 1);
    x = is_active(a, p) ? input<T, OP>(a, p) : identity<Value<T, OP>, OP>();
    return p;
  } else {
    const long long p = j;  // forward walk; a run's first lane opens it
    head = (p == 0) || is_first(a, p);
    x = a.scratch[p];
    return p;
  }
}

// Block-wide scan of per-thread (flag, value): returns the combined value of
// all threads before this one in (ef, ev); the block total in (tf, tv).
template <typename V, int OP>
__device__ void block_scan(bool f, V v, bool& ef, V& ev, bool& tf, V& tv) {
  __shared__ uint8_t sf[kThreads];
  __shared__ V sv[kThreads];
  const int tid = threadIdx.x;
  sf[tid] = f;
  sv[tid] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    bool lf = false;
    V lv = v;
    if (tid >= off) {
      lf = sf[tid - off];
      lv = sv[tid - off];
    }
    __syncthreads();
    if (tid >= off) {
      seg_combine<V, OP>(lf, lv, f, v);
      f = lf;
      v = lv;
      sf[tid] = f;
      sv[tid] = v;
    }
    __syncthreads();
  }
  ef = tid > 0 ? sf[tid - 1] != 0 : false;
  ev = tid > 0 ? sv[tid - 1] : identity<V, OP>();
  tf = sf[kThreads - 1] != 0;
  tv = sv[kThreads - 1];
  __syncthreads();
}

// fold of this thread's kItems elements; threads past the end hold the
// right identity (false, identity)
template <typename T, int OP, int PASS>
__device__ __forceinline__ void thread_fold(const Args<T>& a, long long j0, bool& f,
                                            Value<T, OP>& v) {
  f = false;
  v = identity<Value<T, OP>, OP>();
  for (int k = 0; k < kItems; ++k) {
    const long long j = j0 + k;
    if (j >= a.n) break;
    bool h;
    Value<T, OP> x;
    element<T, OP, PASS>(a, j, h, x);
    if (k == 0) {
      f = h;
      v = x;
    } else {
      seg_combine<Value<T, OP>, OP>(f, v, h, x);
    }
  }
}

template <typename T, int OP, int PASS>
__global__ void __launch_bounds__(kThreads)
tile_reduce(Args<T> a, uint8_t* agg_f, Value<T, OP>* agg_v) {
  using V = Value<T, OP>;
  const long long j0 = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  bool f;
  V v;
  thread_fold<T, OP, PASS>(a, j0, f, v);
  bool ef, tf;
  V ev, tv;
  block_scan<V, OP>(f, v, ef, ev, tf, tv);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = tf;
    agg_v[blockIdx.x] = tv;
  }
}

// one CTA: prefix[t] = scan value just before tile t (unused for t = 0,
// whose first element is always a head)
template <typename V, int OP>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const uint8_t* agg_f, const V* agg_v, V* prefix, long long tiles) {
  const long long per = (tiles + kThreads - 1) / kThreads;
  const long long t0 = (long long)threadIdx.x * per;
  const long long t1 = min(t0 + per, tiles);
  bool f = false;
  V v = identity<V, OP>();
  for (long long t = t0; t < t1; ++t) {
    if (t == t0) {
      f = agg_f[t] != 0;
      v = agg_v[t];
    } else {
      seg_combine<V, OP>(f, v, agg_f[t] != 0, agg_v[t]);
    }
  }
  bool ef, tf;
  V ev, tv;
  block_scan<V, OP>(f, v, ef, ev, tf, tv);
  for (long long t = t0; t < t1; ++t) {
    prefix[t] = ev;
    seg_combine<V, OP>(ef, ev, agg_f[t] != 0, agg_v[t]);
  }
}

template <typename T, int OP, int PASS>
__global__ void __launch_bounds__(kThreads)
tile_scan(Args<T> a, const Value<T, OP>* prefix) {
  using V = Value<T, OP>;
  const long long j0 = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  bool f;
  V v;
  thread_fold<T, OP, PASS>(a, j0, f, v);
  bool ef, tf;
  V ev, tv;
  block_scan<V, OP>(f, v, ef, ev, tf, tv);
  // carry into this thread = tile prefix combined with the threads before it
  bool cf = blockIdx.x > 0;
  V cv = blockIdx.x > 0 ? prefix[blockIdx.x] : identity<V, OP>();
  seg_combine<V, OP>(cf, cv, ef, ev);
  for (int k = 0; k < kItems; ++k) {
    const long long j = j0 + k;
    if (j >= a.n) break;
    bool h;
    V x;
    const long long p = element<T, OP, PASS>(a, j, h, x);
    cv = h ? x : combine<V, OP>(cv, x);
    if constexpr (PASS == 0) {
      a.scratch[p] = payload(cv);
    } else {
      a.out[p] = is_active(a, p) ? payload(cv) : a.vals[p];
      a.surv[p] = is_first(a, p);
    }
  }
}

template <typename T, int OP, int PASS>
void scan_pass(const Args<T>& a, uint8_t* agg_f, void* agg_v, void* prefix, long long tiles,
               cudaStream_t s) {
  using V = Value<T, OP>;
  tile_reduce<T, OP, PASS><<<(unsigned)tiles, kThreads, 0, s>>>(a, agg_f, (V*)agg_v);
  scan_tiles<V, OP><<<1, kThreads, 0, s>>>(agg_f, (const V*)agg_v, (V*)prefix, tiles);
  tile_scan<T, OP, PASS><<<(unsigned)tiles, kThreads, 0, s>>>(a, (const V*)prefix);
}

template <typename T, int OP>
int run(const Args<T>& a, uint8_t* agg_f, void* agg_v, void* prefix, cudaStream_t s) {
  const long long tiles = (a.n + kTile - 1) / kTile;
  scan_pass<T, OP, 0>(a, agg_f, agg_v, prefix, tiles, s);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess) return (int)e;
  scan_pass<T, kFirst, 1>(a, agg_f, agg_v, prefix, tiles, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args<T>& a, int op, uint8_t* agg_f, void* agg_v, void* prefix,
             cudaStream_t s) {
  switch (op) {
    case kAdd: return run<T, kAdd>(a, agg_f, agg_v, prefix, s);
    case kMin: return run<T, kMin>(a, agg_f, agg_v, prefix, s);
    case kMax: return run<T, kMax>(a, agg_f, agg_v, prefix, s);
    case kTagged: return a.tags ? run<T, kTagged>(a, agg_f, agg_v, prefix, s)
                                : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// lanes per tile: the wrapper sizes the per-tile scratch with it
int iru_segment_merge_tile(void) { return kTile; }

// bytes of one per-tile aggregate (agg_v and prefix hold one a tile)
int iru_segment_merge_agg_bytes(void) { return (int)sizeof(Tagged<float>); }

// dtype: 0 = float32, 1 = int32; op: 0 = add, 1 = min, 2 = max, 3 = tagged
// (tags: one byte a lane, nonzero = the add family; null for other ops).
// scratch holds n payloads; agg_f holds one byte a tile, agg_v and prefix
// iru_segment_merge_agg_bytes() a tile.
// Returns a cudaError_t code (0 on success).
int iru_segment_merge(const int* idx, const uint8_t* active, const uint8_t* tags,
                      const void* vals, void* out, uint8_t* surv, void* scratch, uint8_t* agg_f,
                      void* agg_v, void* prefix, long long n, int dtype, int op, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    Args<float> a{idx, active, tags, (const float*)vals, (float*)scratch, (float*)out, surv, n};
    return dispatch<float>(a, op, agg_f, agg_v, prefix, s);
  }
  if (dtype == 1) {
    Args<int> a{idx, active, tags, (const int*)vals, (int*)scratch, (int*)out, surv, n};
    return dispatch<int>(a, op, agg_f, agg_v, prefix, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* iru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
