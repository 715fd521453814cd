// Block-reuse gather (kernel B1): out[i, :] = table[indices[i], :].
//
// Replaces the TPU kernel repro/kernels/coalesced_gather/coalesced_gather.py
// (coalesced_gather_pallas, _kernel) and its whole-stream lax.cond fallback
// in repro/kernels/coalesced_gather/ops.py.
//
// What it computes: the stream is cut into groups of `group` lanes.  A group
// whose indices satisfy the window contract
//     max(idx) < (min(idx) / window + 2) * window
// is served from rows that the CTA staged once in shared memory (block
// reuse: each staged row is read from device memory once for all lanes that
// hit it).  A group that breaks the contract reads its rows straight from
// global memory in the same kernel, so every stream gets table[indices]
// exactly, with no host sync and no second code path.
//
// Design: each CTA takes a tile of many groups at once (4096 lanes, a
// whole number of groups; at most 512 groups when `group` does not divide
// 32), with two block barriers on contiguous offsets:
//   1. each thread loads its 16 offsets into registers, and each group's
//      min and max come from shuffles: groups of 1, 2, 4, 8, 16 or 32 lanes
//      are aligned runs of one warp, so every lane learns its group's
//      contract at once; other groups are folded segment by segment into
//      shared-memory min/max (one atomic per group and warp) and decided by
//      one thread per group after a barrier;
//   2. the block finds the row span [lo, hi] of its contract-meeting lanes;
//   3. if the span fits the budget (5120 rows a column) it is staged whole,
//      coalesced; otherwise (gappy offsets: a BFS frontier's expansion)
//      each such lane marks the 32-row chunk it touches within 512 chunks
//      of lo, a block scan gives the marked chunks slots in row order up to
//      the budget, and only those chunks are staged, so no unused span is;
//   4. every lane of a contract-meeting group whose row was staged reads it
//      from shared memory; every other lane reads global memory.
// When the groups are aligned, the strides 1 and the pointers 16-byte
// aligned (the expansion's case), a thread holds 4 consecutive lanes an
// item and loads offsets, stages rows and stores outputs 16 bytes at a
// time.  On PageRank's contiguous offsets a tile stages about 4096 rows, so
// bytes staged equal bytes used.
//
// The table is given as up to two 32-bit columns (c0, c1) with a row stride,
// so one launch serves a row-major [V, D] table (D = 1 or 2) or two separate
// edge arrays (col_idx bits and weights) gathered in one pass.  Words are
// copied as raw 32 bits: int32 ids and f32 weights both pass unchanged.
//
// What bounds it on an H100: bytes.  Each lane reads its 4-byte offset and
// writes 4*D bytes, and each touched row is read once (3.35 TB/s).  A tile's
// row loads wait for its offsets and a barrier; the next tile's offsets do
// not overlap them (a persistent CTA with TMA staging is later work).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// allocates nothing.  Precondition (checked by the Python wrapper where it
// can be without a sync): 0 <= indices < V.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                  // offsets a thread keeps in registers
constexpr int kTile = kThreads * kItems;    // lanes a CTA takes at once (group <= kTile)
constexpr int kMaxGroups = 512;    // groups a tile holds (min/max in shared memory)
constexpr int kChunkShift = 5;     // staging unit: 32 consecutive rows
constexpr int kChunkRows = 1 << kChunkShift;
constexpr int kMapChunks = 512;    // span of chunks a tile may stage from
constexpr int kStageChunks = 160;  // chunks staged a tile (the shared-memory budget)
constexpr int kStageRows = kStageChunks * kChunkRows;
constexpr int kMapPer = kMapChunks / kThreads;

// l / group for 0 <= l < 2^13 and group <= kTile, with magic = ceil(2^32 / group)
// (exact while l * group < 2^32); magic = 0 when one group fills the tile
__device__ __forceinline__ int group_of(int l, unsigned long long magic) {
  return (int)(((unsigned long long)(unsigned)l * magic) >> 32);
}

// the window contract; wshift = log2(window) when window is a power of two
__device__ __forceinline__ bool contract(int lo, int hi, int window, int wshift) {
  const int blk = wshift >= 0 ? lo >> wshift : lo / window;
  return lo >= 0 && (long long)hi < ((long long)blk + 2) * window;
}

// VEC: aligned groups, unit strides and 16-byte aligned pointers; a thread
// then holds 4 consecutive lanes an item and moves offsets, staged rows and
// outputs 16 bytes at a time.  Otherwise a thread holds one lane an item.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
block_reuse_gather(const uint32_t* __restrict__ c0, const uint32_t* __restrict__ c1,
                   int in_stride, long long V, const int* __restrict__ idx,
                   long long n, uint32_t* __restrict__ o0, uint32_t* __restrict__ o1,
                   int out_stride, int group, int window, int wshift, int tile_lanes,
                   unsigned long long magic) {
  extern __shared__ __align__(16) uint32_t stage[];  // [kStageRows] rows x D columns, column-major
  __shared__ int s_min[kMaxGroups];    // per unaligned group: min, then the contract flag
  __shared__ int s_max[kMaxGroups];
  __shared__ int s_map[kMapChunks];    // chunk (from the anchor) -> mark, then slot or -1
  __shared__ int s_chunk[kStageChunks];  // slot -> chunk (from the anchor)
  __shared__ int s_lo[kWarps], s_hi[kWarps], s_warp[kWarps];
  __shared__ int s_slots;
  const int D = (c1 != nullptr) ? 2 : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * tile_lanes;
  const int cnt = (int)min((long long)tile_lanes, n - t0);
  const int ngroups = (cnt + group - 1) / group;
  const int* tidx = idx + t0;
  // groups of 1, 2, 4, 8, 16 or 32 lanes are aligned runs of one warp: their
  // min and max are shuffle reductions, and every lane learns the contract
  const bool aligned = (32 % group) == 0;

  for (int c = tid; c < kMapChunks; c += kThreads) s_map[c] = 0;
  if (!aligned) {
    for (int g = tid; g < ngroups; g += kThreads) {
      s_min[g] = INT_MAX;
      s_max[g] = INT_MIN;
    }
    __syncthreads();
  }

  // 1. each group's min and max over its real lanes (scalar layout: lane
  //    l = k * kThreads + tid of the tile holds v[k]; lanes past kTile exist
  //    only when one group fills the tile, and are read again where needed)
  int v[kItems];
  unsigned ok = 0;  // bit k: v[k]'s group meets the contract
  int lo_ok = INT_MAX, hi_ok = INT_MIN;  // rows of the contract-meeting lanes
  auto reduce = [&](int l, int x, bool valid) -> bool {
    const int gid = group_of(l, magic);
    int lo = valid ? x : INT_MAX, hi = valid ? x : INT_MIN;
    if (aligned) {
      for (int o = 1; o < group; o <<= 1) {
        lo = min(lo, __shfl_xor_sync(kFull, lo, o));
        hi = max(hi, __shfl_xor_sync(kFull, hi, o));
      }
      return valid && contract(lo, hi, window, wshift);
    }
    // segmented: fold the group's run within this warp into its head lane
    const int left = (gid + 1) * group - l;  // lanes of the group from l on
    for (int o = 1; o < 32; o <<= 1) {
      const int olo = __shfl_down_sync(kFull, lo, o), ohi = __shfl_down_sync(kFull, hi, o);
      if (lane + o < 32 && o < left) {
        lo = min(lo, olo);
        hi = max(hi, ohi);
      }
    }
    if (valid && (lane == 0 || l == gid * group)) {
      atomicMin(&s_min[gid], lo);
      atomicMax(&s_max[gid], hi);
    }
    return false;
  };
  if (VEC) {
    // item k of a thread: lanes 4 * (k/4 * kThreads + tid) + k%4
#pragma unroll
    for (int k4 = 0; k4 < kItems / 4; ++k4) {
      const int l = 4 * (k4 * kThreads + tid);
      if (l + 3 < cnt) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(tidx + l));
        v[4 * k4] = x.x;
        v[4 * k4 + 1] = x.y;
        v[4 * k4 + 2] = x.z;
        v[4 * k4 + 3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[4 * k4 + j] = l + j < cnt ? __ldg(tidx + l + j) : 0;
      }
    }
#pragma unroll
    for (int k4 = 0; k4 < kItems / 4; ++k4) {
      const int l = 4 * (k4 * kThreads + tid);
      if (4 * k4 * kThreads >= cnt) break;  // uniform over the block
      int lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = l + j < cnt ? v[4 * k4 + j] : INT_MAX;
        hi[j] = l + j < cnt ? v[4 * k4 + j] : INT_MIN;
      }
      if (group >= 2) {
        lo[0] = lo[1] = min(lo[0], lo[1]);
        hi[0] = hi[1] = max(hi[0], hi[1]);
        lo[2] = lo[3] = min(lo[2], lo[3]);
        hi[2] = hi[3] = max(hi[2], hi[3]);
      }
      if (group >= 4) {
        lo[0] = lo[1] = lo[2] = lo[3] = min(lo[0], lo[2]);
        hi[0] = hi[1] = hi[2] = hi[3] = max(hi[0], hi[2]);
      }
      for (int o = 1; o < group / 4; o <<= 1) {  // groups of 8, 16, 32 span threads
        lo[0] = lo[1] = lo[2] = lo[3] = min(lo[0], __shfl_xor_sync(kFull, lo[0], o));
        hi[0] = hi[1] = hi[2] = hi[3] = max(hi[0], __shfl_xor_sync(kFull, hi[0], o));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l + j < cnt && contract(lo[j], hi[j], window, wshift)) {
          ok |= 1u << (4 * k4 + j);
          lo_ok = min(lo_ok, v[4 * k4 + j]);
          hi_ok = max(hi_ok, v[4 * k4 + j]);
        }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int l = k * kThreads + tid;
      v[k] = l < cnt ? __ldg(tidx + l) : 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int l = k * kThreads + tid;
      if (k * kThreads >= cnt) break;  // uniform over the block
      if (reduce(l, v[k], l < cnt)) {
        ok |= 1u << k;
        lo_ok = min(lo_ok, v[k]);
        hi_ok = max(hi_ok, v[k]);
      }
    }
  }
  if (!aligned) {
    for (int l0 = kTile; l0 < cnt; l0 += kThreads)
      reduce(l0 + tid, l0 + tid < cnt ? __ldg(tidx + l0 + tid) : 0, l0 + tid < cnt);
    __syncthreads();
    // 2. the contract of unaligned groups, one thread per group
    for (int g = tid; g < ngroups; g += kThreads) {
      const int lo = s_min[g], hi = s_max[g];
      s_min[g] = contract(lo, hi, window, wshift);
      if (s_min[g]) {
        lo_ok = min(lo_ok, lo);
        hi_ok = max(hi_ok, hi);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo_ok = min(lo_ok, __shfl_xor_sync(kFull, lo_ok, o));
    hi_ok = max(hi_ok, __shfl_xor_sync(kFull, hi_ok, o));
  }
  if (lane == 0) {
    s_lo[warp] = lo_ok;
    s_hi[warp] = hi_ok;
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    lo_ok = min(lo_ok, s_lo[w]);
    hi_ok = max(hi_ok, s_hi[w]);
  }
  if (!aligned) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int l = k * kThreads + tid;
      if (l < cnt && s_min[group_of(l, magic)]) ok |= 1u << k;
    }
  }
  auto staged_group = [&](int l, int k) {
    return k < kItems ? (ok >> k & 1u) != 0 : s_min[group_of(l, magic)] != 0;
  };

  // 3. stage.  When the contract-meeting lanes' rows fit the budget, the
  //    span [lo_ok, hi_ok] is staged whole (contiguous offsets); otherwise
  //    the 32-row chunks they touch get slots, in row order, up to the budget
  const int base = VEC ? lo_ok & ~3 : lo_ok;  // first staged row of a whole span
  const bool whole = lo_ok != INT_MAX && (long long)hi_ok - base < kStageRows;
  const int chunk0 = lo_ok >> kChunkShift;
  int rows;
  if (whole && VEC) {
    rows = hi_ok - base + 1;
    for (int e = 4 * tid; e < rows; e += 4 * kThreads) {
      const long long row = (long long)base + e;
      if (row + 3 < V) {
        reinterpret_cast<uint4*>(stage)[e / 4] = __ldg(reinterpret_cast<const uint4*>(c0 + row));
        if (D == 2)
          reinterpret_cast<uint4*>(stage + kStageRows)[e / 4] =
              __ldg(reinterpret_cast<const uint4*>(c1 + row));
      } else {
        for (int j = 0; j < 4 && row + j < V; ++j) {
          stage[e + j] = __ldg(c0 + row + j);
          if (D == 2) stage[kStageRows + e + j] = __ldg(c1 + row + j);
        }
      }
    }
  } else if (whole) {
    rows = hi_ok - base + 1;
    for (int e = tid; e < rows; e += kThreads) {
      const long long row = (long long)base + e;
      stage[e] = __ldg(c0 + row * in_stride);
      if (D == 2) stage[kStageRows + e] = __ldg(c1 + row * in_stride);
    }
  } else {
    if (lo_ok != INT_MAX) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int c = (v[k] >> kChunkShift) - chunk0;
        if ((ok >> k & 1u) && c < kMapChunks) s_map[c] = 1;
      }
      for (int l = kTile + tid; l < cnt; l += kThreads) {
        const int c = (__ldg(tidx + l) >> kChunkShift) - chunk0;
        if (staged_group(l, kItems) && c < kMapChunks) s_map[c] = 1;
      }
    }
    __syncthreads();
    int flags[kMapPer];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kMapPer; ++k) {
      flags[k] = s_map[tid * kMapPer + k];
      sum += flags[k];
    }
    int inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += x;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    int before = inc - sum, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += s_warp[w];
      total += s_warp[w];
    }
#pragma unroll
    for (int k = 0; k < kMapPer; ++k) {
      const int c = tid * kMapPer + k;
      int slot = -1;
      if (flags[k]) {
        if (before < kStageChunks) {
          slot = before;
          s_chunk[slot] = c;
        }
        ++before;
      }
      s_map[c] = slot;
    }
    if (tid == 0) s_slots = min(total, kStageChunks);
    __syncthreads();
    rows = s_slots * kChunkRows;
    for (int e = tid; e < rows; e += kThreads) {
      const long long row = ((long long)chunk0 + s_chunk[e >> kChunkShift]) * kChunkRows +
                            (e & (kChunkRows - 1));
      if (row < V) {
        stage[e] = __ldg(c0 + row * in_stride);
        if (D == 2) stage[kStageRows + e] = __ldg(c1 + row * in_stride);
      }
    }
  }
  __syncthreads();

  // 4. serve: staged rows from shared memory, everything else from global
  auto fetch = [&](int x, bool staged, uint32_t& w0, uint32_t& w1) {
    int off = -1;
    if (staged && whole) {
      off = x - base;
    } else if (staged) {
      const int c = (x >> kChunkShift) - chunk0;
      const int slot = c < kMapChunks ? s_map[c] : -1;
      if (slot >= 0) off = slot * kChunkRows + (x & (kChunkRows - 1));
    }
    w1 = 0;
    if (off >= 0) {
      w0 = stage[off];
      if (D == 2) w1 = stage[kStageRows + off];
    } else {
      w0 = __ldg(c0 + (long long)x * in_stride);
      if (D == 2) w1 = __ldg(c1 + (long long)x * in_stride);
    }
  };
  auto serve = [&](int l, int x, bool staged) {
    uint32_t w0, w1;
    fetch(x, staged, w0, w1);
    const long long out = t0 + l;
    o0[out * out_stride] = w0;
    if (D == 2) o1[out * out_stride] = w1;
  };
  if (VEC) {
#pragma unroll
    for (int k4 = 0; k4 < kItems / 4; ++k4) {
      const int l = 4 * (k4 * kThreads + tid);
      if (l + 3 < cnt) {
        uint32_t w0[4], w1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fetch(v[4 * k4 + j], ok >> (4 * k4 + j) & 1u, w0[j], w1[j]);
        *reinterpret_cast<uint4*>(o0 + t0 + l) = make_uint4(w0[0], w0[1], w0[2], w0[3]);
        if (D == 2) *reinterpret_cast<uint4*>(o1 + t0 + l) = make_uint4(w1[0], w1[1], w1[2], w1[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (l + j < cnt) serve(l + j, v[4 * k4 + j], ok >> (4 * k4 + j) & 1u);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int l = k * kThreads + tid;
      if (l < cnt) serve(l, v[k], ok >> k & 1u);
    }
  }
  for (int l = kTile + tid; l < cnt; l += kThreads)
    serve(l, __ldg(tidx + l), staged_group(l, kItems));
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success) from the launch.
int iru_coalesced_gather(const void* c0, const void* c1, int in_stride, long long V,
                         const int* idx, long long n, void* o0, void* o1, int out_stride,
                         int group, int window, void* stream) {
  if (n <= 0) return 0;
  if (group < 1 || window < 1) return (int)cudaErrorInvalidValue;
  // a tile is a whole number of groups: kTile lanes of aligned groups; at
  // most kTile lanes and kMaxGroups groups of others; or one group when a
  // group is longer than kTile
  const long long tile = group > kTile        ? group
                         : (32 % group) == 0 ? kTile
                                             : (long long)std::min(kTile / group, kMaxGroups) * group;
  const long long grid = (n + tile - 1) / tile;
  int wshift = -1;
  if ((window & (window - 1)) == 0)
    for (wshift = 0; (1 << wshift) < window; ++wshift) {
    }
  const unsigned long long magic =
      group > kTile ? 0ull : ((1ull << 32) + (unsigned)group - 1) / (unsigned)group;
  const int smem = kStageRows * (c1 != nullptr ? 2 : 1) * (int)sizeof(uint32_t);
  const uintptr_t ptrs = (uintptr_t)c0 | (uintptr_t)c1 | (uintptr_t)idx | (uintptr_t)o0 |
                         (uintptr_t)o1;
  const bool vec = (32 % group) == 0 && in_stride == 1 && out_stride == 1 && (ptrs & 15) == 0;
  auto kernel = vec ? block_reuse_gather<true> : block_reuse_gather<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)c0, (const uint32_t*)c1, in_stride, V, idx, n, (uint32_t*)o0,
      (uint32_t*)o1, out_stride, group, window, wshift, (int)tile, magic);
  return (int)cudaGetLastError();
}

const char* iru_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
