// Lanes, warps and blocks: how the kernels that run one warp per world
// (megastep.cu, raycast.cu, rgbd.cu) spread a world's work over a warp's
// lanes and load a block's worlds together.
//
// lanes(n, f): f(i) for every item i < n, item i on lane i % 32.
// lanes_any(n, f): f(i) for every item; true on every lane if any f(i).
// lane0(f): f() on lane 0.
// warp_sync(): the warp's barrier between phases.
// compact(n, keep, put): put(j, i) for every item i < n with keep(i), j
//   its rank among the kept items in index order; returns their count on
//   every lane. The warp calls it converged.
// block_items(n, f): f(i) for every i < n over the block's threads.
// block_warps(n, f): f(wi) on warp wi for every warp wi < n of the block.
// block_sync(): the block's barrier.
// copy_in / copy_out: rows x nw elements of the packed [rows, W] layout
//   between device memory and the block's per-world structs, consecutive
//   threads on consecutive worlds of one row, so accesses coalesce.
//
// Host build (-DMHS_HOST_BUILD): every helper runs its items one after
// another - the lanes of a phase, the block's load and store items, the
// block's warps. -DMHS_LANES_REVERSE runs each of them in reverse order,
// so a phase that reads what another lane or warp writes in the same
// phase (a missing barrier) shows as a difference between the orders.
#pragma once

#include <cstddef>

#include "common.cuh"

// Device code that calls the lane, warp or block helpers (plain C++ in
// the host build).
#define MHS_DEV __device__ __forceinline__

namespace mhs {

constexpr int WARP = 32;

#ifdef MHS_HOST_BUILD
#ifdef MHS_LANES_REVERSE
constexpr bool kReverse = true;
#else
constexpr bool kReverse = false;
#endif
inline int lane_at(int j) { return kReverse ? WARP - 1 - j : j; }
template <class F>
inline void lanes(int n, F&& f) {
  for (int j = 0; j < WARP; ++j)
    for (int i = lane_at(j); i < n; i += WARP) f(i);
}
template <class F>
inline bool lanes_any(int n, F&& f) {
  bool any = false;
  lanes(n, [&](int i) {
    if (f(i)) any = true;
  });
  return any;
}
template <class F>
inline void lane0(F&& f) {
  f();
}
inline void warp_sync() {}
constexpr int MAX_COMPACT = 8 * WARP;  // items a host compact takes
// Every lane's verdicts first, then every lane's writes, each in lane
// order, as the warp's ballot orders them.
template <class K, class P>
inline int compact(int n, K&& keep, P&& put) {
  bool kept[MAX_COMPACT] = {};
  int rank[MAX_COMPACT] = {};
  lanes(n, [&](int i) { kept[i] = keep(i); });
  int count = 0;
  for (int i = 0; i < n; ++i)
    if (kept[i]) rank[i] = count++;
  lanes(n, [&](int i) {
    if (kept[i]) put(rank[i], i);
  });
  return count;
}
template <class F>
inline void block_items(int n, F&& f) {
  for (int j = 0; j < n; ++j) f(kReverse ? n - 1 - j : j);
}
template <class F>
inline void block_warps(int n, F&& f) {
  for (int j = 0; j < n; ++j) f(kReverse ? n - 1 - j : j);
}
inline void block_sync() {}
#else
__device__ __forceinline__ int lane_id() { return threadIdx.x & (WARP - 1); }
template <class F>
__device__ __forceinline__ void lanes(int n, F&& f) {
  for (int i = lane_id(); i < n; i += WARP) f(i);
}
template <class F>
__device__ __forceinline__ bool lanes_any(int n, F&& f) {
  bool any = false;
  for (int i = lane_id(); i < n; i += WARP)
    if (f(i)) any = true;
  return __any_sync(0xffffffffu, any);
}
template <class F>
__device__ __forceinline__ void lane0(F&& f) {
  if (lane_id() == 0) f();
}
__device__ __forceinline__ void warp_sync() { __syncwarp(); }
template <class K, class P>
__device__ __forceinline__ int compact(int n, K&& keep, P&& put) {
  const unsigned int below = (1u << lane_id()) - 1u;
  int count = 0;
  for (int base = 0; base < n; base += WARP) {
    const int i = base + lane_id();
    const bool k = i < n && keep(i);
    const unsigned int m = __ballot_sync(0xffffffffu, k);
    if (k) put(count + __popc(m & below), i);
    count += __popc(m);
  }
  return count;
}
template <class F>
__device__ __forceinline__ void block_items(int n, F&& f) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) f(i);
}
template <class F>
__device__ __forceinline__ void block_warps(int n, F&& f) {
  const int wi = threadIdx.x / WARP;
  if (wi < n) f(wi);
}
__device__ __forceinline__ void block_sync() { __syncthreads(); }
#endif

// The block's worlds: w0 .. w0 + nw - 1 of W, in sw[0 .. nw).
template <class World>
struct WorldBlock {
  World* sw;
  long long W;
  int w0, nw;
};

template <class T, class World>
MHS_HD void copy_in(const WorldBlock<World>& K, const T* g, int rows,
                    size_t off) {
  block_items(rows * K.nw, [&](int i) {
    const int row = i / K.nw, wi = i - row * K.nw;
    reinterpret_cast<T*>(reinterpret_cast<char*>(K.sw + wi) + off)[row] =
        g[row * K.W + K.w0 + wi];
  });
}
template <class T, class World>
MHS_HD void copy_out(const WorldBlock<World>& K, T* g, int rows,
                     size_t off) {
  block_items(rows * K.nw, [&](int i) {
    const int row = i / K.nw, wi = i - row * K.nw;
    g[row * K.W + K.w0 + wi] =
        reinterpret_cast<const T*>(reinterpret_cast<const char*>(K.sw + wi) +
                                   off)[row];
  });
}

}  // namespace mhs
