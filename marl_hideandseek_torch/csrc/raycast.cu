// K1: nearest-hit raycast over packed worlds.
//
// Replaces the Pallas TPU kernel marl_hideandseek_tpu/ops/pallas_rays.py
// (_raycast_pallas -> pl.pallas_call, kernel _make_kernel), reached from
// raycast_batch_packed. Plain version: marl_hideandseek_torch/env/rays.py
// (raycast_world), whose op order this file copies.
//
// Thread mapping: one thread per (ray, world); blockIdx.y is the ray and
// consecutive threads take consecutive worlds, so every load of the packed
// [..., W] inputs is coalesced across a warp. The ragged edge is masked,
// so any W works. Each thread keeps a running (t, id) minimum over the
// bodies, walls and planes of its world, visiting them in id order with a
// strict "<", which is argmin's first-occurrence tie rule.
//
// Bound: the work per ray is about 60 primitive tests of tens of flops
// each, and the bytes are the per-world geometry (about 1.3 KB, read by
// every ray of the world and so served from L1/L2) plus 40 B in and 8 B
// out per ray. The kernel is bound by arithmetic, not memory.

#include "common.cuh"

using namespace mhs;

namespace {

struct RayArgs {
  const float* bpos;
  const float* bquat;
  const float* bhalf;
  const unsigned char* bact;
  const float* wpos;
  const float* whalf;
  const unsigned char* wact;
  const float* ppt;
  const float* pnrm;
  const unsigned char* pact;
  const float* orig;
  const float* dirs;
  const float* maxt;
  const int* excl;
  float* t_out;
  int* id_out;
  int W, R, n_body, ramp_lo, ramp_hi, n_wall, n_plane;
};

// Ray r of world w.
MHS_HD void raycast_one(const RayArgs& A, int r, int w) {
  const long long Wl = A.W;
  auto at3 = [&](const float* p, int i, int k) {
    return p[(static_cast<long long>(i) * 3 + k) * Wl + w];
  };
  V3 o = v3(at3(A.orig, r, 0), at3(A.orig, r, 1), at3(A.orig, r, 2));
  V3 d = v3(at3(A.dirs, r, 0), at3(A.dirs, r, 1), at3(A.dirs, r, 2));
  const float mt = A.maxt[r * Wl + w];
  const int ex = A.excl[r * Wl + w];

  float tb = F_INF;
  int ib = -1;
  // env/rays.py: out-of-range hits and the excluded id become +inf
  // before the argmin; a strict "<" in id order keeps the first minimum.
  for (int b = 0; b < A.n_body; ++b) {
    if (!A.bact[b * Wl + w] || b == ex) continue;
    V3 c = v3(at3(A.bpos, b, 0), at3(A.bpos, b, 1), at3(A.bpos, b, 2));
    Q4 q = Q4{A.bquat[(b * 4LL + 0) * Wl + w], A.bquat[(b * 4LL + 1) * Wl + w],
              A.bquat[(b * 4LL + 2) * Wl + w], A.bquat[(b * 4LL + 3) * Wl + w]};
    V3 h = v3(at3(A.bhalf, b, 0), at3(A.bhalf, b, 1), at3(A.bhalf, b, 2));
    float t = ray_body(o, d, c, q, h, b >= A.ramp_lo && b < A.ramp_hi);
    if (t <= mt && t < tb) {
      tb = t;
      ib = b;
    }
  }
  for (int k = 0; k < A.n_wall; ++k) {
    const int id = A.n_body + k;
    if (!A.wact[k * Wl + w] || id == ex) continue;
    V3 c = v3(at3(A.wpos, k, 0), at3(A.wpos, k, 1), at3(A.wpos, k, 2));
    V3 h = v3(at3(A.whalf, k, 0), at3(A.whalf, k, 1), at3(A.whalf, k, 2));
    float t = ray_aabb(o, d, sub(c, h), add(c, h));
    if (t <= mt && t < tb) {
      tb = t;
      ib = id;
    }
  }
  for (int p = 0; p < A.n_plane; ++p) {
    const int id = A.n_body + A.n_wall + p;
    if (!A.pact[p * Wl + w] || id == ex) continue;
    V3 pt = v3(at3(A.ppt, p, 0), at3(A.ppt, p, 1), at3(A.ppt, p, 2));
    V3 n = v3(at3(A.pnrm, p, 0), at3(A.pnrm, p, 1), at3(A.pnrm, p, 2));
    float t = ray_plane(o, d, pt, n);
    if (t <= mt && t < tb) {
      tb = t;
      ib = id;
    }
  }
  A.t_out[r * Wl + w] = tb;
  A.id_out[r * Wl + w] = tb < F_INF ? ib : -1;
}

#ifndef MHS_HOST_BUILD
__global__ void raycast_kernel(const RayArgs A) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < A.W) raycast_one(A, blockIdx.y, w);
}
#endif

RayArgs make_args(const float* bpos, const float* bquat, const float* bhalf,
                  const unsigned char* bact, const float* wpos,
                  const float* whalf, const unsigned char* wact,
                  const float* ppt, const float* pnrm,
                  const unsigned char* pact, const float* orig,
                  const float* dirs, const float* maxt, const int* excl,
                  float* t_out, int* id_out, int W, int R, int n_body,
                  int ramp_lo, int ramp_hi, int n_wall, int n_plane) {
  return RayArgs{bpos, bquat, bhalf, bact, wpos, whalf, wact, ppt,
                 pnrm, pact, orig, dirs, maxt, excl, t_out, id_out,
                 W, R, n_body, ramp_lo, ramp_hi, n_wall, n_plane};
}

}  // namespace

#define MHS_RAYCAST_PARAMS                                                   \
  const float *bpos, const float *bquat, const float *bhalf,                \
      const unsigned char *bact, const float *wpos, const float *whalf,     \
      const unsigned char *wact, const float *ppt, const float *pnrm,       \
      const unsigned char *pact, const float *orig, const float *dirs,      \
      const float *maxt, const int *excl, float *t_out, int *id_out, int W, \
      int R, int n_body, int ramp_lo, int ramp_hi, int n_wall, int n_plane
#define MHS_RAYCAST_ARGS                                                     \
  bpos, bquat, bhalf, bact, wpos, whalf, wact, ppt, pnrm, pact, orig, dirs, \
      maxt, excl, t_out, id_out, W, R, n_body, ramp_lo, ramp_hi, n_wall,    \
      n_plane

#ifdef MHS_HOST_BUILD
// Host rehearsal entry: the same per-ray code in a plain loop.
extern "C" int mhs_raycast_host(MHS_RAYCAST_PARAMS) {
  RayArgs a = make_args(MHS_RAYCAST_ARGS);
  for (int r = 0; r < R; ++r)
    for (int w = 0; w < W; ++w) raycast_one(a, r, w);
  return 0;
}
#else
extern "C" int mhs_raycast(MHS_RAYCAST_PARAMS, void* stream) {
  if (W <= 0 || R <= 0) return 0;
  if (R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  RayArgs a = make_args(MHS_RAYCAST_ARGS);
  const int threads = 128;
  dim3 grid((W + threads - 1) / threads, R);
  raycast_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif
