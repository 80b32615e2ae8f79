// K1: nearest-hit raycast over packed worlds.
//
// Replaces the Pallas TPU kernel marl_hideandseek_tpu/ops/pallas_rays.py
// (_raycast_pallas -> pl.pallas_call, kernel _make_kernel), reached from
// raycast_batch_packed. Plain version: marl_hideandseek_torch/env/rays.py
// (raycast_world), whose op order this file copies.
//
// Mapping: one warp per world, WORLDS_PER_BLOCK = 4 consecutive worlds
// per block (measured faster than 8: more blocks resident, and the
// outputs are small). The block stages its worlds' geometry in shared
// memory once (prims.cuh: consecutive threads on consecutive worlds of
// one row, so the loads coalesce), and each world's warp compacts it to
// the world's
// active bodies, walls and planes in id order, with each wall's bounds
// c - h and c + h computed there. The compaction drops inactive wall
// slots, so the wall loop stops at the world's own active walls, at or
// below the batch's wall bound. The world's R rays then go over the
// warp's lanes in passes of 32: the block loads a pass's origins,
// directions, max_t and excluded ids of its worlds into a shared tile
// (consecutive threads on consecutive worlds, coalesced), each lane
// casts one ray over its world's list, and the block stores the pass's t
// and ids from a shared tile the same way. Every lane of a warp walks the
// same list, so the primitive loop does not diverge across worlds; each
// ray keeps a running (t, id) minimum, skips its own excluded id, and a
// strict "<" in id order keeps argmin's first occurrence, so ids and t
// equal the plain version's. The ragged edge of W is masked: any W works.
// (Two rays a lane, cast together, measured slower: their arrays went to
// local memory.)
//
// Bound: arithmetic. A ray tests every active primitive of its world
// (about 12 bodies at ~100-160 operations, ~15-26 walls at ~44, a plane
// at ~20: ~2-2.5 K operations, six IEEE divisions a box) and moves 40 B
// in and 8 B out; the geometry, ~1.6 KB a world, is read once per
// block. So the design keeps the primitive loop converged across a warp
// (one world), reads each primitive from shared memory, and tests only
// the active ones.

#include <cstddef>

#include "prims.cuh"

using namespace mhs;

namespace {

constexpr int WORLDS_PER_BLOCK = 4;
constexpr int BLOCK_THREADS = WORLDS_PER_BLOCK * WARP;
constexpr int PASS = WARP;                     // rays per lane pass
constexpr int TS = WORLDS_PER_BLOCK + 1;       // tile row stride (banks)

struct RayArgs {
  PrimPtrs g;
  const float* orig;
  const float* dirs;
  const float* maxt;
  const int* excl;
  float* t_out;
  int* id_out;
  int W, R, n_body, ramp_lo, ramp_hi, n_wall, n_plane;
};

// A world's active primitives in id order.
struct BodyRec {
  V3 c;
  Q4 q;
  V3 h;
  int id;
  bool ramp;
};
struct WallRec {
  V3 lo, hi;
  int id;
};
struct PlaneRec {
  V3 pt, n;
  int id;
};
struct View {
  BodyRec b[MAX_BODIES];
  WallRec wl[MAX_WALLS];
  PlaneRec p[MAX_PLANES];
  PrimCounts n;
};

// One pass of rays of the block's worlds, [ray][world].
struct RayTile {
  float o[3][PASS][TS];
  float d[3][PASS][TS];
  float mt[PASS][TS];
  int ex[PASS][TS];
  float t[PASS][TS];
  int id[PASS][TS];
};

struct Shared {
  Prims w[WORLDS_PER_BLOCK];
  View v[WORLDS_PER_BLOCK];
  RayTile tile;
};

// Warp wi: world wi's active primitives into its view.
MHS_DEV void build_view(const RayArgs& A, const Prims& w, View& v) {
  v.n = compact_prims(
      w, A.n_body, A.n_wall, A.n_plane, [](int) { return true; },
      [&](int j, int b) {
        v.b[j] = BodyRec{w.pos[b], w.quat[b], w.half[b], b,
                         b >= A.ramp_lo && b < A.ramp_hi};
      },
      [](int) { return true; },
      [&](int j, int k) {
        v.wl[j] = WallRec{sub(w.wpos[k], w.whalf[k]),
                          add(w.wpos[k], w.whalf[k]), A.n_body + k};
      },
      [&](int j, int p) {
        v.p[j] = PlaneRec{w.ppt[p], w.pn[p], A.n_body + A.n_wall + p};
      });
}

// The nearest hit of one ray over a view (env/rays.py: out-of-range hits
// and the excluded id become +inf before the argmin; a strict "<" in id
// order keeps the first minimum).
MHS_HD float cast(const View& v, V3 o, V3 d, float mt, int ex, int* id) {
  float tb = F_INF;
  int ib = -1;
  for (int j = 0; j < v.n.n_b; ++j) {
    const BodyRec& e = v.b[j];
    if (e.id == ex) continue;
    float t = ray_body(o, d, e.c, e.q, e.h, e.ramp);
    if (t <= mt && t < tb) {
      tb = t;
      ib = e.id;
    }
  }
  for (int j = 0; j < v.n.n_w; ++j) {
    const WallRec& e = v.wl[j];
    if (e.id == ex) continue;
    float t = ray_aabb(o, d, e.lo, e.hi);
    if (t <= mt && t < tb) {
      tb = t;
      ib = e.id;
    }
  }
  for (int j = 0; j < v.n.n_p; ++j) {
    const PlaneRec& e = v.p[j];
    if (e.id == ex) continue;
    float t = ray_plane(o, d, e.pt, e.n);
    if (t <= mt && t < tb) {
      tb = t;
      ib = e.id;
    }
  }
  *id = tb < F_INF ? ib : -1;
  return tb;
}

// The whole of one block: worlds w0 .. w0 + nw - 1, in shared memory S.
MHS_DEV void raycast_block(const RayArgs& A, Shared& S, int w0, int nw) {
  const WorldBlock<Prims> K{S.w, A.W, w0, nw};
  stage_prims(A.g, K, A.n_body, A.n_wall, A.n_plane);
  block_sync();
  block_warps(nw, [&](int wi) { build_view(A, S.w[wi], S.v[wi]); });
  RayTile& T = S.tile;
  const long long Wl = A.W;
  for (int r0 = 0; r0 < A.R; r0 += PASS) {
    const int nr = A.R - r0 < PASS ? A.R - r0 : PASS;
    // Item i: world i % 8 of ray (i / 8) % 32, its input row i / 256
    // (origin, direction, max_t, excluded id).
    block_items(8 * PASS * WORLDS_PER_BLOCK, [&](int i) {
      const int wi = i % WORLDS_PER_BLOCK;
      const int r = (i / WORLDS_PER_BLOCK) % PASS;
      const int k = i / (WORLDS_PER_BLOCK * PASS);
      if (wi >= nw || r >= nr) return;
      const long long w = w0 + wi, ray = r0 + r;
      if (k < 3) {
        T.o[k][r][wi] = A.orig[(ray * 3 + k) * Wl + w];
      } else if (k < 6) {
        T.d[k - 3][r][wi] = A.dirs[(ray * 3 + k - 3) * Wl + w];
      } else if (k == 6) {
        T.mt[r][wi] = A.maxt[ray * Wl + w];
      } else {
        T.ex[r][wi] = A.excl[ray * Wl + w];
      }
    });
    block_sync();
    block_warps(nw, [&](int wi) {
      const View& v = S.v[wi];
      lanes(nr, [&](int r) {
        const V3 o = v3(T.o[0][r][wi], T.o[1][r][wi], T.o[2][r][wi]);
        const V3 d = v3(T.d[0][r][wi], T.d[1][r][wi], T.d[2][r][wi]);
        int id;
        T.t[r][wi] = cast(v, o, d, T.mt[r][wi], T.ex[r][wi], &id);
        T.id[r][wi] = id;
      });
    });
    block_sync();
    // Item i: world i % 8 of ray i / 8, both outputs.
    block_items(PASS * WORLDS_PER_BLOCK, [&](int i) {
      const int wi = i % WORLDS_PER_BLOCK, r = i / WORLDS_PER_BLOCK;
      if (wi >= nw || r >= nr) return;
      const long long at = (r0 + r) * Wl + w0 + wi;
      A.t_out[at] = T.t[r][wi];
      A.id_out[at] = T.id[r][wi];
    });
    // The next pass's loads write only the input rows; its first barrier
    // orders this pass's stores before its casts overwrite t and id.
  }
}

#ifndef MHS_HOST_BUILD
__global__ void __launch_bounds__(BLOCK_THREADS)
    raycast_kernel(const RayArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w0 = blockIdx.x * WORLDS_PER_BLOCK;
  const int left = A.W - w0;
  raycast_block(A, *reinterpret_cast<Shared*>(smem), w0,
                left < WORLDS_PER_BLOCK ? left : WORLDS_PER_BLOCK);
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
  return RayArgs{PrimPtrs{bpos, bquat, bhalf, bact, wpos, whalf, wact, ppt,
                          pnrm, pact},
                 orig, dirs, maxt, excl, t_out, id_out,
                 W, R, n_body, ramp_lo, ramp_hi, n_wall, n_plane};
}

bool valid(const RayArgs& a) {
  return a.n_body <= MAX_BODIES && a.n_wall <= MAX_WALLS &&
         a.n_plane <= MAX_PLANES;
}

constexpr int SMEM_BYTES = static_cast<int>(sizeof(Shared));

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
// Host rehearsal entry: the same block code, the blocks one after
// another.
extern "C" int mhs_raycast_host(MHS_RAYCAST_PARAMS) {
  RayArgs a = make_args(MHS_RAYCAST_ARGS);
  if (!valid(a)) return 1;
  Shared* s = new Shared;
  for (int w0 = 0; w0 < W; w0 += WORLDS_PER_BLOCK)
    raycast_block(a, *s, w0,
                  W - w0 < WORLDS_PER_BLOCK ? W - w0 : WORLDS_PER_BLOCK);
  delete s;
  return 0;
}
#else
static int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      raycast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES));
}

extern "C" int mhs_raycast(MHS_RAYCAST_PARAMS, void* stream) {
  if (W <= 0 || R <= 0) return 0;
  RayArgs a = make_args(MHS_RAYCAST_ARGS);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int attr = allow_smem();
  if (attr != 0) return attr;
  const int blocks = (W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK;
  raycast_kernel<<<blocks, BLOCK_THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape and occupancy: out[0] worlds per block, out[1] shared
// bytes per block, out[2] resident blocks per SM.
extern "C" int mhs_raycast_occupancy(int* out) {
  out[0] = WORLDS_PER_BLOCK;
  out[1] = SMEM_BYTES;
  const int err = allow_smem();
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], raycast_kernel, BLOCK_THREADS, SMEM_BYTES));
}
#endif
