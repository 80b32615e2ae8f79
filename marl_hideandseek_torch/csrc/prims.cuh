// A world's primitives - dynamic bodies (OBBs and wedges), walls and
// planes - staged in shared memory from the packed layout, and their
// compaction to the active ones in id order: what raycast.cu (K1) and
// rgbd.cu (K5) test rays against. A block stages its worlds together
// (copy_in: consecutive threads on consecutive worlds of one row); then
// each world's warp compacts the world's active primitives, so that
// every lane's primitive loop runs over the same list, with no per-world
// activity test inside it.
#pragma once

#include <cstddef>

#include "lanes.cuh"

namespace mhs {

struct Prims {
  V3 pos[MAX_BODIES];
  Q4 quat[MAX_BODIES];
  V3 half[MAX_BODIES];
  V3 wpos[MAX_WALLS];
  V3 whalf[MAX_WALLS];
  V3 ppt[MAX_PLANES];
  V3 pn[MAX_PLANES];
  int atype[MAX_AGENTS];              // staged by K5 only
  unsigned char active[MAX_BODIES];
  unsigned char locked[MAX_BODIES];   // staged by K5 only
  unsigned char wact[MAX_WALLS];
  unsigned char pact[MAX_PLANES];
};

// The geometry of the packed layout: [n, 3 | 4, W] f32, [n, W] u8.
struct PrimPtrs {
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
};

#define MHS_PRIM(f) offsetof(Prims, f)

// The block's worlds' bodies, the first n_wall wall slots and the planes.
MHS_DEV void stage_prims(const PrimPtrs& P, const WorldBlock<Prims>& K,
                        int n_body, int n_wall, int n_plane) {
  copy_in(K, P.bpos, n_body * 3, MHS_PRIM(pos));
  copy_in(K, P.bquat, n_body * 4, MHS_PRIM(quat));
  copy_in(K, P.bhalf, n_body * 3, MHS_PRIM(half));
  copy_in(K, P.bact, n_body, MHS_PRIM(active));
  copy_in(K, P.wpos, n_wall * 3, MHS_PRIM(wpos));
  copy_in(K, P.whalf, n_wall * 3, MHS_PRIM(whalf));
  copy_in(K, P.wact, n_wall, MHS_PRIM(wact));
  copy_in(K, P.ppt, n_plane * 3, MHS_PRIM(ppt));
  copy_in(K, P.pnrm, n_plane * 3, MHS_PRIM(pn));
  copy_in(K, P.pact, n_plane, MHS_PRIM(pact));
}

struct PrimCounts {
  int n_b, n_w, n_p;
};

// One warp over world w: put_body(j, b) for each active body b with
// keep_body(b), put_wall(j, k) for each active wall k < n_wall with
// keep_wall(k), put_plane(j, p) for each active plane, j the rank in id
// order; the counts, on every lane, once every lane's puts are visible.
template <class KB, class PB, class KW, class PW, class PP>
MHS_DEV PrimCounts compact_prims(const Prims& w, int n_body, int n_wall,
                                int n_plane, KB&& keep_body, PB&& put_body,
                                KW&& keep_wall, PW&& put_wall,
                                PP&& put_plane) {
  PrimCounts c;
  c.n_b = compact(n_body, [&](int b) { return w.active[b] && keep_body(b); },
                  put_body);
  c.n_w = compact(n_wall, [&](int k) { return w.wact[k] && keep_wall(k); },
                  put_wall);
  c.n_p = compact(n_plane, [&](int p) { return w.pact[p] != 0; }, put_plane);
  warp_sync();
  return c;
}

}  // namespace mhs
