// K5: per-agent RGBD rendering over packed worlds.
//
// Replaces the Pallas TPU kernel marl_hideandseek_tpu/ops/pallas_rgbd.py
// (_rgbd_pallas -> pl.pallas_call, kernel _make_rgbd_kernel), reached from
// render_rgbd_packed_fast. Plain version:
// marl_hideandseek_torch/viz/rgbd.py (render_rgbd), whose op order this
// file copies: the camera ray of each pixel from the agent's eye (pos +
// 0.5 z, +y forward, world +z up), the nearest hit over the bodies (OBBs,
// wedges), the walls and the planes with the agent itself excluded, the
// hit face's normal from the hit point's dominant ratio, flat Lambert
// shading 0.45 + 0.55 |n . L| with the team / lock palette, sky and depth
// 0 on a miss. Channels truncate to integers as .to(torch.uint8) does.
//
// Mapping: one warp per (world, agent). A block holds WORLDS_PER_BLOCK
// consecutive worlds and one agent (grid: world groups x agents); the
// last group is masked, so any W works.
// 1. The block stages its worlds' geometry in shared memory (prims.cuh:
//    consecutive threads on consecutive worlds of one row, coalesced),
//    walls up to the batch's wall bound.
// 2. Each warp builds its (world, agent) view: the world's active
//    bodies but the agent's own, its active walls and planes, each with
//    the terms that depend only on the eye, computed once and not once
//    per pixel: a body's eye in its frame (ray_body's
//    quat_rotate_inv(q, o - c)) turned into its slab terms or its five
//    wedge numerators, a wall's c - h - o and c + h - o, a plane's
//    numerator (common.cuh's split tests), and each primitive's
//    bounding sphere relative to the eye. Primitives no camera ray can
//    hit are left out (the culls below).
// 3. The image goes in passes over tiles of 16 x 8 pixels. Per pass
//    each warp keeps the view's walls and bodies whose spheres reach
//    into the tile's frustum (the candidates; culls below) and puts its
//    128 pixels' directions and best hits in shared memory, 4 a lane.
//    Planes are tested by each pixel's lane. Per candidate, the warp
//    compacts the pixels whose rays pass the candidate's sphere test and
//    spreads their exact tests evenly over its 32 lanes, so no lane idles
//    while another finishes its own pixels. Every lane walks the same
//    list, so the loop does not diverge across worlds. Per pixel the
//    arithmetic is the plain version's: the camera ray, the rotation of
//    the direction into the body frame, the slab and wedge tests, the
//    normal rule and the shading. The list goes planes, then walls, then
//    bodies, so that the floor's hit bounds the rest early; a hit
//    replaces the best one if it is nearer, or as near with a smaller
//    id, which is argmin's first occurrence in any visiting order. So t,
//    the id and the colour equal the plain version's.
// 4. Each warp writes its pass into a shared tile [pixel][world]; the
//    block stores it with consecutive threads on consecutive worlds, 32 B
//    of a [A, H*W, W] row per 8 threads: whole sectors.
//
// The frames mode (rgbd_frames_kernel, mhs_rgbd_frames) renders the same
// pixels and stores them as the policy reads them: [W, A, 4, H, W]
// float32, channels R / 255, G / 255, B / 255 and depth / max_depth,
// each an IEEE float32 division (0 for a miss's depth). Its store puts
// consecutive threads on consecutive pixels of one world and channel: a
// pass's 8 pixels of a row are 32 B of a channel plane per 8 threads.
// The packed mode (rgbd_kernel, mhs_rgbd) is the same code with the
// packed store.
//
// Culls, exact: they drop only tests whose t could not be <= max_depth
// and win against the best hit so far. A primitive lies within its
// bounding sphere (centre c, radius |h| for a box, an agent or a wall,
// sqrt(6) for the unit wedge, which ray_body does not scale). A t the
// tests accept puts o + t d within delta of the primitive:
// the RAY_EPS substitution for a near-zero direction component (or wedge
// denominator) widens a slab or drops a wedge face by at most t RAY_EPS
// <= 2e-5 at t <= 200 (x 3.5 at the wedge's sharpest edge), and the
// rotation, subtractions and divisions round by about 30 ulp of
// |o - c| + t + |h|. Each sphere's reach is r + M, M = 1e-3 + 1e-4
// (|o - c| + r + max_depth): over 25x that delta, so for unit d the
// accepted t satisfies p - reach < t < p + reach, p = (c - o) . d, and
// the ray line passes within reach of c.
// - Per (world, agent): a sphere wholly beyond max_depth (|c - o| -
//   reach > max_depth), or wholly behind every camera ray: over the
//   pixel directions D = fwd + uh right + vh up (|uh| <= ha, |vh| <=
//   half), (c - o) . D is at most n_max = (c - o) . fwd + ha |(c - o) .
//   right| + half |(c - o).z|, and |D| at most |fwd| + ha |right| +
//   half; if n_max < 0 and n_max / that + reach < 0, every pixel's p +
//   reach < 0, so any t would be negative. With the eye inside the
//   sphere, p + reach > 0 for every direction: never culled.
// - Per pass (a tile of pixels): a sphere wholly outside one of the four
//   planes through the eye that bound the tile's camera rays (Frustum),
//   by reach plus a further 1e-3 + 1e-4 (|c - o| + max_depth) for the
//   rounding of the pixel directions and of the planes. Every plane
//   passes through the eye, so with the eye inside the sphere: never
//   culled.
// - Per pixel: p + reach < 0 (behind), |c - o|^2 - p^2 > reach^2 + 1e-4
//   |c - o|^2 (the line passes beside; the slack covers the rounding of
//   the difference, under 1e-6 |c - o|^2), or p - reach > tb (the
//   entry lies beyond the best hit). With the eye inside the sphere none
//   holds. Planes are never culled.
//
// Bound: a launch writes 8 B per pixel (2.15 GB at 16,384 worlds, 4
// agents, 64x64), ~0.65 ms at the card's memory rate, and its least
// arithmetic (the camera ray, one plane test and the shading of each hit
// pixel) takes about as long; every pixel testing every primitive would
// be ~13x that. The time goes to the primitive tests (IEEE divisions,
// --fmad=false) and their latency. So the design keeps each primitive
// loop converged across a warp (one world), computes the eye's terms
// once, reads each candidate once from shared memory for a warp's
// pixels, drops by exact culls the tests that cannot win, and spreads
// the exact tests left evenly over the lanes.

#include <cstddef>

#include "prims.cuh"

using namespace mhs;

namespace {

struct RgbdArgs {
  const float* bpos;
  const float* bquat;
  const float* bhalf;
  const unsigned char* bact;
  const unsigned char* blocked;
  const int* agent_type;  // [A, W]
  const float* wpos;
  const float* whalf;
  const unsigned char* wact;
  const float* ppt;
  const float* pnrm;
  const unsigned char* pact;
  const int* wall_bound;  // [1] batch-max active wall count
  unsigned int* rgba_out;  // [A, H*W, W]: R | G << 8 | B << 16 | 0xFF << 24
  float* depth_out;        // [A, H*W, W]
  float* frames_out;       // frames mode: [W, A, 4, H, W]
  int W, img_h, img_w, n_body, ramp_lo, ramp_hi, agent_lo, n_agents, n_wall,
      n_plane;
  // tan(fov / 2) * aspect, tan(fov / 2), max depth (float32 values)
  float ha, half, max_depth;
};
constexpr int N_PTRS = 16;
constexpr int N_INTS = 10;
constexpr int N_FLOATS = 3;

constexpr int AGENT_HIDER = 1;

constexpr int WORLDS_PER_BLOCK = 8;
constexpr int BLOCK_THREADS = WORLDS_PER_BLOCK * WARP;
// A pass is a tile of 16 x 8 pixels: pixel j * 32 + lane of it lies in
// the 8 x 4 block j (2 x 2 of them), so that a lane's pixels share 2
// columns and 2 rows.
constexpr int PIX_PER_LANE = 4;
constexpr int PASS = PIX_PER_LANE * WARP;      // pixels per warp pass
constexpr int PASS_W = 16, PASS_H = 8;
constexpr int TS = WORLDS_PER_BLOCK + 1;       // tile row stride (banks)

// The culls' margin (see the note above) and the wedge's radius.
constexpr float CULL_ABS = 1e-3f;
constexpr float CULL_REL = 1e-4f;
constexpr float WEDGE_REACH = 2.4494898f;      // sqrt(6), rounded up

struct Rgb {
  float r, g, b;
};
// Palette (viz/rgbd.py). A function, not constexpr objects: device code
// may not refer to a namespace-scope object of class type.
enum Colour { SKY, FLOOR, WALL, BOX, BOX_LOCKED, RAMP, RAMP_LOCKED, HIDER,
              SEEKER };
MHS_HD Rgb palette(int c) {
  switch (c) {
    case SKY: return Rgb{135.0f, 206.0f, 235.0f};
    case FLOOR: return Rgb{200.0f, 200.0f, 200.0f};
    case WALL: return Rgb{120.0f, 120.0f, 120.0f};
    case BOX: return Rgb{230.0f, 126.0f, 34.0f};
    case BOX_LOCKED: return Rgb{192.0f, 57.0f, 43.0f};
    case RAMP: return Rgb{155.0f, 89.0f, 182.0f};
    case RAMP_LOCKED: return Rgb{108.0f, 52.0f, 131.0f};
    case HIDER: return Rgb{39.0f, 174.0f, 96.0f};
    default: return Rgb{41.0f, 128.0f, 185.0f};
  }
}

// sign(r) on the first axis of largest |r| (argmax's first occurrence).
MHS_HD V3 dominant_normal(V3 r) {
  int ax = 0;
  float best = fabsf(r.x);
  if (fabsf(r.y) > best) {
    ax = 1;
    best = fabsf(r.y);
  }
  if (fabsf(r.z) > best) ax = 2;
  return V3{ax == 0 ? sgn(r.x) : 0.0f, ax == 1 ? sgn(r.y) : 0.0f,
            ax == 2 ? sgn(r.z) : 0.0f};
}

MHS_HD unsigned int channel(float c, float shade) {
  float v = fmin2(fmax2(c * shade, 0.0f), 255.0f);
  return static_cast<unsigned int>(v);
}

// ---- the camera and the culls ---------------------------------------------

// An agent's camera (viz/rgbd.py camera_rays): eye, forward and right.
struct Cam {
  V3 o, fwd, right;
  float ha, half, mt, d_max;
};

MHS_HD Cam make_cam(const RgbdArgs& A, const Prims& w, int sa) {
  const V3 ap = w.pos[sa];
  const Q4 aq = w.quat[sa];
  Cam c;
  c.o = V3{ap.x + 0.0f, ap.y + 0.0f, ap.z + 0.5f};
  c.fwd = quat_rotate(aq, V3{0.0f, 1.0f, 0.0f});
  c.right = quat_rotate(aq, V3{1.0f, 0.0f, 0.0f});
  c.ha = A.ha;
  c.half = A.half;
  c.mt = A.max_depth;
  c.d_max = sqrtf(dot(c.fwd, c.fwd)) + c.ha * sqrtf(dot(c.right, c.right)) +
            c.half;
  return c;
}

// Pixel (row, col)'s camera-plane offsets u tan(fov/2) aspect and
// v tan(fov/2), and its unit ray direction, in the plain version's op
// order.
MHS_HD float pixel_uh(const RgbdArgs& A, const Cam& c, int col) {
  const float u = (static_cast<float>(col) + 0.5f) /
                      static_cast<float>(A.img_w) * 2.0f - 1.0f;
  return u * c.ha;
}
MHS_HD float pixel_vh(const RgbdArgs& A, const Cam& c, int row) {
  const float v = 1.0f - (static_cast<float>(row) + 0.5f) /
                             static_cast<float>(A.img_h) * 2.0f;
  return v * c.half;
}

MHS_HD V3 camera_dir(const Cam& c, float uh, float vh) {
  V3 d = V3{(c.fwd.x + uh * c.right.x) + vh * 0.0f,
            (c.fwd.y + uh * c.right.y) + vh * 0.0f,
            (c.fwd.z + uh * c.right.z) + vh * 1.0f};
  const float dn = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  return V3{d.x / dn, d.y / dn, d.z / dn};
}

// A primitive's bounding sphere relative to the eye.
struct Sphere {
  V3 oc;        // centre - eye
  float reach;  // radius + margin
  float miss2;  // reach^2 + the slack of |oc|^2 - p^2
  float oc2;    // |oc|^2
};

MHS_HD Sphere sphere(const Cam& c, V3 centre, float radius) {
  const V3 oc = sub(centre, c.o);
  const float oc2 = dot(oc, oc);
  const float reach =
      radius + (CULL_ABS + CULL_REL * (sqrtf(oc2) + radius + c.mt));
  return Sphere{oc, reach, reach * reach + CULL_REL * oc2, oc2};
}

// No camera ray can hit inside s at t <= max_depth: s lies wholly beyond
// max_depth or wholly behind every camera ray.
MHS_HD bool out_of_view(const Cam& c, const Sphere& s) {
  if (sqrtf(s.oc2) - s.reach > c.mt) return true;
  const float n_max = dot(s.oc, c.fwd) + c.ha * fabsf(dot(s.oc, c.right)) +
                      c.half * fabsf(s.oc.z);
  return n_max < 0.0f && n_max / c.d_max + s.reach < 0.0f;
}

// Unit ray d can not hit inside s before tb: it passes wholly behind or
// beside s, or enters it beyond tb.
MHS_HD bool culled(const Sphere& s, V3 d, float tb) {
  const float p = s.oc.x * d.x + s.oc.y * d.y + s.oc.z * d.z;
  return p + s.reach < 0.0f || s.oc2 - p * p > s.miss2 || p - s.reach > tb;
}

// A pass's tile of pixels, rows row0..r1 and columns col0..c1, seen as
// the four planes through the eye that bound its camera rays: each pixel
// direction D = fwd + uh right + vh up has n . D >= 0 for every plane n,
// with uh from col0's to c1's and vh from r1's to row0's values. (With
// F = fwd, R = right, Z = up: ((F + U R) x Z) . D = (uh - U) (F x Z) . R
// and ((F + V Z) x R) . D = (vh - V) (F x R) . Z, whatever the angles
// between F, R and Z.)
struct Frustum {
  V3 n[4];
  float len[4];
  bool ok;  // the camera's axes span space well enough to bound it
};

MHS_HD Frustum tile_frustum(const RgbdArgs& A, const Cam& c, int row0,
                            int col0, int r1, int c1) {
  const V3 z = V3{0.0f, 0.0f, 1.0f};
  const float tau = dot(cross(c.fwd, z), c.right);
  const float sigma = dot(cross(c.fwd, c.right), z);
  const float st = tau > 0.0f ? 1.0f : -1.0f;
  const float ss = sigma > 0.0f ? 1.0f : -1.0f;
  const float u0 = pixel_uh(A, c, col0), u1 = pixel_uh(A, c, c1);
  const float v1 = pixel_vh(A, c, row0), v0 = pixel_vh(A, c, r1);
  Frustum f;
  f.n[0] = scale(cross(add(c.fwd, scale(c.right, u0)), z), st);
  f.n[1] = scale(cross(add(c.fwd, scale(c.right, u1)), z), -st);
  f.n[2] = scale(cross(add(c.fwd, scale(z, v0)), c.right), ss);
  f.n[3] = scale(cross(add(c.fwd, scale(z, v1)), c.right), -ss);
  for (int i = 0; i < 4; ++i) f.len[i] = sqrtf(dot(f.n[i], f.n[i]));
  f.ok = fabsf(tau) > 0.1f && fabsf(sigma) > 0.1f;
  return f;
}

// s lies wholly outside the tile's frustum, by a further margin that
// covers the rounding of the pixel directions and of the planes.
MHS_HD bool outside(const Frustum& f, const Cam& c, const Sphere& s) {
  if (!f.ok) return false;
  const float m = s.reach + CULL_ABS + CULL_REL * (sqrtf(s.oc2) + c.mt);
  for (int i = 0; i < 4; ++i)
    if (dot(f.n[i], s.oc) + m * f.len[i] < 0.0f) return true;
  return false;
}

#ifdef MHS_HOST_BUILD
// Host rehearsal only: how often each cull dropped a primitive or a test.
long long g_culls[2] = {0, 0};
inline void count_cull(int k) { ++g_culls[k]; }
#else
MHS_HD void count_cull(int) {}
#endif

// ---- a (world, agent) view -------------------------------------------------

// An active body but the agent's own, relative to the eye.
struct BodyTerms {
  Q4 q;
  union {
    Slab slab;     // a box or an agent: its slab terms at the eye
    float num[5];  // a ramp: its wedge numerators at the eye
  } u;
  Sphere s;
  int id;
  bool ramp;
};
struct WallTerms {
  Slab slab;
  Sphere s;
  int id;
};
struct PlaneTerms {
  V3 n;
  float num;
  int id;
};
struct View {
  BodyTerms b[MAX_BODIES];
  WallTerms wl[MAX_WALLS];
  PlaneTerms p[MAX_PLANES];
  PrimCounts n;
};

MHS_HD BodyTerms body_terms(const RgbdArgs& A, const Prims& w, const Cam& c,
                            int b) {
  BodyTerms e;
  e.q = w.quat[b];
  e.id = b;
  e.ramp = b >= A.ramp_lo && b < A.ramp_hi;
  const V3 h = w.half[b];
  const V3 ol = quat_rotate_inv(e.q, sub(c.o, w.pos[b]));
  if (e.ramp) {
    for (int f = 0; f < 5; ++f) e.u.num[f] = wedge_num(ol, f);
  } else {
    e.u.slab = slab_terms(ol, V3{-h.x, -h.y, -h.z}, h);
  }
  e.s = sphere(c, w.pos[b], e.ramp ? WEDGE_REACH : sqrtf(dot(h, h)));
  return e;
}

MHS_HD WallTerms wall_terms(const RgbdArgs& A, const Prims& w, const Cam& c,
                            int k) {
  const V3 wc = w.wpos[k], h = w.whalf[k];
  return WallTerms{slab_terms(c.o, sub(wc, h), add(wc, h)),
                   sphere(c, wc, sqrtf(dot(h, h))), A.n_body + k};
}

// Warp over world w for agent slot sa: the view's lists, culled.
MHS_DEV void build_view(const RgbdArgs& A, const Prims& w, const Cam& c,
                       int sa, int n_wb, View& v) {
  v.n = compact_prims(
      w, A.n_body, n_wb, A.n_plane,
      [&](int b) {
        if (b == sa) return false;
        if (!out_of_view(c, body_terms(A, w, c, b).s)) return true;
        count_cull(0);
        return false;
      },
      [&](int j, int b) { v.b[j] = body_terms(A, w, c, b); },
      [&](int k) {
        if (!out_of_view(c, wall_terms(A, w, c, k).s)) return true;
        count_cull(0);
        return false;
      },
      [&](int j, int k) { v.wl[j] = wall_terms(A, w, c, k); },
      [&](int j, int p) {
        v.p[j] = PlaneTerms{w.pn[p], plane_num(c.o, w.ppt[p], w.pn[p]),
                            A.n_body + A.n_wall + p};
      });
}

// ---- pixels ----------------------------------------------------------------

// A hit replaces the best one if nearer, or as near with a smaller id.
MHS_HD void take(float t, int id, float mt, float* tb, int* ib) {
  if (t <= mt && (t < *tb || (t == *tb && id < *ib))) {
    *tb = t;
    *ib = id;
  }
}

// The pixel's colour and depth from its nearest hit (hit_normals,
// base_colors, the shading), from the world's staged geometry.
MHS_HD void shade(const RgbdArgs& A, const Prims& w, V3 o, V3 d, float tb,
                  int ib, unsigned int* rgba, float* depth) {
  const bool miss = !(tb < F_INF);
  const Rgb sky = palette(SKY);
  unsigned int r = static_cast<unsigned int>(sky.r);
  unsigned int g = static_cast<unsigned int>(sky.g);
  unsigned int bl = static_cast<unsigned int>(sky.b);
  if (!miss) {
    const V3 hp = V3{o.x + d.x * tb, o.y + d.y * tb, o.z + d.z * tb};
    V3 n;
    int base;
    if (ib < A.n_body) {
      const V3 c = w.pos[ib];
      const Q4 q = w.quat[ib];
      const V3 h = w.half[ib];
      const V3 pl = quat_rotate_inv(q, sub(hp, c));
      V3 nl;
      const bool is_ramp = ib >= A.ramp_lo && ib < A.ramp_hi;
      if (is_ramp) {
        int best_f = 0;
        float best = 0.0f;
        for (int f = 0; f < 5; ++f) {
          const V3 wn = wedge_normal(f);
          float df = pl.x * wn.x + pl.y * wn.y + pl.z * wn.z - wedge_offset(f);
          if (f == 0 || df > best) {
            best = df;
            best_f = f;
          }
        }
        nl = wedge_normal(best_f);
      } else {
        nl = dominant_normal(V3{pl.x / fmax2(h.x, 1e-6f),
                                pl.y / fmax2(h.y, 1e-6f),
                                pl.z / fmax2(h.z, 1e-6f)});
      }
      n = quat_rotate(q, nl);
      const bool locked = w.locked[ib] != 0;
      if (ib >= A.agent_lo) {
        base = w.atype[ib - A.agent_lo] == AGENT_HIDER ? HIDER : SEEKER;
      } else if (is_ramp) {
        base = locked ? RAMP_LOCKED : RAMP;
      } else {
        base = locked ? BOX_LOCKED : BOX;
      }
    } else if (ib < A.n_body + A.n_wall) {
      const int k = ib - A.n_body;
      const V3 c = w.wpos[k];
      const V3 h = w.whalf[k];
      n = dominant_normal(V3{(hp.x - c.x) / fmax2(h.x, 1e-6f),
                             (hp.y - c.y) / fmax2(h.y, 1e-6f),
                             (hp.z - c.z) / fmax2(h.z, 1e-6f)});
      base = WALL;
    } else {
      n = w.pn[ib - A.n_body - A.n_wall];
      base = FLOOR;
    }
    const float ln = fmax2(sqrtf(n.x * n.x + n.y * n.y + n.z * n.z), 1e-6f);
    n = V3{n.x / ln, n.y / ln, n.z / ln};
    const float lam = fabsf(n.x * 0.408f + n.y * 0.408f + n.z * 0.816f);
    const float shade = 0.45f + 0.55f * lam;
    const Rgb c = palette(base);
    r = channel(c.r, shade);
    g = channel(c.g, shade);
    bl = channel(c.b, shade);
  }
  *rgba = r | (g << 8) | (bl << 16) | 0xFF000000u;
  *depth = miss ? 0.0f : tb;
}

// Pixel j * 32 + lane of the pass whose tile starts at (row0, col0).
struct Pix {
  int row, col;
};
MHS_HD Pix pass_pixel(int row0, int col0, int px) {
  const int j = px / WARP, lane = px % WARP;
  return Pix{row0 + (j / 2) * 4 + lane / 8, col0 + (j % 2) * 8 + lane % 8};
}

// One tile of results of the block's worlds, [pixel][world].
struct Tile {
  unsigned int rgba[PASS][TS];
  float depth[PASS][TS];
};

// A pass's candidates: the view's walls and bodies whose spheres reach
// into the pass's tile frustum, as indices into the view.
struct Cands {
  unsigned char w[MAX_WALLS];
  unsigned char b[MAX_BODIES];
  int n_w, n_b;
};

// A warp's pass: its pixels' directions and best hits, and the pixels
// that passed a candidate's sphere test.
struct PassPix {
  V3 d[PASS];
  float tb[PASS];
  int ib[PASS];
  unsigned char list[PASS];
};

struct Shared {
  Prims w[WORLDS_PER_BLOCK];
  View v[WORLDS_PER_BLOCK];
  Cands cand[WORLDS_PER_BLOCK];
  PassPix pix[WORLDS_PER_BLOCK];
  Tile tile;
};

// Warp wi's pass over the tile at (row0, col0), into the tile's column
// wi. Pixel px = j * 32 + lane is lane's j-th; pixels past the image's
// edge are cast as its last row or column and not stored. Per candidate,
// the warp keeps the pixels whose rays pass its sphere test (compact),
// then spreads their exact tests evenly over its lanes.
MHS_DEV void render_pass(const RgbdArgs& A, const Prims& w, const View& v,
                         const Cands& cd, const Cam& c, int row0, int col0,
                         int wi, PassPix& P, Tile& T) {
  const float mt = c.mt;
  lanes(WARP, [&](int lane) {
    // The lane's pixels lie in 2 columns and PIX_PER_LANE / 2 rows.
    float uh[2], vh[PIX_PER_LANE / 2];
    for (int i = 0; i < 2; ++i) {
      const int col = pass_pixel(row0, col0, i * WARP + lane).col;
      uh[i] = pixel_uh(A, c, col < A.img_w ? col : A.img_w - 1);
    }
    for (int i = 0; i < PIX_PER_LANE / 2; ++i) {
      const int row = pass_pixel(row0, col0, 2 * i * WARP + lane).row;
      vh[i] = pixel_vh(A, c, row < A.img_h ? row : A.img_h - 1);
    }
    for (int j = 0; j < PIX_PER_LANE; ++j) {
      const int px = j * WARP + lane;
      const V3 d = camera_dir(c, uh[j % 2], vh[j / 2]);
      float tb = F_INF;
      int ib = -1;
      for (int k = 0; k < v.n.n_p; ++k)
        take(ray_plane_num(v.p[k].num, d, v.p[k].n), v.p[k].id, mt, &tb, &ib);
      P.d[px] = d;
      P.tb[px] = tb;
      P.ib[px] = ib;
    }
  });
  warp_sync();
  for (int k = 0; k < cd.n_w; ++k) {
    const WallTerms& e = v.wl[cd.w[k]];
    const int n = compact(
        PASS,
        [&](int px) {
          if (!culled(e.s, P.d[px], P.tb[px])) return true;
          count_cull(1);
          return false;
        },
        [&](int j, int px) { P.list[j] = static_cast<unsigned char>(px); });
    warp_sync();
    lanes(n, [&](int j) {
      const int px = P.list[j];
      take(ray_slab(e.slab, P.d[px]), e.id, mt, &P.tb[px], &P.ib[px]);
    });
    warp_sync();
  }
  for (int k = 0; k < cd.n_b; ++k) {
    const BodyTerms& e = v.b[cd.b[k]];
    const int n = compact(
        PASS,
        [&](int px) {
          if (!culled(e.s, P.d[px], P.tb[px])) return true;
          count_cull(1);
          return false;
        },
        [&](int j, int px) { P.list[j] = static_cast<unsigned char>(px); });
    warp_sync();
    lanes(n, [&](int j) {
      const int px = P.list[j];
      const V3 dl = quat_rotate_inv(e.q, P.d[px]);
      take(e.ramp ? ray_wedge_nums(e.u.num, dl) : ray_slab(e.u.slab, dl),
           e.id, mt, &P.tb[px], &P.ib[px]);
    });
    warp_sync();
  }
  lanes(PASS, [&](int px) {
    shade(A, w, c.o, P.d[px], P.tb[px], P.ib[px], &T.rgba[px][wi],
          &T.depth[px][wi]);
  });
}

// The whole of one block: worlds w0 .. w0 + nw - 1 for agent a, in
// shared memory S; FRAMES picks the store.
template <bool FRAMES>
MHS_DEV void rgbd_block(const RgbdArgs& A, Shared& S, int w0, int nw, int a) {
  const WorldBlock<Prims> K{S.w, A.W, w0, nw};
  const int n_wb = *A.wall_bound;
  stage_prims(PrimPtrs{A.bpos, A.bquat, A.bhalf, A.bact, A.wpos, A.whalf,
                       A.wact, A.ppt, A.pnrm, A.pact},
              K, A.n_body, n_wb, A.n_plane);
  copy_in(K, A.blocked, A.n_body, MHS_PRIM(locked));
  copy_in(K, A.agent_type, A.n_agents, MHS_PRIM(atype));
  block_sync();
  const int sa = A.agent_lo + a;
  block_warps(nw, [&](int wi) {
    build_view(A, S.w[wi], make_cam(A, S.w[wi], sa), sa, n_wb, S.v[wi]);
  });
  const int n_pix = A.img_h * A.img_w;
  const int n_tx = (A.img_w + PASS_W - 1) / PASS_W;
  const int n_ty = (A.img_h + PASS_H - 1) / PASS_H;
  const long long Wl = A.W;
  Tile& T = S.tile;
  for (int q = 0; q < n_tx * n_ty; ++q) {
    const int row0 = (q / n_tx) * PASS_H, col0 = (q % n_tx) * PASS_W;
    const int r1 = (row0 + PASS_H < A.img_h ? row0 + PASS_H : A.img_h) - 1;
    const int c1 = (col0 + PASS_W < A.img_w ? col0 + PASS_W : A.img_w) - 1;
    block_warps(nw, [&](int wi) {
      const Cam c = make_cam(A, S.w[wi], sa);
      const Frustum f = tile_frustum(A, c, row0, col0, r1, c1);
      const View& v = S.v[wi];
      Cands& cd = S.cand[wi];
      auto keep = [&](const Sphere& sp) {
        if (!outside(f, c, sp)) return true;
        count_cull(0);
        return false;
      };
      cd.n_w = compact(v.n.n_w, [&](int k) { return keep(v.wl[k].s); },
                       [&](int j, int k) { cd.w[j] = k; });
      cd.n_b = compact(v.n.n_b, [&](int k) { return keep(v.b[k].s); },
                       [&](int j, int k) { cd.b[j] = k; });
      warp_sync();
      render_pass(A, S.w[wi], v, cd, c, row0, col0, wi, S.pix[wi], T);
    });
    block_sync();
    if constexpr (FRAMES) {
      // Item i: pixel i % PASS of world i / PASS, its four channels.
      block_items(PASS * WORLDS_PER_BLOCK, [&](int i) {
        const int wi = i / PASS, px = i % PASS;
        const Pix pq = pass_pixel(row0, col0, px);
        if (wi >= nw || pq.row >= A.img_h || pq.col >= A.img_w) return;
        const long long at =
            (static_cast<long long>(w0 + wi) * A.n_agents + a) * 4 * n_pix +
            pq.row * A.img_w + pq.col;
        const unsigned int c = T.rgba[px][wi];
        A.frames_out[at] = static_cast<float>(c & 0xFFu) / 255.0f;
        A.frames_out[at + n_pix] =
            static_cast<float>((c >> 8) & 0xFFu) / 255.0f;
        A.frames_out[at + 2 * n_pix] =
            static_cast<float>((c >> 16) & 0xFFu) / 255.0f;
        A.frames_out[at + 3 * n_pix] = T.depth[px][wi] / A.max_depth;
      });
    } else {
      // Item i: world i % 8 of pixel i / 8, both outputs.
      block_items(PASS * WORLDS_PER_BLOCK, [&](int i) {
        const int wi = i % WORLDS_PER_BLOCK, px = i / WORLDS_PER_BLOCK;
        const Pix pq = pass_pixel(row0, col0, px);
        if (wi >= nw || pq.row >= A.img_h || pq.col >= A.img_w) return;
        const long long at = (static_cast<long long>(a) * n_pix +
                              pq.row * A.img_w + pq.col) * Wl + w0 + wi;
        A.rgba_out[at] = T.rgba[px][wi];
        A.depth_out[at] = T.depth[px][wi];
      });
    }
    block_sync();
  }
}

#ifndef MHS_HOST_BUILD
// 3 blocks (24 worlds) an SM, as many as the shared memory allows.
__global__ void __launch_bounds__(BLOCK_THREADS, 3)
    rgbd_kernel(const RgbdArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w0 = blockIdx.x * WORLDS_PER_BLOCK;
  const int left = A.W - w0;
  rgbd_block<false>(A, *reinterpret_cast<Shared*>(smem), w0,
                    left < WORLDS_PER_BLOCK ? left : WORLDS_PER_BLOCK,
                    blockIdx.y);
}

// The frames mode: the same blocks, the policy's layout stored.
__global__ void __launch_bounds__(BLOCK_THREADS, 3)
    rgbd_frames_kernel(const RgbdArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w0 = blockIdx.x * WORLDS_PER_BLOCK;
  const int left = A.W - w0;
  rgbd_block<true>(A, *reinterpret_cast<Shared*>(smem), w0,
                   left < WORLDS_PER_BLOCK ? left : WORLDS_PER_BLOCK,
                   blockIdx.y);
}
#endif

bool fill_args(RgbdArgs* a, void* const* ptrs, int n_ptrs, const int* ip,
               int n_i, const float* fp, int n_f) {
  if (n_ptrs != N_PTRS || n_i != N_INTS || n_f != N_FLOATS) return false;
  void** dst = reinterpret_cast<void**>(a);
  for (int i = 0; i < N_PTRS; ++i) dst[i] = ptrs[i];
  a->W = ip[0];
  a->img_h = ip[1];
  a->img_w = ip[2];
  a->n_body = ip[3];
  a->ramp_lo = ip[4];
  a->ramp_hi = ip[5];
  a->agent_lo = ip[6];
  a->n_agents = ip[7];
  a->n_wall = ip[8];
  a->n_plane = ip[9];
  a->ha = fp[0];
  a->half = fp[1];
  a->max_depth = fp[2];
  return a->n_body <= MAX_BODIES && a->n_agents > 0 &&
         a->n_agents <= MAX_AGENTS && a->agent_lo + a->n_agents == a->n_body &&
         a->n_wall <= MAX_WALLS && a->n_plane <= MAX_PLANES &&
         a->img_h > 0 && a->img_w > 0;
}

static_assert(sizeof(void*) * N_PTRS == offsetof(RgbdArgs, W),
              "RgbdArgs pointer block must match N_PTRS");

constexpr int SMEM_BYTES = static_cast<int>(sizeof(Shared));

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entries: the same block code, the blocks one after
// another.
template <bool FRAMES>
int host_render(void* const* ptrs, int n_ptrs, const int* ip, int n_i,
                const float* fp, int n_f) {
  RgbdArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f)) return 1;
  Shared* s = new Shared;
  for (int ag = 0; ag < a.n_agents; ++ag)
    for (int w0 = 0; w0 < a.W; w0 += WORLDS_PER_BLOCK)
      rgbd_block<FRAMES>(
          a, *s, w0,
          a.W - w0 < WORLDS_PER_BLOCK ? a.W - w0 : WORLDS_PER_BLOCK, ag);
  delete s;
  return 0;
}

extern "C" int mhs_rgbd_host(void* const* ptrs, int n_ptrs, const int* ip,
                             int n_i, const float* fp, int n_f) {
  return host_render<false>(ptrs, n_ptrs, ip, n_i, fp, n_f);
}

extern "C" int mhs_rgbd_frames_host(void* const* ptrs, int n_ptrs,
                                    const int* ip, int n_i, const float* fp,
                                    int n_f) {
  return host_render<true>(ptrs, n_ptrs, ip, n_i, fp, n_f);
}

// Host rehearsal only: out[0] primitives left out of a (world, agent)
// view, out[1] pixel tests skipped, since the last call; resets both.
extern "C" void mhs_rgbd_host_culls(long long* out) {
  out[0] = g_culls[0];
  out[1] = g_culls[1];
  g_culls[0] = g_culls[1] = 0;
}
#else
static int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      rgbd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

extern "C" int mhs_rgbd(void* const* ptrs, int n_ptrs, const int* ip, int n_i,
                        const float* fp, int n_f, void* stream) {
  RgbdArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int attr = allow_smem();
  if (attr != 0) return attr;
  dim3 grid((a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK, a.n_agents);
  rgbd_kernel<<<grid, BLOCK_THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The frames mode's launch: the packed mode's grid and shared memory.
extern "C" int mhs_rgbd_frames(void* const* ptrs, int n_ptrs, const int* ip,
                               int n_i, const float* fp, int n_f,
                               void* stream) {
  RgbdArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int attr = static_cast<int>(cudaFuncSetAttribute(
      rgbd_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES));
  if (attr != 0) return attr;
  dim3 grid((a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK, a.n_agents);
  rgbd_frames_kernel<<<grid, BLOCK_THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape and occupancy: out[0] worlds per block, out[1] shared
// bytes per block, out[2] resident blocks per SM.
extern "C" int mhs_rgbd_occupancy(int* out) {
  out[0] = WORLDS_PER_BLOCK;
  out[1] = SMEM_BYTES;
  const int err = allow_smem();
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], rgbd_kernel, BLOCK_THREADS, SMEM_BYTES));
}
#endif
