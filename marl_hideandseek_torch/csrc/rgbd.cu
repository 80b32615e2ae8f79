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
// Thread mapping: one thread per (world, pixel, agent); threadIdx.x is
// the world, so every load of the packed [..., W] inputs and every store
// of the [A, H*W, W] outputs is coalesced across a warp. A block holds 32
// worlds x 8 pixels: the 8 warps of a block read the same 32 worlds'
// geometry, the 7 after the first from L1. The wall loop stops at the
// batch's largest active-wall count (wall slots are densely packed).
//
// Bound: arithmetic. A pixel ray tests every active primitive of its
// world (about 12 bodies at ~100-160 operations, ~26 walls at ~44, a
// plane at ~20: ~2.5 K operations) and writes 8 bytes, so at 64x64
// pixels, 4 agents and 16,384 worlds a launch does ~0.7 T operations
// against 2.15 GB of output.

#include <cstddef>

#include "common.cuh"

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
  int W, img_h, img_w, n_body, ramp_lo, ramp_hi, agent_lo, n_agents, n_wall,
      n_plane;
  // tan(fov / 2) * aspect, tan(fov / 2), max depth (float32 values)
  float ha, half, max_depth;
};
constexpr int N_PTRS = 15;
constexpr int N_INTS = 10;
constexpr int N_FLOATS = 3;

constexpr int AGENT_HIDER = 1;

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

// Pixel p of agent a in world w.
MHS_HD void render_one(const RgbdArgs& A, int w, int p, int a) {
  const long long Wl = A.W;
  auto at3 = [&](const float* x, int i, int k) {
    return x[(static_cast<long long>(i) * 3 + k) * Wl + w];
  };
  auto ld3 = [&](const float* x, int i) {
    return V3{at3(x, i, 0), at3(x, i, 1), at3(x, i, 2)};
  };
  auto ld4 = [&](const float* x, int i) {
    return Q4{x[(i * 4LL + 0) * Wl + w], x[(i * 4LL + 1) * Wl + w],
              x[(i * 4LL + 2) * Wl + w], x[(i * 4LL + 3) * Wl + w]};
  };
  const int sa = A.agent_lo + a;

  // ---- camera ray (viz/rgbd.py camera_rays) ----
  const V3 ap = ld3(A.bpos, sa);
  const Q4 aq = ld4(A.bquat, sa);
  const V3 fwd = quat_rotate(aq, V3{0.0f, 1.0f, 0.0f});
  const V3 right = quat_rotate(aq, V3{1.0f, 0.0f, 0.0f});
  const int row = p / A.img_w;
  const int col = p - row * A.img_w;
  const float u = (static_cast<float>(col) + 0.5f) /
                      static_cast<float>(A.img_w) * 2.0f - 1.0f;
  const float v = 1.0f - (static_cast<float>(row) + 0.5f) /
                             static_cast<float>(A.img_h) * 2.0f;
  const float uh = u * A.ha;
  const float vh = v * A.half;
  V3 d = V3{(fwd.x + uh * right.x) + vh * 0.0f,
            (fwd.y + uh * right.y) + vh * 0.0f,
            (fwd.z + uh * right.z) + vh * 1.0f};
  const float dn = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
  d = V3{d.x / dn, d.y / dn, d.z / dn};
  const V3 o = V3{ap.x + 0.0f, ap.y + 0.0f, ap.z + 0.5f};

  // ---- nearest hit (env/rays.py raycast_world, max_t, self excluded) ----
  const float mt = A.max_depth;
  float tb = F_INF;
  int ib = -1;
  for (int b = 0; b < A.n_body; ++b) {
    if (!A.bact[b * Wl + w] || b == sa) continue;
    float t = ray_body(o, d, ld3(A.bpos, b), ld4(A.bquat, b), ld3(A.bhalf, b),
                       b >= A.ramp_lo && b < A.ramp_hi);
    if (t <= mt && t < tb) {
      tb = t;
      ib = b;
    }
  }
  const int n_wb = *A.wall_bound;
  for (int k = 0; k < n_wb; ++k) {
    if (!A.wact[k * Wl + w]) continue;
    V3 c = ld3(A.wpos, k);
    V3 h = ld3(A.whalf, k);
    float t = ray_aabb(o, d, sub(c, h), add(c, h));
    if (t <= mt && t < tb) {
      tb = t;
      ib = A.n_body + k;
    }
  }
  for (int q = 0; q < A.n_plane; ++q) {
    if (!A.pact[q * Wl + w]) continue;
    float t = ray_plane(o, d, ld3(A.ppt, q), ld3(A.pnrm, q));
    if (t <= mt && t < tb) {
      tb = t;
      ib = A.n_body + A.n_wall + q;
    }
  }

  // ---- normal and base colour of the hit (hit_normals, base_colors) ----
  const long long out = (static_cast<long long>(a) * A.img_h * A.img_w + p) *
                            Wl + w;
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
      const V3 c = ld3(A.bpos, ib);
      const Q4 q = ld4(A.bquat, ib);
      const V3 h = ld3(A.bhalf, ib);
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
      const bool locked = A.blocked[ib * Wl + w] != 0;
      if (ib >= A.agent_lo) {
        base = A.agent_type[(ib - A.agent_lo) * Wl + w] == AGENT_HIDER
                   ? HIDER : SEEKER;
      } else if (is_ramp) {
        base = locked ? RAMP_LOCKED : RAMP;
      } else {
        base = locked ? BOX_LOCKED : BOX;
      }
    } else if (ib < A.n_body + A.n_wall) {
      const int k = ib - A.n_body;
      const V3 c = ld3(A.wpos, k);
      const V3 h = ld3(A.whalf, k);
      n = dominant_normal(V3{(hp.x - c.x) / fmax2(h.x, 1e-6f),
                             (hp.y - c.y) / fmax2(h.y, 1e-6f),
                             (hp.z - c.z) / fmax2(h.z, 1e-6f)});
      base = WALL;
    } else {
      n = ld3(A.pnrm, ib - A.n_body - A.n_wall);
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
  A.rgba_out[out] = r | (g << 8) | (bl << 16) | 0xFF000000u;
  A.depth_out[out] = miss ? 0.0f : tb;
}

#ifndef MHS_HOST_BUILD
constexpr int WORLDS_PER_BLOCK = 32;
constexpr int PIXELS_PER_BLOCK = 8;

__global__ void rgbd_kernel(const RgbdArgs A) {
  const int w = blockIdx.y * WORLDS_PER_BLOCK + threadIdx.x;
  const int p = blockIdx.x * PIXELS_PER_BLOCK + threadIdx.y;
  if (w < A.W && p < A.img_h * A.img_w) render_one(A, w, p, blockIdx.z);
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

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entry: the same per-pixel code in a plain loop.
extern "C" int mhs_rgbd_host(void* const* ptrs, int n_ptrs, const int* ip,
                             int n_i, const float* fp, int n_f) {
  RgbdArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f)) return 1;
  for (int ag = 0; ag < a.n_agents; ++ag)
    for (int p = 0; p < a.img_h * a.img_w; ++p)
      for (int w = 0; w < a.W; ++w) render_one(a, w, p, ag);
  return 0;
}
#else
extern "C" int mhs_rgbd(void* const* ptrs, int n_ptrs, const int* ip, int n_i,
                        const float* fp, int n_f, void* stream) {
  RgbdArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int n_pix = a.img_h * a.img_w;
  dim3 block(WORLDS_PER_BLOCK, PIXELS_PER_BLOCK);
  dim3 grid((n_pix + PIXELS_PER_BLOCK - 1) / PIXELS_PER_BLOCK,
            (a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK, a.n_agents);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  rgbd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#endif
