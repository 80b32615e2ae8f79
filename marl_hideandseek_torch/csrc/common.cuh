// Shared device helpers for the port's kernels.
//
// Every helper copies the op order of the plain PyTorch version it
// mirrors (marl_hideandseek_torch/math3d.py, env/rays.py,
// env/physics.py). The libraries are built with --fmad=false, so each
// multiply and add rounds on its own as in PyTorch's elementwise ops.
#pragma once

#ifdef MHS_HOST_BUILD
// Host rehearsal build (g++ -x c++ -DMHS_HOST_BUILD): the device
// functions compile as plain C++ so their arithmetic can be checked
// against the plain PyTorch versions on a machine without a GPU.
#include <cmath>
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#else
#include <cuda_runtime.h>
#endif

#include <limits>

#ifndef MHS_HD
#define MHS_HD __host__ __device__ __forceinline__
#endif

namespace mhs {

// Compile-time capacity (config.py); live counts arrive at run time.
constexpr int MAX_BOXES = 9;
constexpr int MAX_RAMPS = 2;
constexpr int MAX_AGENTS = 6;
constexpr int MAX_BODIES = MAX_BOXES + MAX_RAMPS + MAX_AGENTS;
constexpr int MAX_WALLS = 36;
constexpr int MAX_PLANES = 3;
constexpr int N_VERTS = 8;

constexpr float RAY_EPS = 0x1.ad7f2ap-24f;           // float32(1e-7)
constexpr float F_INF = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

MHS_HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }

// Wedge halfspaces n . x <= d (env/rays.py WEDGE_NORMALS / OFFSETS), as
// the float32 values PyTorch rounds the Python constants to. Functions,
// not arrays: namespace-scope arrays are not visible in device code.
MHS_HD V3 wedge_normal(int f) {
  switch (f) {
    case 0: return V3{1.0f, 0.0f, 0.0f};
    case 1: return V3{-1.0f, 0.0f, 0.0f};
    case 2: return V3{0.0f, 1.0f, 0.0f};
    case 3: return V3{0.0f, 0.0f, -1.0f};
    default: return V3{0.0f, -0x1.1c01aap-1f, 0x1.aa028p-1f};
  }
}
MHS_HD float wedge_offset(int f) { return f == 4 ? 0x1.1c01aap-2f : 1.0f; }
MHS_HD float comp(V3 v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }
MHS_HD V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
MHS_HD V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
MHS_HD V3 scale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
MHS_HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
MHS_HD V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
MHS_HD float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
// torch.minimum / maximum propagate NaN; fminf / fmaxf do not. The
// kernels only see finite values or +-inf here.
MHS_HD float fmin2(float a, float b) { return a < b ? a : b; }
MHS_HD float fmax2(float a, float b) { return a > b ? a : b; }

// math3d.quat_rotate: v + 2 (w (u x v) + u x (u x v)).
MHS_HD V3 quat_rotate(Q4 q, V3 v) {
  V3 u = V3{q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return V3{v.x + 2.0f * (q.w * uv.x + uuv.x),
            v.y + 2.0f * (q.w * uv.y + uuv.y),
            v.z + 2.0f * (q.w * uv.z + uuv.z)};
}
// math3d.quat_inv: q * (1, -1, -1, -1).
MHS_HD Q4 quat_inv(Q4 q) { return Q4{q.w, -q.x, -q.y, -q.z}; }
MHS_HD V3 quat_rotate_inv(Q4 q, V3 v) { return quat_rotate(quat_inv(q), v); }

// math3d.quat_mul (Hamilton product a * b).
MHS_HD Q4 quat_mul(Q4 a, Q4 b) {
  return Q4{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
// math3d.quat_normalize: q / max(|q|, 1e-12).
MHS_HD Q4 quat_normalize(Q4 q) {
  float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  n = fmax2(n, 1e-12f);
  return Q4{q.w / n, q.x / n, q.y / n, q.z / n};
}

// ---- component form (math3d.qrot / qconj / qnorm / euler) -----------------

// math3d.qrot: v[i] + s * w * c[i] + 2 * d[i], s = -2 (inv) or 2.
MHS_HD V3 qrot_c(Q4 q, V3 v, bool inv) {
  V3 u = V3{q.x, q.y, q.z};
  V3 c = cross(u, v);
  V3 d = cross(u, c);
  float sw = (inv ? -2.0f : 2.0f) * q.w;
  return V3{v.x + sw * c.x + 2.0f * d.x, v.y + sw * c.y + 2.0f * d.y,
            v.z + sw * c.z + 2.0f * d.z};
}
MHS_HD Q4 qconj(Q4 q) { return Q4{q.w, -q.x, -q.y, -q.z}; }
MHS_HD Q4 qnorm(Q4 q) {
  float inv = rsqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z + 1e-12f);
  return Q4{q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}

// math3d.euler (quatToEuler): atan2f and asinf, as torch.atan2 and
// torch.asin compute them on the card; the pitch's clamp passes NaN.
MHS_HD V3 euler(Q4 q) {
  const float sinr = 2.0f * (q.w * q.x + q.y * q.z);
  const float cosr = 1.0f - 2.0f * (q.x * q.x + q.y * q.y);
  const float sinp = 2.0f * (q.w * q.y - q.z * q.x);
  const float clamped = sinp < -1.0f ? -1.0f : (sinp > 1.0f ? 1.0f : sinp);
  const float pitch = fabsf(sinp) >= 1.0f ? sgn(sinp) * 0x1.921fb6p+0f
                                          : asinf(clamped);
  const float siny = 2.0f * (q.w * q.z + q.x * q.y);
  const float cosy = 1.0f - 2.0f * (q.y * q.y + q.z * q.z);
  return V3{atan2f(sinr, cosr), pitch, atan2f(siny, cosy)};
}

// ---- rays (env/rays.py) ---------------------------------------------------
//
// Each test is split into the terms of the ray's origin and the work of
// its direction, so that a kernel that casts many rays from one origin
// (rgbd.cu: every pixel of an agent's eye) computes the origin's terms
// once. The whole tests are the two halves in turn: the same operations
// in the same order as the plain version's.

// An AABB's slab terms relative to a ray origin o: lo - o and hi - o
// per axis, and whether o lies outside the slab on that axis.
struct Slab {
  V3 a, b;
  bool ox, oy, oz;
};
MHS_HD Slab slab_terms(V3 o, V3 lo, V3 hi) {
  return Slab{sub(lo, o), sub(hi, o), (o.x < lo.x) || (o.x > hi.x),
              (o.y < lo.y) || (o.y > hi.y), (o.z < lo.z) || (o.z > hi.z)};
}

// One slab axis of ray_aabb from its origin terms.
MHS_HD void slab_axis(float a, float b, bool out, float d, float* near,
                      float* far) {
  bool small = fabsf(d) < RAY_EPS;
  float sd = small ? RAY_EPS : d;
  float t1 = a / sd;
  float t2 = b / sd;
  float n = fmin2(t1, t2);
  float f = fmax2(t1, t2);
  bool outside = small && out;
  *near = outside ? F_INF : n;
  *far = outside ? -F_INF : f;
}

// ray_aabb from the origin's slab terms: entry t, +inf on miss or origin
// inside.
MHS_HD float ray_slab(const Slab& s, V3 d) {
  float n0, f0, n1, f1, n2, f2;
  slab_axis(s.a.x, s.b.x, s.ox, d.x, &n0, &f0);
  slab_axis(s.a.y, s.b.y, s.oy, d.y, &n1, &f1);
  slab_axis(s.a.z, s.b.z, s.oz, d.z, &n2, &f2);
  float tmin = fmax2(fmax2(n0, n1), n2);
  float tmax = fmin2(fmin2(f0, f1), f2);
  bool hit = (tmax >= tmin) && (tmin > RAY_EPS);
  return hit ? tmin : F_INF;
}

// ray_aabb: entry t, +inf on miss or origin inside.
MHS_HD float ray_aabb(V3 o, V3 d, V3 lo, V3 hi) {
  return ray_slab(slab_terms(o, lo, hi), d);
}

// Wedge face f's numerator d_f - n_f . o for a local-frame origin.
MHS_HD float wedge_num(V3 o, int f) {
  const V3 wn = wedge_normal(f);
  return wedge_offset(f) - (o.x * wn.x + o.y * wn.y + o.z * wn.z);
}

// ray_convex over the wedge halfspaces from the origin's five face
// numerators, local-frame direction.
MHS_HD float ray_wedge_nums(const float* num, V3 d) {
  float t_in = -F_INF, t_out = F_INF;
  bool miss = false;
  for (int f = 0; f < 5; ++f) {
    const V3 wn = wedge_normal(f);
    float denom = d.x * wn.x + d.y * wn.y + d.z * wn.z;
    bool small = fabsf(denom) < RAY_EPS;
    float t = num[f] / (small ? RAY_EPS : denom);
    float te = (small || denom > 0.0f) ? -F_INF : t;
    float tx = (small || denom < 0.0f) ? F_INF : t;
    t_in = f == 0 ? te : fmax2(t_in, te);
    t_out = f == 0 ? tx : fmin2(t_out, tx);
    miss = miss || (small && num[f] < 0.0f);
  }
  bool hit = (t_out >= t_in) && (t_in > RAY_EPS) && !miss;
  return hit ? t_in : F_INF;
}

// ray_convex over the wedge halfspaces, local-frame ray.
MHS_HD float ray_wedge_local(V3 o, V3 d) {
  float num[5];
  for (int f = 0; f < 5; ++f) num[f] = wedge_num(o, f);
  return ray_wedge_nums(num, d);
}

// Ray against dynamic body b: OBB (boxes, agents) or wedge (ramps).
MHS_HD float ray_body(V3 o, V3 d, V3 c, Q4 q, V3 h, bool is_ramp) {
  V3 ol = quat_rotate_inv(q, sub(o, c));
  V3 dl = quat_rotate_inv(q, d);
  if (is_ramp) return ray_wedge_local(ol, dl);
  return ray_aabb(ol, dl, V3{-h.x, -h.y, -h.z}, h);
}

// ray_plane's numerator (pt - o) . n for origin o.
MHS_HD float plane_num(V3 o, V3 pt, V3 n) {
  V3 pm = sub(pt, o);
  return pm.x * n.x + pm.y * n.y + pm.z * n.z;
}

// ray_plane from the origin's numerator: one-sided.
MHS_HD float ray_plane_num(float num, V3 d, V3 n) {
  float denom = d.x * n.x + d.y * n.y + d.z * n.z;
  float t = num / (fabsf(denom) < RAY_EPS ? -RAY_EPS : denom);
  bool hit = (denom < -RAY_EPS) && (t > RAY_EPS);
  return hit ? t : F_INF;
}

// ray_plane: one-sided.
MHS_HD float ray_plane(V3 o, V3 d, V3 pt, V3 n) {
  return ray_plane_num(plane_num(o, pt, n), d, n);
}

}  // namespace mhs
