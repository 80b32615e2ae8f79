// K4: the megastep - the whole packed env step before resets - and the
// K2 (physics) and K3 (physics + sweep) entries over the same device
// functions.
//
// Replaces the Pallas TPU kernels marl_hideandseek_tpu/ops/pallas_step.py
// (_megastep_pallas -> pl.pallas_call, kernel _make_megastep_kernel, rows
// _megastep_misc_layout; _fused_pallas, kernel _make_fused_kernel) and
// ops/pallas_physics.py (_physics_pallas), reached from megastep_packed,
// fused_step(_packed) and physics_step_batch. Plain versions:
// marl_hideandseek_torch/ops/step.py::megastep_plain, i.e. env/packed.py's
// step systems around ops/fused.py::fused_step_plain, which is
// env/physics.py followed by the plain sweep (env/observations.py +
// env/rays.py); ops/physics.py::physics_plain. This file copies their op
// order.
//
// K4 per world, in order: movement decode into force/torque, grab/lock on
// the carried interaction-ray hits, the XPBD physics step (per-vertex
// manifold at the predicted pose with a K-nearest candidate preselect,
// then the substeps: integrate, contact refresh, Jacobi position solve
// with positional static friction, grab joints, velocity reconstruction,
// dynamic friction and restitution velocity passes), the ray sweep on the
// post-physics pose (visibility, lidar, the next step's grab/lock rays,
// the seeker-sees-hider flag), agent zero-velocity, rewards, dones and
// episode scores. K3 is the physics step from given forces, then the
// sweep; K2 the physics step alone.
//
// Thread mapping: one thread per world; consecutive worlds in consecutive
// threads, so every load and store of the packed [..., W] layout is
// coalesced. The ragged edge is masked: any W works. Capacity is a
// compile-time maximum (common.cuh) with the live body/agent counts
// passed at run time, so one build serves every configuration.
//
// Bound: arithmetic. A world moves about 4.5 KB (state in; state, sweep
// and scores out) but does about 0.5 MFLOP (the manifold build, 4
// substeps over 8 contacts per body, ~190 rays against ~50 primitives).
// The physics and sweep bodies are __noinline__ device functions
// (physics_step, sweep) shared by the three entries, which keeps one
// short build. The per-world state (bodies, manifold, contacts) lives in
// local memory: register pressure is the expected limiter, and spills are
// accepted in this first, simple version.

#include <cstddef>

#include "common.cuh"

using namespace mhs;

namespace {

constexpr int AGENT_SEEKER = 0;
constexpr int AGENT_HIDER = 1;
constexpr int OWNER_NONE = 0;
constexpr int OWNER_SEEKER = 1;
constexpr int OWNER_HIDER = 2;
constexpr int KIND_NONE = 0;
constexpr int KIND_PLANE = 1;
constexpr int KIND_WALL = 2;
constexpr int KIND_PAIR = 3;
constexpr int K_WALL = 3;
constexpr int K_PAIR = 3;
constexpr int N_LIDAR = 30;
constexpr int MAX_TGT = (MAX_AGENTS - 1) + MAX_BOXES + MAX_RAMPS;
constexpr float CONTACT_MARGIN = 1.5f;
constexpr float VERT_INSET = 0.05f;
constexpr float MU_S_BODY = 0.5f;
constexpr float MU_S_STATIC = 2.0f;
constexpr float WEDGE_RADIUS = 0x1.3988e2p+1f;  // float32(sqrt(6))
// physics.py WEDGE_VERTS (slots 6-7: midpoints of the sloped edges).
MHS_HD V3 wedge_vert(int v) {
  switch (v) {
    case 0: return V3{1.0f, 1.0f, 1.0f};
    case 1: return V3{1.0f, 1.0f, -1.0f};
    case 2: return V3{1.0f, -2.0f, -1.0f};
    case 3: return V3{-1.0f, 1.0f, 1.0f};
    case 4: return V3{-1.0f, 1.0f, -1.0f};
    case 5: return V3{-1.0f, -2.0f, -1.0f};
    case 6: return V3{1.0f, -0.5f, 0.0f};
    default: return V3{-1.0f, -0.5f, 0.0f};
  }
}

// Pointer order = ops/step.py `ins`, then lidar_cs, then the outputs.
struct MegaArgs {
  const float* pos;
  const float* quat;
  const float* vel;
  const float* omega;
  const float* inv_mass;
  const float* inv_inertia;
  const unsigned char* active;
  const unsigned char* locked;
  const int* owner;
  const float* half_ext;
  const float* friction_mu;
  const float* wall_pos;
  const float* wall_half;
  const unsigned char* wall_active;
  const float* plane_point;
  const float* plane_normal;
  const unsigned char* plane_active;
  const int* g_target;
  const float* g_r2;
  const float* g_relq;
  const float* g_sep;
  const int* agent_type;
  const unsigned char* agent_active;
  const int* num_boxes;
  const int* num_ramps;
  const int* actions;
  const float* act_hit_t;
  const int* act_hit_id;
  const int* step;
  const unsigned char* seekers_first;
  const int* running;
  const float* finished;
  const int* wall_bound;  // [1] batch-max active wall count
  const float* lidar_cs;  // [2, 30] cos, sin of the lidar angles
  float* pos_o;
  float* quat_o;
  float* vel_o;
  float* omega_o;
  unsigned char* locked_o;
  int* owner_o;
  int* g_target_o;
  float* g_r2_o;
  float* g_relq_o;
  float* g_sep_o;
  float* vis_o;
  float* lidar_o;
  float* act_t_o;
  int* act_id_o;
  unsigned char* rew_seen_o;
  float* rewards_o;
  int* dones_o;
  float* team_r_o;
  int* running_o;
  float* finished_o;
  // ints
  int W, n_boxes, n_ramps, n_agents, n_wall, n_plane, n_tgt, zero_agent_vel,
      episode_len, n_sub, half_bucket, num_prep;
  // floats (each the float32 PyTorch rounds the Python constant to)
  float dt, h, f_per, t_per, two_over_h, restitution, rest_thresh,
      cos_half_fov, interact_len, lidar_range;
};
constexpr int N_PTRS = 54;
constexpr int N_INTS = 12;
constexpr int N_FLOATS = 10;

// K2 (physics) and K3 (physics + sweep): pointer order = ops/fused.py
// `step_inputs`, then the outputs. The physics entry passes the first
// N_PHYS_PTRS pointers; the sweep block stays null and its kernel never
// reads it (step_world<false>).
struct StepArgs {
  const float* pos;
  const float* quat;
  const float* vel;
  const float* omega;
  const float* inv_mass;
  const float* inv_inertia;
  const unsigned char* active;
  const unsigned char* locked;
  const float* half_ext;
  const float* friction_mu;
  const float* ext_force;
  const float* ext_torque;
  const float* wall_pos;
  const float* wall_half;
  const unsigned char* wall_active;
  const float* plane_point;
  const float* plane_normal;
  const unsigned char* plane_active;
  const int* g_target;
  const float* g_r2;
  const float* g_relq;
  const float* g_sep;
  float* pos_o;
  float* quat_o;
  float* vel_o;
  float* omega_o;
  // sweep block (fused entry only)
  const int* agent_type;
  const unsigned char* agent_active;
  const int* num_boxes;
  const int* num_ramps;
  const int* wall_bound;  // [1] batch-max active wall count
  const float* lidar_cs;  // [2, 30] cos, sin of the lidar angles
  float* vis_o;
  float* lidar_o;
  float* act_t_o;
  int* act_id_o;
  unsigned char* rew_seen_o;
  // ints
  int W, n_boxes, n_ramps, n_agents, n_wall, n_plane, n_tgt, n_sub;
  // floats (each the float32 PyTorch rounds the Python constant to)
  float dt, h, two_over_h, restitution, rest_thresh, cos_half_fov,
      interact_len, lidar_range;
};
constexpr int N_PHYS_PTRS = 26;
constexpr int N_FUSED_PTRS = 37;
constexpr int N_STEP_INTS = 8;
constexpr int N_STEP_FLOATS = 8;

// Scalars of the physics step and of the sweep, taken from any entry's
// arguments.
struct PhysParams {
  int n_sub;
  float dt, h, two_over_h, restitution, rest_thresh;
};
struct SweepParams {
  int n_tgt, n_boxes;
  float cos_half_fov, interact_len, lidar_range;
  const float* lidar_cs;
};
template <class Args>
MHS_HD PhysParams phys_params(const Args& A) {
  return PhysParams{A.n_sub, A.dt, A.h, A.two_over_h, A.restitution,
                    A.rest_thresh};
}
template <class Args>
MHS_HD SweepParams sweep_params(const Args& A) {
  return SweepParams{A.n_tgt, A.n_boxes, A.cos_half_fov, A.interact_len,
                     A.lidar_range, A.lidar_cs};
}

// ---- component-form helpers (math3d.qrot / qmul / qconj / qnorm) ---------

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

// ---- physics helpers (env/physics.py) -------------------------------------

MHS_HD float norm3(V3 v) { return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z); }

// apply_inv_inertia: R diag(inv) R^T u.
MHS_HD V3 aii(Q4 q, V3 inv, V3 u) {
  V3 ub = quat_rotate_inv(q, u);
  return quat_rotate(q, V3{inv.x * ub.x, inv.y * ub.y, inv.z * ub.z});
}

// apply_rot: normalize(q + (0.5 * (0, drot)) * q).
MHS_HD Q4 apply_rot(Q4 q, V3 drot) {
  Q4 dq = Q4{0.5f * 0.0f, 0.5f * drot.x, 0.5f * drot.y, 0.5f * drot.z};
  Q4 m = quat_mul(dq, q);
  return quat_normalize(Q4{q.w + m.w, q.x + m.x, q.y + m.y, q.z + m.z});
}

// aabb_sdf_normal.
MHS_HD float box_sdf(V3 rel, V3 h, V3* n) {
  float qx = fabsf(rel.x) - h.x;
  float qy = fabsf(rel.y) - h.y;
  float qz = fabsf(rel.z) - h.z;
  float sdf = fmax2(fmax2(qx, qy), qz);
  if (n != nullptr) {
    bool is_x = (qx >= qy) && (qx >= qz);
    bool is_y = !is_x && (qy >= qz);
    bool is_z = !(is_x || is_y);
    *n = V3{sgn(rel.x) * (is_x ? 1.0f : 0.0f), sgn(rel.y) * (is_y ? 1.0f : 0.0f),
            sgn(rel.z) * (is_z ? 1.0f : 0.0f)};
  }
  return sdf;
}

// convex_sdf_local: box, or wedge where is_ramp (blended face normals).
MHS_HD float convex_sdf(V3 p, V3 h, bool is_ramp, V3* n) {
  V3 bn;
  float bs = box_sdf(p, h, n != nullptr ? &bn : nullptr);
  float ds[5];
  for (int f = 0; f < 5; ++f) {
    const V3 wn = wedge_normal(f);
    ds[f] = p.x * wn.x + p.y * wn.y + p.z * wn.z - wedge_offset(f);
  }
  float ws = ds[0];
  for (int f = 1; f < 5; ++f) ws = fmax2(ws, ds[f]);
  if (n != nullptr) {
    float c[3];
    for (int k = 0; k < 3; ++k) {
      float acc = (ds[0] >= ws ? 1.0f : 0.0f) * comp(wedge_normal(0), k);
      for (int f = 1; f < 5; ++f)
        acc = acc + (ds[f] >= ws ? 1.0f : 0.0f) * comp(wedge_normal(f), k);
      c[k] = acc;
    }
    V3 wn = V3{c[0], c[1], c[2]};
    float len = fmax2(norm3(wn), 1e-9f);
    wn = V3{wn.x / len, wn.y / len, wn.z / len};
    *n = is_ramp ? wn : bn;
  }
  return is_ramp ? ws : bs;
}

// ---- per-world state ---------------------------------------------------------

struct Bodies {
  V3 pos[MAX_BODIES];
  Q4 quat[MAX_BODIES];
  V3 vel[MAX_BODIES];
  V3 omega[MAX_BODIES];
  V3 half[MAX_BODIES];
  V3 inv_i[MAX_BODIES];  // effective (0 unless dynamic)
  float inv_m[MAX_BODIES];  // effective
  float mu[MAX_BODIES];
  bool active[MAX_BODIES];
  bool dyn[MAX_BODIES];
};

struct Statics {
  V3 wpos[MAX_WALLS];
  V3 whalf[MAX_WALLS];
  bool wact[MAX_WALLS];
  V3 ppt[MAX_PLANES];
  V3 pn[MAX_PLANES];
  bool pact[MAX_PLANES];
  int n_wall, n_plane, wall_bound;
};

struct Grab {
  int target[MAX_AGENTS];
  V3 r2[MAX_AGENTS];
  Q4 relq[MAX_AGENTS];
  float sep[MAX_AGENTS];
};

struct Manifold {
  signed char kind[MAX_BODIES][N_VERTS];
  signed char nb[MAX_BODIES][N_VERTS];
  bool nb_ramp[MAX_BODIES][N_VERTS];
  V3 flat_n[MAX_BODIES][N_VERTS];
  V3 flat_pt[MAX_BODIES][N_VERTS];
  V3 wall_half[MAX_BODIES][N_VERTS];
  V3 nb_half[MAX_BODIES][N_VERTS];
  float mu[MAX_BODIES][N_VERTS];
};

struct Contacts {
  V3 p[MAX_BODIES][N_VERTS];
  V3 n[MAX_BODIES][N_VERTS];
  float lam[MAX_BODIES][N_VERTS];
  float w_n[MAX_BODIES][N_VERTS];
  bool mask[MAX_BODIES][N_VERTS];
};

struct Layout {
  int n_body, ramp_lo, ramp_hi, agent_lo, n_agents;
  MHS_HD bool is_ramp(int b) const { return b >= ramp_lo && b < ramp_hi; }
};

MHS_HD V3 vert_local(const Layout& L, const Bodies& B, int b, int v) {
  if (L.is_ramp(b)) return wedge_vert(v);
  // BOX_CORNER_SIGNS: bit 2 -> x, bit 1 -> y, bit 0 -> z.
  float sx = (v & 4) ? 1.0f : -1.0f;
  float sy = (v & 2) ? 1.0f : -1.0f;
  float sz = (v & 1) ? 1.0f : -1.0f;
  V3 h = B.half[b];
  return V3{h.x * sx, h.y * sy, h.z * sz};
}

MHS_HD V3 inset(V3 v) {
  return V3{v.x - VERT_INSET * sgn(v.x), v.y - VERT_INSET * sgn(v.y),
            v.z - VERT_INSET * sgn(v.z)};
}

// k smallest of lb[0..n) in (value, index) order; idx -1 past the end.
MHS_HD void select_smallest(const float* lb, int n, int k, float* out_lb,
                            int* out_idx) {
  float prev_lb = -F_INF;
  int prev_i = -1;
  for (int s = 0; s < k; ++s) {
    float best = F_INF;
    int best_i = -1;
    for (int i = 0; i < n; ++i) {
      bool after = (lb[i] > prev_lb) || (lb[i] == prev_lb && i > prev_i);
      if (after && (best_i < 0 || lb[i] < best)) {
        best = lb[i];
        best_i = i;
      }
    }
    out_lb[s] = best;
    out_idx[s] = best_i;
    prev_lb = best;
    prev_i = best_i;
  }
}

// build_manifold: per-vertex nearest surface at the predicted pose.
__device__ __noinline__ void build_manifold(const Layout& L, const Bodies& B,
                                            const Statics& S, const V3* pp,
                                            Manifold& M) {
  const int nbd = L.n_body;
  float r_bound[MAX_BODIES];
  for (int b = 0; b < nbd; ++b)
    r_bound[b] = L.is_ramp(b) ? WEDGE_RADIUS : norm3(B.half[b]);
  const int k_pair = K_PAIR < nbd - 1 ? K_PAIR : nbd - 1;

  for (int b = 0; b < nbd; ++b) {
    // Candidate preselect by centre lower bounds (stable order).
    float lbw[MAX_WALLS];
    for (int j = 0; j < S.n_wall; ++j) {
      lbw[j] = S.wact[j] ? box_sdf(sub(pp[b], S.wpos[j]), S.whalf[j], nullptr) -
                               r_bound[b]
                         : 1e9f;
    }
    float wsel_lb[K_WALL];
    int wsel[K_WALL];
    select_smallest(lbw, S.n_wall, K_WALL, wsel_lb, wsel);

    float lbp[MAX_BODIES];
    for (int j = 0; j < nbd; ++j) {
      bool ok = B.active[j] && j != b;
      lbp[j] = ok ? norm3(sub(pp[b], pp[j])) - r_bound[b] - r_bound[j] : 1e9f;
    }
    float psel_lb[K_PAIR];
    int psel[K_PAIR];
    select_smallest(lbp, nbd, k_pair, psel_lb, psel);

    const Q4 q = B.quat[b];
    for (int v = 0; v < N_VERTS; ++v) {
      V3 vl = vert_local(L, B, b, v);
      V3 vw = add(pp[b], quat_rotate(q, vl));
      V3 vw_in = add(pp[b], quat_rotate(q, inset(vl)));

      // Planes.
      float s_pl = 0.0f;
      int i_pl = 0;
      for (int p = 0; p < S.n_plane; ++p) {
        V3 rel = sub(vw, S.ppt[p]);
        float sdf = rel.x * S.pn[p].x + rel.y * S.pn[p].y + rel.z * S.pn[p].z;
        sdf = S.pact[p] ? sdf : 1e9f;
        if (p == 0 || sdf < s_pl) {
          s_pl = sdf;
          i_pl = p;
        }
      }
      // Walls (inset samples).
      float s_wl = 0.0f;
      int i_wl = 0;
      for (int k = 0; k < K_WALL; ++k) {
        float sdf = 1e9f;
        int j = wsel[k];
        if (wsel_lb[k] < 1e8f) sdf = box_sdf(sub(vw_in, S.wpos[j]), S.whalf[j], nullptr);
        if (k == 0 || sdf < s_wl) {
          s_wl = sdf;
          i_wl = k;
        }
      }
      // Pairs (inset samples).
      float s_pr = 0.0f;
      int i_pr = 0;
      for (int k = 0; k < k_pair; ++k) {
        float sdf = 1e9f;
        int j = psel[k];
        if (psel_lb[k] < 1e8f) {
          V3 pl = quat_rotate_inv(B.quat[j], sub(vw_in, pp[j]));
          sdf = convex_sdf(pl, B.half[j], L.is_ramp(j), nullptr);
        }
        if (k == 0 || sdf < s_pr) {
          s_pr = sdf;
          i_pr = k;
        }
      }
      float best = fmin2(fmin2(s_pl, s_wl), s_pr);
      bool is_plane = s_pl <= best;
      bool is_wall = !is_plane && (s_wl <= best);
      bool is_pair = !(is_plane || is_wall);
      bool valid = (best < CONTACT_MARGIN) && B.active[b];
      int kind = valid ? (is_plane ? KIND_PLANE : (is_wall ? KIND_WALL : KIND_PAIR))
                       : KIND_NONE;
      int wj = wsel[i_wl] < 0 ? 0 : wsel[i_wl];
      int pj = k_pair > 0 ? psel[i_pr] : -1;
      M.kind[b][v] = static_cast<signed char>(kind);
      M.flat_n[b][v] = S.pn[i_pl];
      M.flat_pt[b][v] = is_wall ? S.wpos[wj] : S.ppt[i_pl];
      V3 wh = S.whalf[wj];
      M.wall_half[b][v] = V3{fmax2(wh.x, 1e-3f), fmax2(wh.y, 1e-3f), fmax2(wh.z, 1e-3f)};
      M.nb[b][v] = static_cast<signed char>((is_pair && valid) ? pj : -1);
      V3 nh = pj >= 0 ? B.half[pj] : V3{1.0f, 1.0f, 1.0f};
      M.nb_half[b][v] = V3{fmax2(nh.x, 1e-3f), fmax2(nh.y, 1e-3f), fmax2(nh.z, 1e-3f)};
      M.nb_ramp[b][v] = pj >= 0 && L.is_ramp(pj);
      float mu_pr = pj >= 0 ? B.mu[pj] : 0.0f;
      M.mu[b][v] = is_pair ? fmax2(B.mu[b], mu_pr) : fmax2(B.mu[b], 2.0f);
    }
  }
  for (int b = nbd; b < MAX_BODIES; ++b)
    for (int v = 0; v < N_VERTS; ++v) M.kind[b][v] = KIND_NONE;
}

// Contact point, depth and normal of a manifold slot at pose (pos, quat);
// returns the mask. nb_pos / nb_quat: the neighbour's refreshed pose.
MHS_HD bool refresh_contact(const Layout& L, const Bodies& B, const Manifold& M,
                            const V3* pos, const Q4* quat, int b, int v,
                            V3* p_out, V3* n_out, float* depth_out) {
  int kind = M.kind[b][v];
  V3 vl = vert_local(L, B, b, v);
  V3 p_ex = add(pos[b], quat_rotate(quat[b], vl));
  V3 p_in = add(pos[b], quat_rotate(quat[b], inset(vl)));
  float depth;
  V3 n;
  if (kind == KIND_PLANE) {
    V3 dp = sub(p_ex, M.flat_pt[b][v]);
    V3 fn = M.flat_n[b][v];
    float d_plane = dp.x * fn.x + dp.y * fn.y + dp.z * fn.z;
    depth = -d_plane;
    n = fn;
    *p_out = p_ex;
  } else if (kind == KIND_WALL) {
    float sdf = box_sdf(sub(p_in, M.flat_pt[b][v]), M.wall_half[b][v], &n);
    depth = -sdf;
    *p_out = p_in;
  } else {
    int j = M.nb[b][v];
    Q4 nq = quat[j];
    V3 pl = quat_rotate_inv(nq, sub(p_in, pos[j]));
    V3 nl;
    float sdf = convex_sdf(pl, M.nb_half[b][v], M.nb_ramp[b][v], &nl);
    n = quat_rotate(nq, nl);
    depth = -sdf;
    *p_out = p_in;
  }
  *n_out = n;
  *depth_out = depth;
  return kind > 0 && depth > 0.0f;
}

// solve_grab_joints; adds the corrections into dpos / drot.
__device__ __noinline__ void grab_joints(const Layout& L, const Bodies& B,
                                         const Grab& G, const V3* pos,
                                         const Q4* quat, V3* dpos, V3* drot) {
  for (int a = 0; a < L.n_agents; ++a) {
    const int t = G.target[a];
    if (t < 0) continue;  // every term of a joint without target is zero
    const int sa = L.agent_lo + a;
    V3 x_a = pos[sa];
    Q4 q_a = quat[sa];
    V3 x_t = pos[t];
    Q4 q_t = quat[t];
    float w_t = B.inv_m[t];
    V3 ii_t = B.inv_i[t];
    float w_a = B.inv_m[sa];
    V3 ii_a = B.inv_i[sa];

    V3 r1 = V3{0.0f, 1.25f + G.sep[a], 0.5f};
    V3 p_a = add(x_a, quat_rotate(q_a, r1));
    V3 p_t = add(x_t, quat_rotate(q_t, G.r2[a]));
    V3 delta = sub(p_t, p_a);
    float c_len = norm3(delta);
    float cl = fmax2(c_len, 1e-9f);
    V3 nrm = V3{delta.x / cl, delta.y / cl, delta.z / cl};
    V3 r_a = sub(p_a, x_a);
    V3 r_t = sub(p_t, x_t);
    V3 ca = cross(r_a, nrm);
    V3 ct = cross(r_t, nrm);
    float gw_a = w_a + dot(ca, aii(q_a, ii_a, ca));
    float gw_t = w_t + dot(ct, aii(q_t, ii_t, ct));
    float w_sum = gw_a + gw_t;
    float lam = (w_sum > 1e-9f) ? c_len / fmax2(w_sum, 1e-9f) : 0.0f;
    V3 imp = scale(nrm, lam);

    V3 dpos_a = scale(imp, w_a);
    V3 nimp = V3{-imp.x, -imp.y, -imp.z};
    V3 dpos_t = scale(nimp, w_t);
    V3 drot_a = aii(q_a, ii_a, cross(r_a, imp));
    V3 drot_t = aii(q_t, ii_t, cross(r_t, nimp));

    Q4 rel_now = quat_mul(quat_inv(q_t), q_a);
    Q4 err = quat_mul(rel_now, quat_inv(G.relq[a]));
    float s = sgn(err.w);
    V3 th_l = V3{2.0f * err.x * s, 2.0f * err.y * s, 2.0f * err.z * s};
    V3 theta = quat_rotate(q_t, th_l);
    V3 ia_th = aii(q_a, ii_a, theta);
    V3 it_th = aii(q_t, ii_t, theta);
    float ang_w_a = dot(ia_th, theta);
    float ang_w_t = dot(it_th, theta);
    float tn2 = dot(theta, theta);
    float den = ang_w_a + ang_w_t;
    float sc = (den > 1e-9f && tn2 > 1e-12f) ? tn2 / fmax2(den, 1e-9f) : 0.0f;
    drot_a = sub(drot_a, scale(ia_th, sc));
    drot_t = add(drot_t, scale(it_th, sc));

    dpos[t] = add(dpos[t], dpos_t);
    drot[t] = add(drot[t], drot_t);
    dpos[sa] = add(dpos[sa], dpos_a);
    drot[sa] = add(drot[sa], drot_a);
  }
}

// physics_step: the manifold build and the substep loop; B.pos / quat /
// vel / omega hold the result.
__device__ __noinline__ void physics_step(const PhysParams& P,
                                          const Layout& L, Bodies& B,
                                          const Statics& S, const Grab& G,
                                          const V3* ext_f, const V3* ext_t,
                                          Manifold& M, Contacts& C) {
  const int nbd = L.n_body;
  const float h = P.h;
  V3 pp[MAX_BODIES];
  for (int b = 0; b < nbd; ++b) {
    // pos + (dt * vel) * dyn
    float df = B.dyn[b] ? 1.0f : 0.0f;
    V3 dv = V3{P.dt * B.vel[b].x * df, P.dt * B.vel[b].y * df,
               P.dt * B.vel[b].z * df};
    pp[b] = add(B.pos[b], dv);
  }
  build_manifold(L, B, S, pp, M);

  V3 pos_i[MAX_BODIES], vel_i[MAX_BODIES], om_i[MAX_BODIES];
  Q4 quat_i[MAX_BODIES];
  V3 pos_c[MAX_BODIES];
  Q4 quat_c[MAX_BODIES];
  const float half_h = 0.5f * h;

  for (int sub_i = 0; sub_i < P.n_sub; ++sub_i) {
    // ---- integrate ----
    for (int b = 0; b < nbd; ++b) {
      float mk = B.inv_m[b] > 0.0f ? 1.0f : 0.0f;
      float im = B.inv_m[b];
      V3 acc = V3{0.0f * mk + ext_f[b].x * im, 0.0f * mk + ext_f[b].y * im,
                  -9.8f * mk + ext_f[b].z * im};
      vel_i[b] = add(B.vel[b], scale(acc, h));
      V3 aa = aii(B.quat[b], B.inv_i[b], ext_t[b]);
      om_i[b] = add(B.omega[b], scale(aa, h));
      pos_i[b] = add(B.pos[b], scale(vel_i[b], h));
      // quat_integrate: normalize(q + (0.5 h) * ((0, omega) * q)).
      Q4 qm = quat_mul(Q4{0.0f, om_i[b].x, om_i[b].y, om_i[b].z}, B.quat[b]);
      Q4 q = B.quat[b];
      quat_i[b] = quat_normalize(Q4{q.w + half_h * qm.w, q.x + half_h * qm.x,
                                    q.y + half_h * qm.y, q.z + half_h * qm.z});
    }

    // ---- refresh + Jacobi position solve ----
    V3 sum_imp[MAX_BODIES], drot_a[MAX_BODIES], sc_pos[MAX_BODIES],
        sc_rot[MAX_BODIES], sum_imp_t[MAX_BODIES], drot_t[MAX_BODIES];
    float cnt_a[MAX_BODIES], cnt_s[MAX_BODIES];
    for (int b = 0; b < nbd; ++b) {
      sum_imp[b] = drot_a[b] = sc_pos[b] = sc_rot[b] = sum_imp_t[b] =
          drot_t[b] = V3{0.0f, 0.0f, 0.0f};
      cnt_a[b] = cnt_s[b] = 0.0f;
    }
    for (int b = 0; b < nbd; ++b) {
      for (int v = 0; v < N_VERTS; ++v) {
        C.mask[b][v] = false;
        C.lam[b][v] = 0.0f;
        C.w_n[b][v] = 0.0f;
        if (M.kind[b][v] == KIND_NONE) continue;
        V3 p, n;
        float depth;
        bool mask = refresh_contact(L, B, M, pos_i, quat_i, b, v, &p, &n, &depth);
        C.p[b][v] = p;
        C.n[b][v] = n;
        C.mask[b][v] = mask;
        if (!mask) continue;
        const int kind = M.kind[b][v];
        const bool is_pair = kind == KIND_PAIR;
        const int j = M.nb[b][v];
        float nb_w = is_pair ? B.inv_m[j] : 0.0f;
        V3 nb_ii = is_pair ? B.inv_i[j] : V3{0.0f, 0.0f, 0.0f};
        V3 nb_pos = is_pair ? pos_i[j] : V3{1e6f, 1e6f, 1e6f};
        Q4 nb_q = is_pair ? quat_i[j] : Q4{1.0f, 0.0f, 0.0f, 0.0f};
        Q4 q_a = quat_i[b];
        V3 ii_a = B.inv_i[b];
        V3 r_a = sub(p, pos_i[b]);
        V3 r_b = sub(p, nb_pos);
        V3 rxn_a = cross(r_a, n);
        float w_ang_a = dot(rxn_a, aii(q_a, ii_a, rxn_a));
        float w_ang_b = 0.0f;
        if (is_pair) {
          V3 rxn_b = cross(r_b, n);
          w_ang_b = dot(rxn_b, aii(nb_q, nb_ii, rxn_b));
        }
        float w_sum = B.inv_m[b] + w_ang_a + nb_w + w_ang_b;
        float lam = (w_sum > 1e-9f) ? depth / fmax2(w_sum, 1e-9f) : 0.0f;
        C.lam[b][v] = lam;
        C.w_n[b][v] = w_sum;
        V3 imp = scale(n, lam);

        // Positional static friction vs a stationary neighbour.
        V3 vl = vert_local(L, B, b, v);
        V3 v_eval = kind == KIND_PLANE ? vl : inset(vl);
        V3 p_prev_a = add(B.pos[b], quat_rotate(B.quat[b], v_eval));
        V3 dp = sub(p, p_prev_a);
        float dpn = dot(dp, n);
        V3 dpt = sub(dp, scale(n, dpn));
        float dpt_len = norm3(dpt);
        float dl = fmax2(dpt_len, 1e-9f);
        V3 t_dir = V3{dpt.x / dl, dpt.y / dl, dpt.z / dl};
        V3 rxt_a = cross(r_a, t_dir);
        float w_t = B.inv_m[b] + nb_w + dot(rxt_a, aii(q_a, ii_a, rxt_a));
        float lam_t = dpt_len / fmax2(w_t, 1e-9f);
        float mu_s = is_pair ? MU_S_BODY : MU_S_STATIC;
        bool static_ok = (lam > 0.0f) && (w_t > 1e-9f);
        float lam_tc = fmin2(lam_t, mu_s * lam);
        float nl = -(static_ok ? lam_tc : 0.0f);
        V3 imp_t = scale(t_dir, nl);

        sum_imp[b] = add(sum_imp[b], imp);
        drot_a[b] = add(drot_a[b], aii(q_a, ii_a, cross(r_a, imp)));
        sum_imp_t[b] = add(sum_imp_t[b], imp_t);
        drot_t[b] = add(drot_t[b], aii(q_a, ii_a, cross(r_a, imp_t)));
        cnt_a[b] = cnt_a[b] + 1.0f;
        if (is_pair) {
          V3 nimp = V3{-imp.x, -imp.y, -imp.z};
          sc_pos[j] = add(sc_pos[j], scale(nimp, nb_w));
          sc_rot[j] = add(sc_rot[j], aii(nb_q, nb_ii, cross(r_b, nimp)));
          cnt_s[j] = cnt_s[j] + 1.0f;
        }
      }
    }
    for (int b = 0; b < nbd; ++b) {
      float cnt = cnt_a[b] + cnt_s[b];
      float nrm = 1.0f / fmax2(cnt, 1.0f);
      V3 dpos = add(scale(sum_imp[b], B.inv_m[b]), sc_pos[b]);
      V3 drot = add(drot_a[b], sc_rot[b]);
      V3 dpos_t = scale(sum_imp_t[b], B.inv_m[b]);
      pos_c[b] = add(add(pos_i[b], scale(dpos, nrm)), dpos_t);
      quat_c[b] = apply_rot(quat_i[b], add(scale(drot, nrm), drot_t[b]));
    }

    // ---- grab joints ----
    V3 dpos_j[MAX_BODIES], drot_j[MAX_BODIES];
    for (int b = 0; b < nbd; ++b) dpos_j[b] = drot_j[b] = V3{0.0f, 0.0f, 0.0f};
    grab_joints(L, B, G, pos_c, quat_c, dpos_j, drot_j);
    for (int b = 0; b < nbd; ++b) {
      pos_c[b] = add(pos_c[b], dpos_j[b]);
      quat_c[b] = apply_rot(quat_c[b], drot_j[b]);
    }

    // ---- velocities from positions ----
    V3 vel_n[MAX_BODIES], om_n[MAX_BODIES];
    for (int b = 0; b < nbd; ++b) {
      V3 d = sub(pos_c[b], B.pos[b]);
      vel_n[b] = V3{d.x / h, d.y / h, d.z / h};
      Q4 dq = quat_mul(quat_c[b], quat_inv(B.quat[b]));
      float s = sgn(dq.w);
      om_n[b] = V3{P.two_over_h * dq.x * s, P.two_over_h * dq.y * s,
                   P.two_over_h * dq.z * s};
    }

    // ---- velocity passes: dynamic friction + restitution ----
    V3 fsum[MAX_BODIES], fdom[MAX_BODIES], fsc_v[MAX_BODIES], fsc_o[MAX_BODIES],
        rsum[MAX_BODIES], rdom[MAX_BODIES];
    float fcnt_a[MAX_BODIES], fcnt_s[MAX_BODIES];
    for (int b = 0; b < nbd; ++b) {
      fsum[b] = fdom[b] = fsc_v[b] = fsc_o[b] = rsum[b] = rdom[b] =
          V3{0.0f, 0.0f, 0.0f};
      fcnt_a[b] = fcnt_s[b] = 0.0f;
    }
    for (int b = 0; b < nbd; ++b) {
      for (int v = 0; v < N_VERTS; ++v) {
        if (!C.mask[b][v]) continue;
        const float lam = C.lam[b][v];
        const bool is_pair = M.kind[b][v] == KIND_PAIR;
        const int j = M.nb[b][v];
        const V3 p = C.p[b][v];
        const V3 n = C.n[b][v];
        float nb_w = is_pair ? B.inv_m[j] : 0.0f;
        V3 nb_ii = is_pair ? B.inv_i[j] : V3{0.0f, 0.0f, 0.0f};
        V3 nb_pos = is_pair ? pos_i[j] : V3{1e6f, 1e6f, 1e6f};
        Q4 nb_q = is_pair ? quat_i[j] : Q4{1.0f, 0.0f, 0.0f, 0.0f};
        V3 nb_vel = is_pair ? vel_n[j] : V3{0.0f, 0.0f, 0.0f};
        V3 nb_om = is_pair ? om_n[j] : V3{0.0f, 0.0f, 0.0f};
        Q4 q_a = quat_c[b];
        V3 ii_a = B.inv_i[b];
        V3 r_a = sub(p, pos_c[b]);
        V3 r_b = sub(p, nb_pos);
        V3 v_a = add(vel_n[b], cross(om_n[b], r_a));
        V3 v_b = add(nb_vel, cross(nb_om, r_b));

        if (lam > 0.0f) {  // dynamic friction
          V3 v_rel = sub(v_a, v_b);
          float vn = dot(v_rel, n);
          V3 v_t = sub(v_rel, scale(n, vn));
          float vt_len = norm3(v_t);
          float tl = fmax2(vt_len, 1e-9f);
          V3 t_dir = V3{v_t.x / tl, v_t.y / tl, v_t.z / tl};
          V3 rxt_a = cross(r_a, t_dir);
          float w_sum = B.inv_m[b] + nb_w + dot(rxt_a, aii(q_a, ii_a, rxt_a));
          if (is_pair) {
            V3 rxt_b = cross(r_b, t_dir);
            w_sum = w_sum + dot(rxt_b, aii(nb_q, nb_ii, rxt_b));
          }
          w_sum = fmax2(w_sum, 1e-9f);
          float jf = fmin2(vt_len / w_sum, M.mu[b][v] * lam / h);
          V3 imp = scale(t_dir, -jf);
          fsum[b] = add(fsum[b], imp);
          fdom[b] = add(fdom[b], aii(q_a, ii_a, cross(r_a, imp)));
          fcnt_a[b] = fcnt_a[b] + 1.0f;
          if (is_pair) {
            V3 nimp = V3{-imp.x, -imp.y, -imp.z};
            fsc_v[j] = add(fsc_v[j], scale(nimp, nb_w));
            fsc_o[j] = add(fsc_o[j], aii(nb_q, nb_ii, cross(r_b, nimp)));
            fcnt_s[j] = fcnt_s[j] + 1.0f;
          }
        }

        // Restitution: pre-solve approach velocity vs the post-solve one.
        V3 r_pre = sub(p, pos_i[b]);
        V3 v_pre = add(vel_i[b], cross(om_i[b], r_pre));
        float vn_pre = dot(v_pre, n);
        float w_n = C.w_n[b][v];
        if (lam > 0.0f && vn_pre < -P.rest_thresh && w_n > 1e-9f) {
          float vn_now = dot(sub(v_a, v_b), n);
          float jr = ((-P.restitution) * vn_pre - vn_now) / fmax2(w_n, 1e-9f);
          V3 imp = scale(n, jr);
          rsum[b] = add(rsum[b], imp);
          rdom[b] = add(rdom[b], aii(q_a, ii_a, cross(r_a, imp)));
        }
      }
    }
    for (int b = 0; b < nbd; ++b) {
      float fcnt = fcnt_a[b] + fcnt_s[b];
      float fnorm = 1.0f / fmax2(fcnt, 1.0f);
      V3 dvel = add(scale(fsum[b], B.inv_m[b]), fsc_v[b]);
      V3 dom = add(fdom[b], fsc_o[b]);
      V3 dvel_r = scale(rsum[b], B.inv_m[b]);
      V3 vn = add(add(vel_n[b], scale(dvel, fnorm)), dvel_r);
      V3 on = add(add(om_n[b], scale(dom, fnorm)), rdom[b]);
      bool d = B.dyn[b];
      B.vel[b] = d ? vn : V3{0.0f, 0.0f, 0.0f};
      B.omega[b] = d ? on : V3{0.0f, 0.0f, 0.0f};
      if (d) {
        B.pos[b] = pos_c[b];
        B.quat[b] = quat_c[b];
      }
    }
  }
}

// ---- the sweep (standalone_sweep_packed with the plain raycast) ----------

// Nearest hit of one ray over the world's bodies, walls and planes
// (env/rays.py::raycast_world); returns t, writes id (-1 on a miss).
MHS_HD float cast_ray(const Layout& L, const Bodies& B, const Statics& S, V3 o,
                      V3 d, float max_t, int excl, int* id_out) {
  float tb = F_INF;
  int ib = -1;
  for (int b = 0; b < L.n_body; ++b) {
    if (!B.active[b] || b == excl) continue;
    float t = ray_body(o, d, B.pos[b], B.quat[b], B.half[b], L.is_ramp(b));
    if (t <= max_t && t < tb) {
      tb = t;
      ib = b;
    }
  }
  for (int k = 0; k < S.wall_bound; ++k) {
    if (!S.wact[k]) continue;
    float t = ray_aabb(o, d, sub(S.wpos[k], S.whalf[k]), add(S.wpos[k], S.whalf[k]));
    if (t <= max_t && t < tb) {
      tb = t;
      ib = L.n_body + k;
    }
  }
  for (int p = 0; p < S.n_plane; ++p) {
    if (!S.pact[p]) continue;
    float t = ray_plane(o, d, S.ppt[p], S.pn[p]);
    if (t <= max_t && t < tb) {
      tb = t;
      ib = L.n_body + S.n_wall + p;
    }
  }
  *id_out = tb < F_INF ? ib : -1;
  return tb;
}

// Other-agent slot of visibility column k of agent a (others_index_matrix).
MHS_HD int other_of(int a, int k) { return k < a ? k : k + 1; }

struct SweepOut {
  float vis[MAX_AGENTS][MAX_TGT];
  float lidar[MAX_AGENTS][N_LIDAR];
  float act_t[MAX_AGENTS];
  int act_id[MAX_AGENTS];
  bool rew_seen;
};

__device__ __noinline__ void sweep(const SweepParams& P, const Layout& L,
                                   const Bodies& B, const Statics& S,
                                   const int* atype, const bool* aact, int nab,
                                   int nar, SweepOut& O) {
  const int na = L.n_agents;
  O.rew_seen = false;
  for (int a = 0; a < na; ++a) {
    const int sa = L.agent_lo + a;
    const V3 ap = B.pos[sa];
    const Q4 aq = B.quat[sa];
    const V3 fwd = quat_rotate(aq, V3{0.0f, 1.0f, 0.0f});
    const V3 right = quat_rotate(aq, V3{1.0f, 0.0f, 0.0f});
    const float act_f = aact[a] ? 1.0f : 0.0f;
    const bool is_seeker = aact[a] && atype[a] == AGENT_SEEKER;

    // Visibility columns: other agents (clamped), boxes, ramps.
    for (int k = 0; k < P.n_tgt; ++k) {
      int slot;
      bool valid;
      bool col_hider = false;
      if (k < MAX_AGENTS - 1) {
        int o = other_of(a, k);
        int oc = o < na ? o : na - 1;
        slot = L.agent_lo + oc;
        valid = o < na && aact[oc];
        col_hider = atype[oc] == AGENT_HIDER;
      } else if (k < MAX_AGENTS - 1 + P.n_boxes) {
        int i = k - (MAX_AGENTS - 1);
        slot = i;
        valid = i < nab;
      } else {
        int i = k - (MAX_AGENTS - 1) - P.n_boxes;
        slot = L.ramp_lo + i;
        valid = i < nar;
      }
      V3 to = sub(B.pos[slot], ap);
      int id;
      cast_ray(L, B, S, ap, to, 1.0f, sa, &id);
      float dist = norm3(to);
      float cos_angle = (to.x * fwd.x + to.y * fwd.y + to.z * fwd.z) / fmax2(dist, 1e-9f);
      bool in_cone = cos_angle >= P.cos_half_fov;
      bool seen = id == slot && in_cone && valid && aact[a];
      O.vis[a][k] = seen ? 1.0f : 0.0f;
      if (k < MAX_AGENTS - 1 && seen && is_seeker && col_hider) O.rew_seen = true;
    }
    // Lidar.
    for (int k = 0; k < N_LIDAR; ++k) {
      float c = P.lidar_cs[k];
      float s = P.lidar_cs[N_LIDAR + k];
      V3 d = V3{c * right.x + s * fwd.x, c * right.y + s * fwd.y,
                c * right.z + s * fwd.z};
      float len = fmax2(norm3(d), 1e-9f);
      d = V3{d.x / len, d.y / len, d.z / len};
      int id;
      float t = cast_ray(L, B, S, ap, d, P.lidar_range, sa, &id);
      O.lidar[a][k] = (id >= 0 ? t : 0.0f) * act_f;
    }
    // Next step's grab/lock ray from the eye point.
    V3 eye = V3{ap.x + 0.0f, ap.y + 0.0f, ap.z + 0.5f};
    int id;
    float t = cast_ray(L, B, S, eye, fwd, P.interact_len, sa, &id);
    O.act_t[a] = t;
    O.act_id[a] = id;
  }
}

// ---- per-world loads and stores (packed [..., W] layout) ---------------

// Offsets of world w in the packed layout.
struct Idx {
  long long W;
  int w;
  MHS_HD long long i1(int i) const { return static_cast<long long>(i) * W + w; }
  MHS_HD long long i3(int i, int k) const {
    return (static_cast<long long>(i) * 3 + k) * W + w;
  }
  MHS_HD long long i4(int i, int k) const {
    return (static_cast<long long>(i) * 4 + k) * W + w;
  }
};

MHS_HD V3 ld3(const float* p, const Idx& I, int i) {
  return V3{p[I.i3(i, 0)], p[I.i3(i, 1)], p[I.i3(i, 2)]};
}
MHS_HD Q4 ld4(const float* p, const Idx& I, int i) {
  return Q4{p[I.i4(i, 0)], p[I.i4(i, 1)], p[I.i4(i, 2)], p[I.i4(i, 3)]};
}
MHS_HD void st3(float* p, const Idx& I, int i, V3 v) {
  p[I.i3(i, 0)] = v.x;
  p[I.i3(i, 1)] = v.y;
  p[I.i3(i, 2)] = v.z;
}
MHS_HD void st4(float* p, const Idx& I, int i, Q4 q) {
  p[I.i4(i, 0)] = q.w;
  p[I.i4(i, 1)] = q.x;
  p[I.i4(i, 2)] = q.y;
  p[I.i4(i, 3)] = q.z;
}

MHS_HD Layout make_layout(int n_boxes, int n_ramps, int n_agents) {
  Layout L;
  L.n_agents = n_agents;
  L.ramp_lo = n_boxes;
  L.ramp_hi = n_boxes + n_ramps;
  L.agent_lo = L.ramp_hi;
  L.n_body = L.agent_lo + n_agents;
  return L;
}

// World w's bodies (raw inverse masses), statics and grabs, from an
// argument struct with MegaArgs' / StepArgs' field names. The wall loop
// bound defaults to every slot.
template <class Args>
MHS_HD void load_world(const Args& A, const Idx& I, const Layout& L,
                       Bodies& B, bool* locked, float* raw_inv_m,
                       V3* raw_inv_i, Statics& S, Grab& G) {
  for (int b = 0; b < L.n_body; ++b) {
    B.pos[b] = ld3(A.pos, I, b);
    B.quat[b] = ld4(A.quat, I, b);
    B.vel[b] = ld3(A.vel, I, b);
    B.omega[b] = ld3(A.omega, I, b);
    B.half[b] = ld3(A.half_ext, I, b);
    raw_inv_m[b] = A.inv_mass[I.i1(b)];
    raw_inv_i[b] = ld3(A.inv_inertia, I, b);
    B.mu[b] = A.friction_mu[I.i1(b)];
    B.active[b] = A.active[I.i1(b)] != 0;
    locked[b] = A.locked[I.i1(b)] != 0;
  }
  S.n_wall = A.n_wall;
  S.n_plane = A.n_plane;
  S.wall_bound = A.n_wall;
  for (int k = 0; k < S.n_wall; ++k) {
    S.wpos[k] = ld3(A.wall_pos, I, k);
    S.whalf[k] = ld3(A.wall_half, I, k);
    S.wact[k] = A.wall_active[I.i1(k)] != 0;
  }
  for (int p = 0; p < S.n_plane; ++p) {
    S.ppt[p] = ld3(A.plane_point, I, p);
    S.pn[p] = ld3(A.plane_normal, I, p);
    S.pact[p] = A.plane_active[I.i1(p)] != 0;
  }
  for (int a = 0; a < L.n_agents; ++a) {
    G.target[a] = A.g_target[I.i1(a)];
    G.r2[a] = ld3(A.g_r2, I, a);
    G.relq[a] = ld4(A.g_relq, I, a);
    G.sep[a] = A.g_sep[I.i1(a)];
  }
}

// Effective masses (physics.physics_step): zero unless active and not
// locked.
MHS_HD void set_dynamic(const Layout& L, Bodies& B, const bool* locked,
                        const float* raw_inv_m, const V3* raw_inv_i) {
  for (int b = 0; b < L.n_body; ++b) {
    B.dyn[b] = B.active[b] && !locked[b];
    B.inv_m[b] = B.dyn[b] ? raw_inv_m[b] : 0.0f;
    B.inv_i[b] = B.dyn[b] ? raw_inv_i[b] : V3{0.0f, 0.0f, 0.0f};
  }
}

template <class Args>
MHS_HD void store_bodies(const Args& A, const Idx& I, const Layout& L,
                         const Bodies& B) {
  for (int b = 0; b < L.n_body; ++b) {
    st3(A.pos_o, I, b, B.pos[b]);
    st4(A.quat_o, I, b, B.quat[b]);
    st3(A.vel_o, I, b, B.vel[b]);
    st3(A.omega_o, I, b, B.omega[b]);
  }
}

template <class Args>
MHS_HD void store_sweep(const Args& A, const Idx& I, const Layout& L,
                        const SweepOut& O) {
  for (int a = 0; a < L.n_agents; ++a) {
    for (int k = 0; k < A.n_tgt; ++k)
      A.vis_o[(static_cast<long long>(a) * A.n_tgt + k) * I.W + I.w] =
          O.vis[a][k];
    for (int k = 0; k < N_LIDAR; ++k)
      A.lidar_o[(static_cast<long long>(a) * N_LIDAR + k) * I.W + I.w] =
          O.lidar[a][k];
    A.act_t_o[I.i1(a)] = O.act_t[a];
    A.act_id_o[I.i1(a)] = O.act_id[a];
  }
  A.rew_seen_o[I.w] = O.rew_seen ? 1 : 0;
}

__device__ void megastep_world(const MegaArgs& A, int w) {
  const Idx I{A.W, w};
  const long long Wl = A.W;
  auto i1 = [&](int i) { return I.i1(i); };
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  const int nbd = L.n_body;
  const int na = A.n_agents;

  // ---- load ----
  Bodies B;
  bool locked[MAX_BODIES];
  int owner[MAX_BODIES];
  float raw_inv_m[MAX_BODIES];
  V3 raw_inv_i[MAX_BODIES];
  Statics S;
  Grab G;
  load_world(A, I, L, B, locked, raw_inv_m, raw_inv_i, S, G);
  S.wall_bound = *A.wall_bound;
  for (int b = 0; b < nbd; ++b) owner[b] = A.owner[i1(b)];
  int atype[MAX_AGENTS];
  bool aact[MAX_AGENTS];
  for (int a = 0; a < na; ++a) {
    atype[a] = A.agent_type[i1(a)];
    aact[a] = A.agent_active[i1(a)] != 0;
  }
  const int step = A.step[w];
  const int nab = A.num_boxes[w];
  const int nar = A.num_ramps[w];

  // ---- movement (movement_packed) ----
  V3 ext_f[MAX_BODIES], ext_t[MAX_BODIES];
  for (int b = 0; b < nbd; ++b) ext_f[b] = ext_t[b] = V3{0.0f, 0.0f, 0.0f};
  bool can_act[MAX_AGENTS];
  for (int a = 0; a < na; ++a) {
    const int sa = L.agent_lo + a;
    bool frozen = atype[a] == AGENT_SEEKER && step < A.num_prep - 1;
    can_act[a] = aact[a] && !frozen;
    float gate = can_act[a] ? 1.0f : 0.0f;
    float fx = A.f_per * static_cast<float>(A.actions[(a * 5LL + 0) * Wl + w] - A.half_bucket);
    float fy = A.f_per * static_cast<float>(A.actions[(a * 5LL + 1) * Wl + w] - A.half_bucket);
    float tz = A.t_per * static_cast<float>(A.actions[(a * 5LL + 2) * Wl + w] - A.half_bucket);
    V3 fw = qrot_c(B.quat[sa], V3{fx, fy, 0.0f}, false);
    ext_f[sa] = V3{fw.x * gate, fw.y * gate, fw.z * gate};
    ext_t[sa] = V3{0.0f * gate, 0.0f * gate, tz * gate};
  }

  // ---- grab / lock (action_system_packed) ----
  bool locked2[MAX_BODIES];
  int owner2[MAX_BODIES];
  {
    bool lock_any[MAX_BODIES], unlock_any[MAX_BODIES];
    int lock_team[MAX_BODIES];
    for (int b = 0; b < nbd; ++b) {
      lock_any[b] = unlock_any[b] = false;
      lock_team[b] = 0;
    }
    Grab G2 = G;
    for (int a = 0; a < na; ++a) {
      const int sa = L.agent_lo + a;
      const V3 ap = B.pos[sa];
      const Q4 aq = B.quat[sa];
      V3 eye = V3{ap.x, ap.y, ap.z + 0.5f};
      V3 fwd = qrot_c(aq, V3{0.0f, 1.0f, 0.0f}, false);
      bool want_lock = A.actions[(a * 5LL + 4) * Wl + w] == 1 && can_act[a];
      bool want_grab = A.actions[(a * 5LL + 3) * Wl + w] == 1 && can_act[a];
      int hit_id = A.act_hit_id[i1(a)];
      float hit_t = A.act_hit_t[i1(a)];
      bool is_obj = hit_id >= 0 && hit_id < L.ramp_hi;
      int tgt = is_obj ? hit_id : 0;
      bool t_locked = locked[tgt];
      int t_owner = owner[tgt];
      int my_team = atype[a] == AGENT_HIDER ? OWNER_HIDER : OWNER_SEEKER;
      bool do_unlock = want_lock && is_obj && t_locked && t_owner == my_team;
      bool do_lock = want_lock && is_obj && !t_locked && t_owner == OWNER_NONE;
      if (do_lock) {
        lock_any[tgt] = true;
        lock_team[tgt] = lock_team[tgt] > my_team ? lock_team[tgt] : my_team;
      }
      if (do_unlock) unlock_any[tgt] = true;

      bool has_grab = G.target[a] >= 0;
      bool release = want_grab && has_grab;
      bool grabbable = is_obj && !t_locked && t_owner == OWNER_NONE;
      bool acquire = want_grab && !has_grab && grabbable;
      float safe_t = is_obj ? hit_t : 0.0f;
      V3 hit_pos = V3{eye.x + fwd.x * safe_t, eye.y + fwd.y * safe_t,
                      eye.z + fwd.z * safe_t};
      Q4 tq = B.quat[tgt];
      V3 rel = sub(hit_pos, B.pos[tgt]);
      V3 r2_new = qrot_c(tq, rel, true);
      Q4 rq_new = qnorm(quat_mul(qconj(tq), aq));
      float sep_new = safe_t - 1.25f;
      G2.target[a] = release ? -1 : (acquire ? tgt : G.target[a]);
      if (acquire) {
        G2.r2[a] = r2_new;
        G2.relq[a] = rq_new;
        G2.sep[a] = sep_new;
      }
    }
    for (int b = 0; b < nbd; ++b) {
      locked2[b] = lock_any[b] ? true : (unlock_any[b] ? false : locked[b]);
      owner2[b] = lock_any[b] ? lock_team[b] : (unlock_any[b] ? OWNER_NONE : owner[b]);
    }
    G = G2;
  }

  // ---- effective masses, physics ----
  set_dynamic(L, B, locked2, raw_inv_m, raw_inv_i);
  {
    Manifold M;
    Contacts C;
    physics_step(phys_params(A), L, B, S, G, ext_f, ext_t, M, C);
  }

  // ---- sweep on the post-physics pose ----
  SweepOut O;
  sweep(sweep_params(A), L, B, S, atype, aact, nab, nar, O);

  // ---- zero agent velocities ----
  if (A.zero_agent_vel) {
    for (int a = 0; a < na; ++a) {
      const int sa = L.agent_lo + a;
      B.vel[sa] = V3{0.0f, 0.0f, fmin2(B.vel[sa].z, 0.0f)};
      B.omega[sa] = V3{0.0f, 0.0f, 0.0f};
    }
  }

  // ---- rewards, dones, episode results ----
  const float team_r = O.rew_seen ? -1.0f : 1.0f;
  const bool at_end = step == A.episode_len - 1;
  for (int a = 0; a < na; ++a) {
    const int sa = L.agent_lo + a;
    float sign = atype[a] == AGENT_SEEKER ? -1.0f : 1.0f;
    float reward = sign * team_r;
    bool oob = fabsf(B.pos[sa].x) >= 18.0f || fabsf(B.pos[sa].y) >= 18.0f;
    reward = reward - 10.0f * (oob ? 1.0f : 0.0f);
    if (step < A.num_prep - 1) reward = 0.0f;
    reward = reward * (aact[a] ? 1.0f : 0.0f);
    A.rewards_o[i1(a)] = reward;
    A.dones_o[i1(a)] = at_end ? 1 : 0;
  }
  int scores[2];
  float fin[2];
  for (int i = 0; i < 2; ++i) {
    scores[i] = step == 0 ? 0 : A.running[i1(i)];
    fin[i] = step == 0 ? 0.0f : A.finished[i1(i)];
  }
  int hid_idx = A.seekers_first[w] ? 1 : 0;
  int winner = team_r > 0.0f ? hid_idx : 1 - hid_idx;
  if (step >= A.num_prep) scores[winner] += 1;
  if (at_end) {
    fin[0] = scores[0] > scores[1] ? 1.0f : (scores[0] < scores[1] ? 0.0f : 0.5f);
    fin[1] = scores[0] > scores[1] ? 0.0f : (scores[0] < scores[1] ? 1.0f : 0.5f);
  }

  // ---- store ----
  store_bodies(A, I, L, B);
  for (int b = 0; b < nbd; ++b) {
    A.locked_o[i1(b)] = locked2[b] ? 1 : 0;
    A.owner_o[i1(b)] = owner2[b];
  }
  for (int a = 0; a < na; ++a) {
    A.g_target_o[i1(a)] = G.target[a];
    st3(A.g_r2_o, I, a, G.r2[a]);
    st4(A.g_relq_o, I, a, G.relq[a]);
    A.g_sep_o[i1(a)] = G.sep[a];
  }
  store_sweep(A, I, L, O);
  A.team_r_o[w] = team_r;
  for (int i = 0; i < 2; ++i) {
    A.running_o[i1(i)] = scores[i];
    A.finished_o[i1(i)] = fin[i];
  }
}

// K2 / K3: one world's physics step from the given external forces, then
// (kSweep) the sweep on the moved bodies. Locks and grabs are inputs.
template <bool kSweep>
__device__ void step_world(const StepArgs& A, int w) {
  const Idx I{A.W, w};
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  Bodies B;
  bool locked[MAX_BODIES];
  float raw_inv_m[MAX_BODIES];
  V3 raw_inv_i[MAX_BODIES];
  Statics S;
  Grab G;
  load_world(A, I, L, B, locked, raw_inv_m, raw_inv_i, S, G);
  V3 ext_f[MAX_BODIES], ext_t[MAX_BODIES];
  for (int b = 0; b < L.n_body; ++b) {
    ext_f[b] = ld3(A.ext_force, I, b);
    ext_t[b] = ld3(A.ext_torque, I, b);
  }
  set_dynamic(L, B, locked, raw_inv_m, raw_inv_i);
  {
    Manifold M;
    Contacts C;
    physics_step(phys_params(A), L, B, S, G, ext_f, ext_t, M, C);
  }
  store_bodies(A, I, L, B);
  if constexpr (kSweep) {
    S.wall_bound = *A.wall_bound;
    int atype[MAX_AGENTS];
    bool aact[MAX_AGENTS];
    for (int a = 0; a < L.n_agents; ++a) {
      atype[a] = A.agent_type[I.i1(a)];
      aact[a] = A.agent_active[I.i1(a)] != 0;
    }
    SweepOut O;
    sweep(sweep_params(A), L, B, S, atype, aact, A.num_boxes[w],
          A.num_ramps[w], O);
    store_sweep(A, I, L, O);
  }
}

#ifndef MHS_HOST_BUILD
__global__ void megastep_kernel(const MegaArgs A) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < A.W) megastep_world(A, w);
}

template <bool kSweep>
__global__ void step_kernel(const StepArgs A) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < A.W) step_world<kSweep>(A, w);
}
#endif

bool fill_args(MegaArgs* a, void* const* ptrs, int n_ptrs, const int* ip,
               int n_i, const float* fp, int n_f) {
  if (n_ptrs != N_PTRS || n_i != N_INTS || n_f != N_FLOATS) return false;
  void** dst = reinterpret_cast<void**>(a);
  for (int i = 0; i < N_PTRS; ++i) dst[i] = ptrs[i];
  a->W = ip[0];
  a->n_boxes = ip[1];
  a->n_ramps = ip[2];
  a->n_agents = ip[3];
  a->n_wall = ip[4];
  a->n_plane = ip[5];
  a->n_tgt = ip[6];
  a->zero_agent_vel = ip[7];
  a->episode_len = ip[8];
  a->n_sub = ip[9];
  a->half_bucket = ip[10];
  a->num_prep = ip[11];
  a->dt = fp[0];
  a->h = fp[1];
  a->f_per = fp[2];
  a->t_per = fp[3];
  a->two_over_h = fp[4];
  a->restitution = fp[5];
  a->rest_thresh = fp[6];
  a->cos_half_fov = fp[7];
  a->interact_len = fp[8];
  a->lidar_range = fp[9];
  return a->n_boxes <= MAX_BOXES && a->n_ramps <= MAX_RAMPS &&
         a->n_agents <= MAX_AGENTS && a->n_agents > 0 &&
         a->n_wall <= MAX_WALLS && a->n_plane <= MAX_PLANES &&
         a->n_tgt == (MAX_AGENTS - 1) + a->n_boxes + a->n_ramps;
}

// n_ptrs: N_PHYS_PTRS (physics entry; the sweep block stays null) or
// N_FUSED_PTRS (fused entry).
bool fill_step_args(StepArgs* a, void* const* ptrs, int n_ptrs, int want,
                    const int* ip, int n_i, const float* fp, int n_f) {
  if (n_ptrs != want || n_i != N_STEP_INTS || n_f != N_STEP_FLOATS)
    return false;
  void** dst = reinterpret_cast<void**>(a);
  for (int i = 0; i < N_FUSED_PTRS; ++i) dst[i] = i < n_ptrs ? ptrs[i] : nullptr;
  a->W = ip[0];
  a->n_boxes = ip[1];
  a->n_ramps = ip[2];
  a->n_agents = ip[3];
  a->n_wall = ip[4];
  a->n_plane = ip[5];
  a->n_tgt = ip[6];
  a->n_sub = ip[7];
  a->dt = fp[0];
  a->h = fp[1];
  a->two_over_h = fp[2];
  a->restitution = fp[3];
  a->rest_thresh = fp[4];
  a->cos_half_fov = fp[5];
  a->interact_len = fp[6];
  a->lidar_range = fp[7];
  return a->n_boxes <= MAX_BOXES && a->n_ramps <= MAX_RAMPS &&
         a->n_agents <= MAX_AGENTS && a->n_agents > 0 &&
         a->n_wall <= MAX_WALLS && a->n_plane <= MAX_PLANES &&
         a->n_tgt == (MAX_AGENTS - 1) + a->n_boxes + a->n_ramps;
}

static_assert(sizeof(void*) * N_PTRS == offsetof(MegaArgs, W),
              "MegaArgs pointer block must match N_PTRS");
static_assert(sizeof(void*) * N_PHYS_PTRS == offsetof(StepArgs, agent_type),
              "StepArgs physics block must match N_PHYS_PTRS");
static_assert(sizeof(void*) * N_FUSED_PTRS == offsetof(StepArgs, W),
              "StepArgs pointer block must match N_FUSED_PTRS");

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entries: the same per-world code in a plain loop.
extern "C" int mhs_megastep_host(void* const* ptrs, int n_ptrs, const int* ip,
                                 int n_i, const float* fp, int n_f) {
  MegaArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f)) return 1;
  for (int w = 0; w < a.W; ++w) megastep_world(a, w);
  return 0;
}

extern "C" int mhs_physics_host(void* const* ptrs, int n_ptrs, const int* ip,
                                int n_i, const float* fp, int n_f) {
  StepArgs a;
  if (!fill_step_args(&a, ptrs, n_ptrs, N_PHYS_PTRS, ip, n_i, fp, n_f))
    return 1;
  for (int w = 0; w < a.W; ++w) step_world<false>(a, w);
  return 0;
}

extern "C" int mhs_fused_host(void* const* ptrs, int n_ptrs, const int* ip,
                              int n_i, const float* fp, int n_f) {
  StepArgs a;
  if (!fill_step_args(&a, ptrs, n_ptrs, N_FUSED_PTRS, ip, n_i, fp, n_f))
    return 1;
  for (int w = 0; w < a.W; ++w) step_world<true>(a, w);
  return 0;
}
#else
extern "C" int mhs_megastep(void* const* ptrs, int n_ptrs, const int* ip,
                            int n_i, const float* fp, int n_f, void* stream) {
  MegaArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int threads = 64;
  const int blocks = (a.W + threads - 1) / threads;
  megastep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSweep>
int launch_step(void* const* ptrs, int n_ptrs, const int* ip, int n_i,
                const float* fp, int n_f, void* stream) {
  StepArgs a;
  if (!fill_step_args(&a, ptrs, n_ptrs, kSweep ? N_FUSED_PTRS : N_PHYS_PTRS,
                      ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int threads = 64;
  const int blocks = (a.W + threads - 1) / threads;
  step_kernel<kSweep>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2: the physics step alone (physics_step_batch).
extern "C" int mhs_physics(void* const* ptrs, int n_ptrs, const int* ip,
                           int n_i, const float* fp, int n_f, void* stream) {
  return launch_step<false>(ptrs, n_ptrs, ip, n_i, fp, n_f, stream);
}

// K3: the physics step, then the sweep on the moved bodies (fused_step).
extern "C" int mhs_fused(void* const* ptrs, int n_ptrs, const int* ip,
                         int n_i, const float* fp, int n_f, void* stream) {
  return launch_step<true>(ptrs, n_ptrs, ip, n_i, fp, n_f, stream);
}
#endif
