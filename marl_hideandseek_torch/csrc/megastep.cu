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
// Mapping: one warp per world, WORLDS_PER_BLOCK worlds per block. The
// work inside a world is spread over the warp's lanes: a body per lane
// (predicted pose, candidate preselect, integration, the combination of
// each solve, grab joints, velocity reconstruction), a (body, vertex)
// contact slot per lane (manifold, refresh, position solve, velocity
// passes), an agent per lane (movement, grab/lock, rewards) and a ray per
// lane (the sweep: every visibility, lidar and grab ray of the world).
// The ragged edge of W is masked: any W works. Capacity is a compile-time
// maximum (common.cuh) with the live body/agent counts passed at run time,
// so one build serves every configuration.
//
// State: a world's bodies, statics, grabs, the substep's per-body scratch
// and each contact slot's impulse terms live in shared memory (World);
// a contact slot's own manifold and contact data live in the registers
// of the lane that owns it (at most SLOTS_PER_LANE slots a lane). Sums are
// gathered, not scattered: each slot's lane writes its terms, and after
// a warp barrier each body's lane adds its own slots in vertex order,
// then the terms aimed at it by pair contacts in (body, vertex) order -
// the plain version's order, with no atomics, so results are
// deterministic. Loads and stores of the packed [..., W] layout go
// through the block: consecutive threads take consecutive worlds of one
// row, so they coalesce.
//
// Bound: arithmetic. A world moves about 4.5 KB (state in; state, sweep
// and scores out) but does about 0.5 MFLOP (the manifold build, 4
// substeps over 8 contacts per body, ~190 rays against ~50 primitives).
// The physics and sweep bodies (physics_step, sweep) are shared by the
// three entries and inlined into each, so that their accesses to the
// World are known to be shared-memory accesses (measured 8-12 % faster
// than calls through generic pointers, at 3.5 s more build time).
//
// Host build (-DMHS_HOST_BUILD): the lane helpers run a warp's lanes one
// after another in each phase, and the block's worlds one after another;
// -DMHS_LANES_REVERSE runs the lanes (and the block's load and store
// items) in reverse order, so a missing barrier shows as a difference
// between the two orders.

#include <cstddef>

#include "common.cuh"
#include "lanes.cuh"

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

constexpr int WORLDS_PER_BLOCK = 4;
constexpr int BLOCK_THREADS = WORLDS_PER_BLOCK * WARP;
constexpr int N_SLOTS = MAX_BODIES * N_VERTS;           // contact slots
constexpr int SLOTS_PER_LANE = (N_SLOTS + WARP - 1) / WARP;
constexpr int SLOT_WORDS = (N_SLOTS + 31) / 32;         // slot bit masks
// Slot flags of one substep.
constexpr unsigned char F_MASK = 1;   // a contact this substep
constexpr unsigned char F_FRIC = 2;   // dynamic friction applied
constexpr unsigned char F_REST = 4;   // restitution applied

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

// ---- lanes ------------------------------------------------------------------
//
// The lane helpers are lanes.cuh's; slots(n, f) adds f(k, i) for every
// item i < n on lane i % 32, k = i / 32 the lane's k-th item, a
// compile-time index after unrolling, so per-slot data indexed by k stays
// in registers (LaneSlots).

#ifdef MHS_HOST_BUILD
template <class F>
inline void slots(int n, F&& f) {
  for (int j = 0; j < WARP; ++j)
    for (int k = 0; k < SLOTS_PER_LANE; ++k) {
      const int i = lane_at(j) + WARP * k;
      if (i < n) f(k, i);
    }
}
inline int low_bit(unsigned int m) { return __builtin_ctz(m); }

// Per-slot data of the lane that owns the slot: indexed by slot on the
// host, where every lane's items share one loop.
template <class T>
struct LaneSlots {
  T v[N_SLOTS];
  T& operator()(int, int i) { return v[i]; }
};
#else
template <class F>
__device__ __forceinline__ void slots(int n, F&& f) {
#pragma unroll
  for (int k = 0; k < SLOTS_PER_LANE; ++k) {
    const int i = lane_id() + WARP * k;
    if (i < n) f(k, i);
  }
}
__device__ __forceinline__ int low_bit(unsigned int m) { return __ffs(m) - 1; }

template <class T>
struct LaneSlots {
  T v[SLOTS_PER_LANE];
  __device__ __forceinline__ T& operator()(int k, int) { return v[k]; }
};
#endif

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
  int n_sub, n_wall, n_plane;
  float dt, h, two_over_h, restitution, rest_thresh;
};
struct SweepParams {
  int n_tgt, n_boxes, n_wall, n_plane, wall_bound;
  float cos_half_fov, interact_len, lidar_range;
  const float* lidar_cs;
};
template <class Args>
MHS_HD PhysParams phys_params(const Args& A) {
  return PhysParams{A.n_sub, A.n_wall, A.n_plane, A.dt, A.h, A.two_over_h,
                    A.restitution, A.rest_thresh};
}
template <class Args>
MHS_HD SweepParams sweep_params(const Args& A) {
  return SweepParams{A.n_tgt, A.n_boxes, A.n_wall, A.n_plane, *A.wall_bound,
                     A.cos_half_fov, A.interact_len, A.lidar_range,
                     A.lidar_cs};
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

// ---- per-world state in shared memory ----------------------------------------

// A contact slot's impulse terms for the gathering sums: four aimed at its
// own body and two at its pair neighbour. Position solve: own = (normal
// impulse, its rotation, tangential impulse, its rotation), nb = (the
// neighbour's position term, its rotation term). Velocity passes: own =
// (friction impulse, its rotation, restitution impulse, its rotation), nb
// = (the neighbour's friction velocity term, its angular term).
struct SlotTerms {
  V3 own[4];
  V3 nb[2];
};

// The sweep's outputs of one world, rows in the packed order.
struct SweepStage {
  float vis[MAX_AGENTS * MAX_TGT];  // [a * n_tgt + k]
  float lidar[MAX_AGENTS * N_LIDAR];
  float act_t[MAX_AGENTS];
  int act_id[MAX_AGENTS];
};

// One world. Each input array holds the world's rows of the packed
// [rows, W] tensor in row order (V3 / Q4 components are rows too).
struct World {
  // Bodies.
  V3 pos[MAX_BODIES];
  Q4 quat[MAX_BODIES];
  V3 vel[MAX_BODIES];
  V3 omega[MAX_BODIES];
  V3 half[MAX_BODIES];
  V3 inv_i[MAX_BODIES];     // raw on load, then effective (0 unless dynamic)
  float inv_m[MAX_BODIES];  // likewise
  float mu[MAX_BODIES];
  V3 ext_f[MAX_BODIES];
  V3 ext_t[MAX_BODIES];
  int owner[MAX_BODIES];
  unsigned char active[MAX_BODIES];
  unsigned char locked[MAX_BODIES];
  unsigned char dyn[MAX_BODIES];
  // Statics.
  V3 wpos[MAX_WALLS];
  V3 whalf[MAX_WALLS];
  V3 ppt[MAX_PLANES];
  V3 pn[MAX_PLANES];
  unsigned char wact[MAX_WALLS];
  unsigned char pact[MAX_PLANES];
  // Grabs and agents.
  int g_target[MAX_AGENTS];
  V3 g_r2[MAX_AGENTS];
  Q4 g_relq[MAX_AGENTS];
  float g_sep[MAX_AGENTS];
  int atype[MAX_AGENTS];
  int actions[MAX_AGENTS * 5];
  float hit_t[MAX_AGENTS];
  int hit_id[MAX_AGENTS];
  int req_tgt[MAX_AGENTS];   // grab/lock: the agent's lock request
  int req_kind[MAX_AGENTS];  // 0 none, 1 lock, 2 unlock
  int req_team[MAX_AGENTS];
  float rewards[MAX_AGENTS];
  int dones[MAX_AGENTS];
  unsigned char aact[MAX_AGENTS];
  int step, nab, nar;
  int running[2];
  float finished[2];
  float team_r;
  unsigned char seekers_first, rew_seen;
  // Physics scratch: the substep's poses and velocities, the candidate
  // preselect per body, the pair slots aimed at each body, the joints'
  // corrections per agent and the slots' flags, neighbours and terms.
  V3 pos_i[MAX_BODIES];
  Q4 quat_i[MAX_BODIES];
  V3 vel_i[MAX_BODIES];
  V3 om_i[MAX_BODIES];
  V3 pos_c[MAX_BODIES];   // also the predicted pose of the manifold build
  Q4 quat_c[MAX_BODIES];
  V3 vel_n[MAX_BODIES];
  V3 om_n[MAX_BODIES];
  float wsel_lb[MAX_BODIES][K_WALL];
  float psel_lb[MAX_BODIES][K_PAIR];
  int wsel[MAX_BODIES][K_WALL];
  int psel[MAX_BODIES][K_PAIR];
  unsigned int pmask[MAX_BODIES][SLOT_WORDS];
  V3 jt[MAX_AGENTS][4];   // joint: dpos_t, drot_t, dpos_a, drot_a
  signed char snb[N_SLOTS];
  unsigned char sflag[N_SLOTS];
  union {
    SlotTerms t[N_SLOTS];
    SweepStage o;  // after the physics
  } u;
};

struct Layout {
  int n_body, ramp_lo, ramp_hi, agent_lo, n_agents;
  MHS_HD bool is_ramp(int b) const { return b >= ramp_lo && b < ramp_hi; }
};

MHS_HD Layout make_layout(int n_boxes, int n_ramps, int n_agents) {
  Layout L;
  L.n_agents = n_agents;
  L.ramp_lo = n_boxes;
  L.ramp_hi = n_boxes + n_ramps;
  L.agent_lo = L.ramp_hi;
  L.n_body = L.agent_lo + n_agents;
  return L;
}

MHS_HD V3 vert_local(const Layout& L, const World& w, int b, int v) {
  if (L.is_ramp(b)) return wedge_vert(v);
  // BOX_CORNER_SIGNS: bit 2 -> x, bit 1 -> y, bit 0 -> z.
  float sx = (v & 4) ? 1.0f : -1.0f;
  float sy = (v & 2) ? 1.0f : -1.0f;
  float sz = (v & 1) ? 1.0f : -1.0f;
  V3 h = w.half[b];
  return V3{h.x * sx, h.y * sy, h.z * sz};
}

MHS_HD V3 inset(V3 v) {
  return V3{v.x - VERT_INSET * sgn(v.x), v.y - VERT_INSET * sgn(v.y),
            v.z - VERT_INSET * sgn(v.z)};
}

MHS_HD float r_bound(const Layout& L, const World& w, int b) {
  return L.is_ramp(b) ? WEDGE_RADIUS : norm3(w.half[b]);
}

// The 3 smallest (value, index) pairs in lexicographic order, kept in
// registers while the indices arrive in ascending order: the lower index
// first among equal values, as physics.py::_stable_smallest orders them;
// idx -1 (value +inf) past the end.
struct Top3 {
  float lb[3];
  int idx[3];
};
MHS_HD void top3_init(Top3& t) {
  for (int s = 0; s < 3; ++s) {
    t.lb[s] = F_INF;
    t.idx[s] = -1;
  }
}
MHS_HD void top3_push(Top3& t, float v, int i) {
  if (t.idx[0] < 0 || v < t.lb[0]) {
    t.lb[2] = t.lb[1];
    t.idx[2] = t.idx[1];
    t.lb[1] = t.lb[0];
    t.idx[1] = t.idx[0];
    t.lb[0] = v;
    t.idx[0] = i;
  } else if (t.idx[1] < 0 || v < t.lb[1]) {
    t.lb[2] = t.lb[1];
    t.idx[2] = t.idx[1];
    t.lb[1] = v;
    t.idx[1] = i;
  } else if (t.idx[2] < 0 || v < t.lb[2]) {
    t.lb[2] = v;
    t.idx[2] = i;
  }
}

// ---- the physics step (env/physics.py::physics_step) -------------------------

// A contact slot's manifold entry (build_manifold), kept in registers.
// a, b by kind: plane (flat point, normal), wall (wall centre, clamped
// half extents), pair (the neighbour's clamped half extents, unused).
struct SlotM {
  int kind, nb, nb_ramp;
  V3 a, b;
  float mu;
};
// The slot's contact of the current substep, kept in registers.
struct SlotC {
  V3 p, n;
  float lam, w_n;
};

// Candidate preselect of body b by centre lower bounds (stable order).
MHS_HD void preselect(const PhysParams& P, const Layout& L, World& w, int b) {
  const V3 pp = w.pos_c[b];
  const float rb = r_bound(L, w, b);
  Top3 ws;
  top3_init(ws);
  for (int j = 0; j < P.n_wall; ++j) {
    float lb = w.wact[j] ? box_sdf(sub(pp, w.wpos[j]), w.whalf[j], nullptr) - rb
                         : 1e9f;
    top3_push(ws, lb, j);
  }
  Top3 ps;
  top3_init(ps);
  for (int j = 0; j < L.n_body; ++j) {
    bool ok = w.active[j] && j != b;
    float lb = ok ? norm3(sub(pp, w.pos_c[j])) - rb - r_bound(L, w, j) : 1e9f;
    top3_push(ps, lb, j);
  }
  for (int s = 0; s < 3; ++s) {
    w.wsel_lb[b][s] = ws.lb[s];
    w.wsel[b][s] = ws.idx[s];
    w.psel_lb[b][s] = ps.lb[s];
    w.psel[b][s] = ps.idx[s];
  }
}

// build_manifold for slot (b, v): the nearest surface of the vertex at
// the predicted pose (pos_c).
MHS_HD SlotM manifold_slot(const PhysParams& P, const Layout& L,
                           const World& w, int b, int v) {
  const int nbd = L.n_body;
  const int k_pair = K_PAIR < nbd - 1 ? K_PAIR : nbd - 1;
  const V3 pp = w.pos_c[b];
  const Q4 q = w.quat[b];
  V3 vl = vert_local(L, w, b, v);
  V3 vw = add(pp, quat_rotate(q, vl));
  V3 vw_in = add(pp, quat_rotate(q, inset(vl)));

  // Planes.
  float s_pl = 0.0f;
  int i_pl = 0;
  for (int p = 0; p < P.n_plane; ++p) {
    V3 rel = sub(vw, w.ppt[p]);
    float sdf = rel.x * w.pn[p].x + rel.y * w.pn[p].y + rel.z * w.pn[p].z;
    sdf = w.pact[p] ? sdf : 1e9f;
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
    int j = w.wsel[b][k];
    if (w.wsel_lb[b][k] < 1e8f)
      sdf = box_sdf(sub(vw_in, w.wpos[j]), w.whalf[j], nullptr);
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
    int j = w.psel[b][k];
    if (w.psel_lb[b][k] < 1e8f) {
      V3 pl = quat_rotate_inv(w.quat[j], sub(vw_in, w.pos_c[j]));
      sdf = convex_sdf(pl, w.half[j], L.is_ramp(j), nullptr);
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
  bool valid = (best < CONTACT_MARGIN) && w.active[b];
  SlotM m;
  m.kind = valid ? (is_plane ? KIND_PLANE : (is_wall ? KIND_WALL : KIND_PAIR))
                 : KIND_NONE;
  int wj = w.wsel[b][i_wl] < 0 ? 0 : w.wsel[b][i_wl];
  int pj = k_pair > 0 ? w.psel[b][i_pr] : -1;
  m.nb = (is_pair && valid) ? pj : -1;
  m.nb_ramp = pj >= 0 && L.is_ramp(pj);
  float mu_pr = pj >= 0 ? w.mu[pj] : 0.0f;
  m.mu = is_pair ? fmax2(w.mu[b], mu_pr) : fmax2(w.mu[b], 2.0f);
  if (m.kind == KIND_PLANE) {
    m.a = w.ppt[i_pl];
    m.b = w.pn[i_pl];
  } else if (m.kind == KIND_WALL) {
    m.a = w.wpos[wj];
    V3 wh = w.whalf[wj];
    m.b = V3{fmax2(wh.x, 1e-3f), fmax2(wh.y, 1e-3f), fmax2(wh.z, 1e-3f)};
  } else {
    V3 nh = pj >= 0 ? w.half[pj] : V3{1.0f, 1.0f, 1.0f};
    m.a = V3{fmax2(nh.x, 1e-3f), fmax2(nh.y, 1e-3f), fmax2(nh.z, 1e-3f)};
    m.b = V3{0.0f, 0.0f, 0.0f};
  }
  return m;
}

// Contact point, depth and normal of a manifold slot at the substep's
// integrated pose (pos_i, quat_i); returns the mask.
MHS_HD bool refresh_contact(const Layout& L, const World& w, const SlotM& m,
                            int b, int v, V3* p_out, V3* n_out,
                            float* depth_out) {
  V3 vl = vert_local(L, w, b, v);
  V3 p_ex = add(w.pos_i[b], quat_rotate(w.quat_i[b], vl));
  V3 p_in = add(w.pos_i[b], quat_rotate(w.quat_i[b], inset(vl)));
  float depth;
  V3 n;
  if (m.kind == KIND_PLANE) {
    V3 dp = sub(p_ex, m.a);
    V3 fn = m.b;
    float d_plane = dp.x * fn.x + dp.y * fn.y + dp.z * fn.z;
    depth = -d_plane;
    n = fn;
    *p_out = p_ex;
  } else if (m.kind == KIND_WALL) {
    float sdf = box_sdf(sub(p_in, m.a), m.b, &n);
    depth = -sdf;
    *p_out = p_in;
  } else {
    int j = m.nb;
    Q4 nq = w.quat_i[j];
    V3 pl = quat_rotate_inv(nq, sub(p_in, w.pos_i[j]));
    V3 nl;
    float sdf = convex_sdf(pl, m.a, m.nb_ramp != 0, &nl);
    n = quat_rotate(nq, nl);
    depth = -sdf;
    *p_out = p_in;
  }
  *n_out = n;
  *depth_out = depth;
  return depth > 0.0f;
}

// solve_grab_joints, agent a's terms (into w.jt[a]); a joint without a
// target has none.
MHS_HD void joint_terms(const Layout& L, World& w, int a) {
  const int t = w.g_target[a];
  if (t < 0) return;
  const int sa = L.agent_lo + a;
  V3 x_a = w.pos_c[sa];
  Q4 q_a = w.quat_c[sa];
  V3 x_t = w.pos_c[t];
  Q4 q_t = w.quat_c[t];
  float w_t = w.inv_m[t];
  V3 ii_t = w.inv_i[t];
  float w_a = w.inv_m[sa];
  V3 ii_a = w.inv_i[sa];

  V3 r1 = V3{0.0f, 1.25f + w.g_sep[a], 0.5f};
  V3 p_a = add(x_a, quat_rotate(q_a, r1));
  V3 p_t = add(x_t, quat_rotate(q_t, w.g_r2[a]));
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
  Q4 err = quat_mul(rel_now, quat_inv(w.g_relq[a]));
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
  w.jt[a][0] = dpos_t;
  w.jt[a][1] = add(drot_t, scale(it_th, sc));
  w.jt[a][2] = dpos_a;
  w.jt[a][3] = sub(drot_a, scale(ia_th, sc));
}

// physics_step: the manifold build and the substep loop, across the
// warp's lanes; w.pos / quat / vel / omega hold the result. Every phase
// ends at a warp barrier: the next one reads what other lanes wrote.
__device__ __forceinline__ void physics_step(const PhysParams& P,
                                          const Layout& L, World& w) {
  const int nbd = L.n_body;
  const int ns = nbd * N_VERTS;
  const float h = P.h;

  // Predicted pose: pos + (dt * vel) * dyn.
  lanes(nbd, [&](int b) {
    float df = w.dyn[b] ? 1.0f : 0.0f;
    V3 dv = V3{P.dt * w.vel[b].x * df, P.dt * w.vel[b].y * df,
               P.dt * w.vel[b].z * df};
    w.pos_c[b] = add(w.pos[b], dv);
  });
  warp_sync();
  lanes(nbd, [&](int b) { preselect(P, L, w, b); });
  warp_sync();
  LaneSlots<SlotM> M;
  slots(ns, [&](int k, int i) {
    M(k, i) = manifold_slot(P, L, w, i / N_VERTS, i % N_VERTS);
    w.snb[i] = static_cast<signed char>(M(k, i).nb);
  });
  warp_sync();
  // The pair slots aimed at each body, as bits in slot order.
  lanes(nbd, [&](int b) {
    for (int q = 0; q < SLOT_WORDS; ++q) w.pmask[b][q] = 0u;
    for (int i = 0; i < ns; ++i)
      if (w.snb[i] == b) w.pmask[b][i >> 5] |= 1u << (i & 31);
  });
  warp_sync();

  const float half_h = 0.5f * h;
  LaneSlots<SlotC> C;
  for (int sub_i = 0; sub_i < P.n_sub; ++sub_i) {
    // ---- integrate (a body per lane) ----
    lanes(nbd, [&](int b) {
      float mk = w.inv_m[b] > 0.0f ? 1.0f : 0.0f;
      float im = w.inv_m[b];
      V3 f = w.ext_f[b];
      V3 acc = V3{0.0f * mk + f.x * im, 0.0f * mk + f.y * im,
                  -9.8f * mk + f.z * im};
      V3 vi = add(w.vel[b], scale(acc, h));
      w.vel_i[b] = vi;
      V3 aa = aii(w.quat[b], w.inv_i[b], w.ext_t[b]);
      V3 oi = add(w.omega[b], scale(aa, h));
      w.om_i[b] = oi;
      w.pos_i[b] = add(w.pos[b], scale(vi, h));
      // quat_integrate: normalize(q + (0.5 h) * ((0, omega) * q)).
      Q4 q = w.quat[b];
      Q4 qm = quat_mul(Q4{0.0f, oi.x, oi.y, oi.z}, q);
      w.quat_i[b] = quat_normalize(Q4{q.w + half_h * qm.w, q.x + half_h * qm.x,
                                      q.y + half_h * qm.y, q.z + half_h * qm.z});
    });
    warp_sync();

    // ---- refresh + Jacobi position solve (a slot per lane) ----
    slots(ns, [&](int k, int i) {
      const int b = i / N_VERTS, v = i % N_VERTS;
      const SlotM& m = M(k, i);
      SlotC& c = C(k, i);
      c.lam = 0.0f;
      c.w_n = 0.0f;
      unsigned char flag = 0;
      V3 p, n;
      float depth;
      if (m.kind != KIND_NONE &&
          refresh_contact(L, w, m, b, v, &p, &n, &depth)) {
        flag = F_MASK;
        c.p = p;
        c.n = n;
        const int kind = m.kind;
        const bool is_pair = kind == KIND_PAIR;
        const int j = m.nb;
        float nb_w = is_pair ? w.inv_m[j] : 0.0f;
        V3 nb_ii = is_pair ? w.inv_i[j] : V3{0.0f, 0.0f, 0.0f};
        V3 nb_pos = is_pair ? w.pos_i[j] : V3{1e6f, 1e6f, 1e6f};
        Q4 nb_q = is_pair ? w.quat_i[j] : Q4{1.0f, 0.0f, 0.0f, 0.0f};
        Q4 q_a = w.quat_i[b];
        V3 ii_a = w.inv_i[b];
        V3 r_a = sub(p, w.pos_i[b]);
        V3 r_b = sub(p, nb_pos);
        V3 rxn_a = cross(r_a, n);
        float w_ang_a = dot(rxn_a, aii(q_a, ii_a, rxn_a));
        float w_ang_b = 0.0f;
        if (is_pair) {
          V3 rxn_b = cross(r_b, n);
          w_ang_b = dot(rxn_b, aii(nb_q, nb_ii, rxn_b));
        }
        float w_sum = w.inv_m[b] + w_ang_a + nb_w + w_ang_b;
        float lam = (w_sum > 1e-9f) ? depth / fmax2(w_sum, 1e-9f) : 0.0f;
        c.lam = lam;
        c.w_n = w_sum;
        V3 imp = scale(n, lam);

        // Positional static friction vs a stationary neighbour.
        V3 vl = vert_local(L, w, b, v);
        V3 v_eval = kind == KIND_PLANE ? vl : inset(vl);
        V3 p_prev_a = add(w.pos[b], quat_rotate(w.quat[b], v_eval));
        V3 dp = sub(p, p_prev_a);
        float dpn = dot(dp, n);
        V3 dpt = sub(dp, scale(n, dpn));
        float dpt_len = norm3(dpt);
        float dl = fmax2(dpt_len, 1e-9f);
        V3 t_dir = V3{dpt.x / dl, dpt.y / dl, dpt.z / dl};
        V3 rxt_a = cross(r_a, t_dir);
        float w_t = w.inv_m[b] + nb_w + dot(rxt_a, aii(q_a, ii_a, rxt_a));
        float lam_t = dpt_len / fmax2(w_t, 1e-9f);
        float mu_s = is_pair ? MU_S_BODY : MU_S_STATIC;
        bool static_ok = (lam > 0.0f) && (w_t > 1e-9f);
        float lam_tc = fmin2(lam_t, mu_s * lam);
        float nl = -(static_ok ? lam_tc : 0.0f);
        V3 imp_t = scale(t_dir, nl);

        SlotTerms& t = w.u.t[i];
        t.own[0] = imp;
        t.own[1] = aii(q_a, ii_a, cross(r_a, imp));
        t.own[2] = imp_t;
        t.own[3] = aii(q_a, ii_a, cross(r_a, imp_t));
        if (is_pair) {
          V3 nimp = V3{-imp.x, -imp.y, -imp.z};
          t.nb[0] = scale(nimp, nb_w);
          t.nb[1] = aii(nb_q, nb_ii, cross(r_b, nimp));
        }
      }
      w.sflag[i] = flag;
    });
    warp_sync();

    // ---- combine the solve (a body per lane; sums in slot order) ----
    lanes(nbd, [&](int b) {
      const V3 z = V3{0.0f, 0.0f, 0.0f};
      V3 sum_imp = z, drot_a = z, sum_imp_t = z, drot_t = z;
      float cnt_a = 0.0f;
      for (int v = 0; v < N_VERTS; ++v) {
        const int i = b * N_VERTS + v;
        if (!(w.sflag[i] & F_MASK)) continue;
        const SlotTerms& t = w.u.t[i];
        sum_imp = add(sum_imp, t.own[0]);
        drot_a = add(drot_a, t.own[1]);
        sum_imp_t = add(sum_imp_t, t.own[2]);
        drot_t = add(drot_t, t.own[3]);
        cnt_a = cnt_a + 1.0f;
      }
      V3 sc_pos = z, sc_rot = z;
      float cnt_s = 0.0f;
      for (int q = 0; q < SLOT_WORDS; ++q) {
        for (unsigned int bits = w.pmask[b][q]; bits != 0u; bits &= bits - 1u) {
          const int i = q * 32 + low_bit(bits);
          if (!(w.sflag[i] & F_MASK)) continue;
          sc_pos = add(sc_pos, w.u.t[i].nb[0]);
          sc_rot = add(sc_rot, w.u.t[i].nb[1]);
          cnt_s = cnt_s + 1.0f;
        }
      }
      float cnt = cnt_a + cnt_s;
      float nrm = 1.0f / fmax2(cnt, 1.0f);
      V3 dpos = add(scale(sum_imp, w.inv_m[b]), sc_pos);
      V3 drot = add(drot_a, sc_rot);
      V3 dpos_t = scale(sum_imp_t, w.inv_m[b]);
      w.pos_c[b] = add(add(w.pos_i[b], scale(dpos, nrm)), dpos_t);
      w.quat_c[b] = apply_rot(w.quat_i[b], add(scale(drot, nrm), drot_t));
    });
    warp_sync();

    // ---- grab joints (an agent per lane), then each body's corrections
    // in agent order and its velocities from positions (a body per lane)
    lanes(L.n_agents, [&](int a) { joint_terms(L, w, a); });
    warp_sync();
    lanes(nbd, [&](int b) {
      V3 dpos = V3{0.0f, 0.0f, 0.0f}, drot = V3{0.0f, 0.0f, 0.0f};
      for (int a = 0; a < L.n_agents; ++a) {
        if (w.g_target[a] < 0) continue;
        if (w.g_target[a] == b) {
          dpos = add(dpos, w.jt[a][0]);
          drot = add(drot, w.jt[a][1]);
        }
        if (L.agent_lo + a == b) {
          dpos = add(dpos, w.jt[a][2]);
          drot = add(drot, w.jt[a][3]);
        }
      }
      V3 pc = add(w.pos_c[b], dpos);
      Q4 qc = apply_rot(w.quat_c[b], drot);
      w.pos_c[b] = pc;
      w.quat_c[b] = qc;
      V3 d = sub(pc, w.pos[b]);
      w.vel_n[b] = V3{d.x / h, d.y / h, d.z / h};
      Q4 dq = quat_mul(qc, quat_inv(w.quat[b]));
      float s = sgn(dq.w);
      w.om_n[b] = V3{P.two_over_h * dq.x * s, P.two_over_h * dq.y * s,
                     P.two_over_h * dq.z * s};
    });
    warp_sync();

    // ---- velocity passes: dynamic friction + restitution (a slot per
    // lane) ----
    slots(ns, [&](int k, int i) {
      if (!(w.sflag[i] & F_MASK)) return;
      const int b = i / N_VERTS;
      const SlotM& m = M(k, i);
      const SlotC& c = C(k, i);
      const float lam = c.lam;
      const bool is_pair = m.kind == KIND_PAIR;
      const int j = m.nb;
      const V3 p = c.p;
      const V3 n = c.n;
      float nb_w = is_pair ? w.inv_m[j] : 0.0f;
      V3 nb_ii = is_pair ? w.inv_i[j] : V3{0.0f, 0.0f, 0.0f};
      V3 nb_pos = is_pair ? w.pos_i[j] : V3{1e6f, 1e6f, 1e6f};
      Q4 nb_q = is_pair ? w.quat_i[j] : Q4{1.0f, 0.0f, 0.0f, 0.0f};
      V3 nb_vel = is_pair ? w.vel_n[j] : V3{0.0f, 0.0f, 0.0f};
      V3 nb_om = is_pair ? w.om_n[j] : V3{0.0f, 0.0f, 0.0f};
      Q4 q_a = w.quat_c[b];
      V3 ii_a = w.inv_i[b];
      V3 r_a = sub(p, w.pos_c[b]);
      V3 r_b = sub(p, nb_pos);
      V3 v_a = add(w.vel_n[b], cross(w.om_n[b], r_a));
      V3 v_b = add(nb_vel, cross(nb_om, r_b));
      SlotTerms& t = w.u.t[i];
      unsigned char flag = F_MASK;

      if (lam > 0.0f) {  // dynamic friction
        V3 v_rel = sub(v_a, v_b);
        float vn = dot(v_rel, n);
        V3 v_t = sub(v_rel, scale(n, vn));
        float vt_len = norm3(v_t);
        float tl = fmax2(vt_len, 1e-9f);
        V3 t_dir = V3{v_t.x / tl, v_t.y / tl, v_t.z / tl};
        V3 rxt_a = cross(r_a, t_dir);
        float w_sum = w.inv_m[b] + nb_w + dot(rxt_a, aii(q_a, ii_a, rxt_a));
        if (is_pair) {
          V3 rxt_b = cross(r_b, t_dir);
          w_sum = w_sum + dot(rxt_b, aii(nb_q, nb_ii, rxt_b));
        }
        w_sum = fmax2(w_sum, 1e-9f);
        float jf = fmin2(vt_len / w_sum, m.mu * lam / h);
        V3 imp = scale(t_dir, -jf);
        t.own[0] = imp;
        t.own[1] = aii(q_a, ii_a, cross(r_a, imp));
        if (is_pair) {
          V3 nimp = V3{-imp.x, -imp.y, -imp.z};
          t.nb[0] = scale(nimp, nb_w);
          t.nb[1] = aii(nb_q, nb_ii, cross(r_b, nimp));
        }
        flag |= F_FRIC;
      }

      // Restitution: pre-solve approach velocity vs the post-solve one.
      V3 r_pre = sub(p, w.pos_i[b]);
      V3 v_pre = add(w.vel_i[b], cross(w.om_i[b], r_pre));
      float vn_pre = dot(v_pre, n);
      float w_n = c.w_n;
      if (lam > 0.0f && vn_pre < -P.rest_thresh && w_n > 1e-9f) {
        float vn_now = dot(sub(v_a, v_b), n);
        float jr = ((-P.restitution) * vn_pre - vn_now) / fmax2(w_n, 1e-9f);
        V3 imp = scale(n, jr);
        t.own[2] = imp;
        t.own[3] = aii(q_a, ii_a, cross(r_a, imp));
        flag |= F_REST;
      }
      w.sflag[i] = flag;
    });
    warp_sync();

    // ---- combine the velocity passes (a body per lane) ----
    lanes(nbd, [&](int b) {
      const V3 z = V3{0.0f, 0.0f, 0.0f};
      V3 fsum = z, fdom = z, rsum = z, rdom = z;
      float fcnt_a = 0.0f;
      for (int v = 0; v < N_VERTS; ++v) {
        const int i = b * N_VERTS + v;
        const unsigned char f = w.sflag[i];
        const SlotTerms& t = w.u.t[i];
        if (f & F_FRIC) {
          fsum = add(fsum, t.own[0]);
          fdom = add(fdom, t.own[1]);
          fcnt_a = fcnt_a + 1.0f;
        }
        if (f & F_REST) {
          rsum = add(rsum, t.own[2]);
          rdom = add(rdom, t.own[3]);
        }
      }
      V3 fsc_v = z, fsc_o = z;
      float fcnt_s = 0.0f;
      for (int q = 0; q < SLOT_WORDS; ++q) {
        for (unsigned int bits = w.pmask[b][q]; bits != 0u; bits &= bits - 1u) {
          const int i = q * 32 + low_bit(bits);
          if (!(w.sflag[i] & F_FRIC)) continue;
          fsc_v = add(fsc_v, w.u.t[i].nb[0]);
          fsc_o = add(fsc_o, w.u.t[i].nb[1]);
          fcnt_s = fcnt_s + 1.0f;
        }
      }
      float fcnt = fcnt_a + fcnt_s;
      float fnorm = 1.0f / fmax2(fcnt, 1.0f);
      V3 dvel = add(scale(fsum, w.inv_m[b]), fsc_v);
      V3 dom = add(fdom, fsc_o);
      V3 dvel_r = scale(rsum, w.inv_m[b]);
      V3 vn = add(add(w.vel_n[b], scale(dvel, fnorm)), dvel_r);
      V3 on = add(add(w.om_n[b], scale(dom, fnorm)), rdom);
      bool d = w.dyn[b] != 0;
      w.vel[b] = d ? vn : z;
      w.omega[b] = d ? on : z;
      if (d) {
        w.pos[b] = w.pos_c[b];
        w.quat[b] = w.quat_c[b];
      }
    });
    warp_sync();
  }
}

// ---- the sweep (standalone_sweep_packed with the plain raycast) ----------

// Nearest hit of one ray over the world's bodies, walls and planes
// (env/rays.py::raycast_world), in id order with a strict "<" (argmin's
// first occurrence); returns t, writes id (-1 on a miss).
MHS_HD float cast_ray(const SweepParams& P, const Layout& L, const World& w,
                      V3 o, V3 d, float max_t, int excl, int* id_out) {
  float tb = F_INF;
  int ib = -1;
  for (int b = 0; b < L.n_body; ++b) {
    if (!w.active[b] || b == excl) continue;
    float t = ray_body(o, d, w.pos[b], w.quat[b], w.half[b], L.is_ramp(b));
    if (t <= max_t && t < tb) {
      tb = t;
      ib = b;
    }
  }
  for (int k = 0; k < P.wall_bound; ++k) {
    if (!w.wact[k]) continue;
    float t = ray_aabb(o, d, sub(w.wpos[k], w.whalf[k]), add(w.wpos[k], w.whalf[k]));
    if (t <= max_t && t < tb) {
      tb = t;
      ib = L.n_body + k;
    }
  }
  for (int p = 0; p < P.n_plane; ++p) {
    if (!w.pact[p]) continue;
    float t = ray_plane(o, d, w.ppt[p], w.pn[p]);
    if (t <= max_t && t < tb) {
      tb = t;
      ib = L.n_body + P.n_wall + p;
    }
  }
  *id_out = tb < F_INF ? ib : -1;
  return tb;
}

// Other-agent slot of visibility column k of agent a (others_index_matrix).
MHS_HD int other_of(int a, int k) { return k < a ? k : k + 1; }

// Every ray of the world, one lane item each: per agent its visibility
// columns, its lidar and its next-step grab/lock ray, into w.u.o. A warp's
// items mix the three kinds, so each item first builds its ray, then all
// lanes cast together (one converged primitive loop), then each item
// writes its kind's result. Returns the seeker-sees-hider flag (a warp
// vote), on every lane.
__device__ __forceinline__ bool sweep(const SweepParams& P, const Layout& L,
                                   World& w) {
  const int na = L.n_agents;
  const int per = P.n_tgt + N_LIDAR + 1;
  SweepStage& O = w.u.o;
  return lanes_any(na * per, [&](int i) -> bool {
    const int a = i / per;
    const int r = i - a * per;
    const int sa = L.agent_lo + a;
    const V3 ap = w.pos[sa];
    const Q4 aq = w.quat[sa];
    const V3 fwd = quat_rotate(aq, V3{0.0f, 1.0f, 0.0f});
    const bool aact = w.aact[a] != 0;
    const bool is_vis = r < P.n_tgt;
    const bool is_lidar = !is_vis && r < P.n_tgt + N_LIDAR;
    // ---- the ray ----
    V3 o = ap, d;
    float max_t;
    int slot = 0;
    bool valid = false, col_hider = false;
    if (is_vis) {
      // Visibility column r: other agents (clamped), boxes, ramps.
      const int k = r;
      if (k < MAX_AGENTS - 1) {
        int oa = other_of(a, k);
        int oc = oa < na ? oa : na - 1;
        slot = L.agent_lo + oc;
        valid = oa < na && w.aact[oc];
        col_hider = w.atype[oc] == AGENT_HIDER;
      } else if (k < MAX_AGENTS - 1 + P.n_boxes) {
        int j = k - (MAX_AGENTS - 1);
        slot = j;
        valid = j < w.nab;
      } else {
        int j = k - (MAX_AGENTS - 1) - P.n_boxes;
        slot = L.ramp_lo + j;
        valid = j < w.nar;
      }
      d = sub(w.pos[slot], ap);
      max_t = 1.0f;
    } else if (is_lidar) {
      const int k = r - P.n_tgt;
      const V3 right = quat_rotate(aq, V3{1.0f, 0.0f, 0.0f});
      float c = P.lidar_cs[k];
      float s = P.lidar_cs[N_LIDAR + k];
      d = V3{c * right.x + s * fwd.x, c * right.y + s * fwd.y,
             c * right.z + s * fwd.z};
      float len = fmax2(norm3(d), 1e-9f);
      d = V3{d.x / len, d.y / len, d.z / len};
      max_t = P.lidar_range;
    } else {
      // Next step's grab/lock ray from the eye point.
      o = V3{ap.x + 0.0f, ap.y + 0.0f, ap.z + 0.5f};
      d = fwd;
      max_t = P.interact_len;
    }
    // ---- the cast ----
    int id;
    const float t = cast_ray(P, L, w, o, d, max_t, sa, &id);
    // ---- the result ----
    if (is_vis) {
      const int k = r;
      const bool is_seeker = aact && w.atype[a] == AGENT_SEEKER;
      float dist = norm3(d);
      float cos_angle = (d.x * fwd.x + d.y * fwd.y + d.z * fwd.z) / fmax2(dist, 1e-9f);
      bool in_cone = cos_angle >= P.cos_half_fov;
      bool seen = id == slot && in_cone && valid && aact;
      O.vis[a * P.n_tgt + k] = seen ? 1.0f : 0.0f;
      return k < MAX_AGENTS - 1 && seen && is_seeker && col_hider;
    }
    if (is_lidar) {
      const float act_f = aact ? 1.0f : 0.0f;
      O.lidar[a * N_LIDAR + (r - P.n_tgt)] = (id >= 0 ? t : 0.0f) * act_f;
      return false;
    }
    O.act_t[a] = t;
    O.act_id[a] = id;
    return false;
  });
}

// ---- the block's loads and stores (packed [rows, W] layout) --------------

using Blk = WorldBlock<World>;

#define MHS_AT(f) offsetof(World, f)
#define MHS_STAGE(f) (offsetof(World, u) + offsetof(SweepStage, f))

// Bodies, statics and grabs, from an argument struct with MegaArgs' /
// StepArgs' field names.
template <class Args>
MHS_HD void load_physics(const Args& A, const Layout& L, const Blk& K) {
  const int nb = L.n_body, na = L.n_agents;
  copy_in(K, A.pos, nb * 3, MHS_AT(pos));
  copy_in(K, A.quat, nb * 4, MHS_AT(quat));
  copy_in(K, A.vel, nb * 3, MHS_AT(vel));
  copy_in(K, A.omega, nb * 3, MHS_AT(omega));
  copy_in(K, A.inv_mass, nb, MHS_AT(inv_m));
  copy_in(K, A.inv_inertia, nb * 3, MHS_AT(inv_i));
  copy_in(K, A.active, nb, MHS_AT(active));
  copy_in(K, A.locked, nb, MHS_AT(locked));
  copy_in(K, A.half_ext, nb * 3, MHS_AT(half));
  copy_in(K, A.friction_mu, nb, MHS_AT(mu));
  copy_in(K, A.wall_pos, A.n_wall * 3, MHS_AT(wpos));
  copy_in(K, A.wall_half, A.n_wall * 3, MHS_AT(whalf));
  copy_in(K, A.wall_active, A.n_wall, MHS_AT(wact));
  copy_in(K, A.plane_point, A.n_plane * 3, MHS_AT(ppt));
  copy_in(K, A.plane_normal, A.n_plane * 3, MHS_AT(pn));
  copy_in(K, A.plane_active, A.n_plane, MHS_AT(pact));
  copy_in(K, A.g_target, na, MHS_AT(g_target));
  copy_in(K, A.g_r2, na * 3, MHS_AT(g_r2));
  copy_in(K, A.g_relq, na * 4, MHS_AT(g_relq));
  copy_in(K, A.g_sep, na, MHS_AT(g_sep));
}

template <class Args>
MHS_HD void load_sweep(const Args& A, const Layout& L, const Blk& K) {
  copy_in(K, A.agent_type, L.n_agents, MHS_AT(atype));
  copy_in(K, A.agent_active, L.n_agents, MHS_AT(aact));
  copy_in(K, A.num_boxes, 1, MHS_AT(nab));
  copy_in(K, A.num_ramps, 1, MHS_AT(nar));
}

template <class Args>
MHS_HD void store_bodies(const Args& A, const Layout& L, const Blk& K) {
  const int nb = L.n_body;
  copy_out(K, A.pos_o, nb * 3, MHS_AT(pos));
  copy_out(K, A.quat_o, nb * 4, MHS_AT(quat));
  copy_out(K, A.vel_o, nb * 3, MHS_AT(vel));
  copy_out(K, A.omega_o, nb * 3, MHS_AT(omega));
}

template <class Args>
MHS_HD void store_sweep(const Args& A, const Layout& L, const Blk& K) {
  const int na = L.n_agents;
  copy_out(K, A.vis_o, na * A.n_tgt, MHS_STAGE(vis));
  copy_out(K, A.lidar_o, na * N_LIDAR, MHS_STAGE(lidar));
  copy_out(K, A.act_t_o, na, MHS_STAGE(act_t));
  copy_out(K, A.act_id_o, na, MHS_STAGE(act_id));
  copy_out(K, A.rew_seen_o, 1, MHS_AT(rew_seen));
}

// Effective masses (physics.physics_step) of body b: zero unless active
// and not locked.
MHS_HD void set_dynamic(World& w, int b) {
  bool d = w.active[b] && !w.locked[b];
  w.dyn[b] = d ? 1 : 0;
  w.inv_m[b] = d ? w.inv_m[b] : 0.0f;
  w.inv_i[b] = d ? w.inv_i[b] : V3{0.0f, 0.0f, 0.0f};
}

// ---- K4: the megastep --------------------------------------------------------

MHS_HD void mega_load(const MegaArgs& A, const Layout& L, const Blk& K) {
  const int nb = L.n_body, na = L.n_agents;
  load_physics(A, L, K);
  load_sweep(A, L, K);
  copy_in(K, A.owner, nb, MHS_AT(owner));
  copy_in(K, A.actions, na * 5, MHS_AT(actions));
  copy_in(K, A.act_hit_t, na, MHS_AT(hit_t));
  copy_in(K, A.act_hit_id, na, MHS_AT(hit_id));
  copy_in(K, A.step, 1, MHS_AT(step));
  copy_in(K, A.seekers_first, 1, MHS_AT(seekers_first));
  copy_in(K, A.running, 2, MHS_AT(running));
  copy_in(K, A.finished, 2, MHS_AT(finished));
}

MHS_HD void mega_store(const MegaArgs& A, const Layout& L, const Blk& K) {
  const int nb = L.n_body, na = L.n_agents;
  store_bodies(A, L, K);
  copy_out(K, A.locked_o, nb, MHS_AT(locked));
  copy_out(K, A.owner_o, nb, MHS_AT(owner));
  copy_out(K, A.g_target_o, na, MHS_AT(g_target));
  copy_out(K, A.g_r2_o, na * 3, MHS_AT(g_r2));
  copy_out(K, A.g_relq_o, na * 4, MHS_AT(g_relq));
  copy_out(K, A.g_sep_o, na, MHS_AT(g_sep));
  store_sweep(A, L, K);
  copy_out(K, A.rewards_o, na, MHS_AT(rewards));
  copy_out(K, A.dones_o, na, MHS_AT(dones));
  copy_out(K, A.team_r_o, 1, MHS_AT(team_r));
  copy_out(K, A.running_o, 2, MHS_AT(running));
  copy_out(K, A.finished_o, 2, MHS_AT(finished));
}

// Agent a's grab/lock (action_system_packed) on its carried ray hit: its
// own grab is updated in place; its lock request goes to req_*.
MHS_HD void grab_lock_agent(const MegaArgs& A, const Layout& L, World& w,
                            int a) {
  const int sa = L.agent_lo + a;
  const bool frozen = w.atype[a] == AGENT_SEEKER && w.step < A.num_prep - 1;
  const bool can_act = w.aact[a] && !frozen;
  const V3 ap = w.pos[sa];
  const Q4 aq = w.quat[sa];
  V3 eye = V3{ap.x, ap.y, ap.z + 0.5f};
  V3 fwd = qrot_c(aq, V3{0.0f, 1.0f, 0.0f}, false);
  bool want_lock = w.actions[a * 5 + 4] == 1 && can_act;
  bool want_grab = w.actions[a * 5 + 3] == 1 && can_act;
  int hit_id = w.hit_id[a];
  float hit_t = w.hit_t[a];
  bool is_obj = hit_id >= 0 && hit_id < L.ramp_hi;
  int tgt = is_obj ? hit_id : 0;
  bool t_locked = w.locked[tgt] != 0;
  int t_owner = w.owner[tgt];
  int my_team = w.atype[a] == AGENT_HIDER ? OWNER_HIDER : OWNER_SEEKER;
  bool do_unlock = want_lock && is_obj && t_locked && t_owner == my_team;
  bool do_lock = want_lock && is_obj && !t_locked && t_owner == OWNER_NONE;
  w.req_tgt[a] = tgt;
  w.req_kind[a] = do_lock ? 1 : (do_unlock ? 2 : 0);
  w.req_team[a] = my_team;

  bool has_grab = w.g_target[a] >= 0;
  bool release = want_grab && has_grab;
  bool grabbable = is_obj && !t_locked && t_owner == OWNER_NONE;
  bool acquire = want_grab && !has_grab && grabbable;
  float safe_t = is_obj ? hit_t : 0.0f;
  V3 hit_pos = V3{eye.x + fwd.x * safe_t, eye.y + fwd.y * safe_t,
                  eye.z + fwd.z * safe_t};
  Q4 tq = w.quat[tgt];
  V3 rel = sub(hit_pos, w.pos[tgt]);
  V3 r2_new = qrot_c(tq, rel, true);
  Q4 rq_new = qnorm(quat_mul(qconj(tq), aq));
  float sep_new = safe_t - 1.25f;
  w.g_target[a] = release ? -1 : (acquire ? tgt : w.g_target[a]);
  if (acquire) {
    w.g_r2[a] = r2_new;
    w.g_relq[a] = rq_new;
    w.g_sep[a] = sep_new;
  }
}

// Body b before the physics: its locks from the agents' requests, its
// movement force and torque (movement_packed), its effective masses.
MHS_HD void mega_body(const MegaArgs& A, const Layout& L, World& w, int b) {
  bool lock_any = false, unlock_any = false;
  int lock_team = 0;
  for (int a = 0; a < L.n_agents; ++a) {
    if (w.req_tgt[a] != b) continue;
    if (w.req_kind[a] == 1) {
      lock_any = true;
      lock_team = lock_team > w.req_team[a] ? lock_team : w.req_team[a];
    }
    if (w.req_kind[a] == 2) unlock_any = true;
  }
  w.locked[b] = lock_any ? 1 : (unlock_any ? 0 : w.locked[b]);
  w.owner[b] = lock_any ? lock_team : (unlock_any ? OWNER_NONE : w.owner[b]);

  V3 ef = V3{0.0f, 0.0f, 0.0f}, et = V3{0.0f, 0.0f, 0.0f};
  if (b >= L.agent_lo) {
    const int a = b - L.agent_lo;
    bool frozen = w.atype[a] == AGENT_SEEKER && w.step < A.num_prep - 1;
    float gate = (w.aact[a] && !frozen) ? 1.0f : 0.0f;
    const int* act = w.actions + a * 5;
    float fx = A.f_per * static_cast<float>(act[0] - A.half_bucket);
    float fy = A.f_per * static_cast<float>(act[1] - A.half_bucket);
    float tz = A.t_per * static_cast<float>(act[2] - A.half_bucket);
    V3 fw = qrot_c(w.quat[b], V3{fx, fy, 0.0f}, false);
    ef = V3{fw.x * gate, fw.y * gate, fw.z * gate};
    et = V3{0.0f * gate, 0.0f * gate, tz * gate};
  }
  w.ext_f[b] = ef;
  w.ext_t[b] = et;
  set_dynamic(w, b);
}

__device__ void megastep_world(const MegaArgs& A, World& w) {
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  const int na = L.n_agents;

  // ---- grab / lock requests (an agent per lane), then each body's locks,
  // forces and effective masses (a body per lane) ----
  lanes(na, [&](int a) { grab_lock_agent(A, L, w, a); });
  warp_sync();
  lanes(L.n_body, [&](int b) { mega_body(A, L, w, b); });
  warp_sync();

  physics_step(phys_params(A), L, w);

  // ---- sweep on the post-physics pose ----
  const bool rew_seen = sweep(sweep_params(A), L, w);
  const float team_r = rew_seen ? -1.0f : 1.0f;
  const int step = w.step;
  const bool at_end = step == A.episode_len - 1;

  // ---- zero agent velocities, rewards, dones (an agent per lane) ----
  lanes(na, [&](int a) {
    const int sa = L.agent_lo + a;
    if (A.zero_agent_vel) {
      w.vel[sa] = V3{0.0f, 0.0f, fmin2(w.vel[sa].z, 0.0f)};
      w.omega[sa] = V3{0.0f, 0.0f, 0.0f};
    }
    float sign = w.atype[a] == AGENT_SEEKER ? -1.0f : 1.0f;
    float reward = sign * team_r;
    bool oob = fabsf(w.pos[sa].x) >= 18.0f || fabsf(w.pos[sa].y) >= 18.0f;
    reward = reward - 10.0f * (oob ? 1.0f : 0.0f);
    if (step < A.num_prep - 1) reward = 0.0f;
    reward = reward * (w.aact[a] ? 1.0f : 0.0f);
    w.rewards[a] = reward;
    w.dones[a] = at_end ? 1 : 0;
  });

  // ---- episode results ----
  lane0([&]() {
    int scores[2];
    float fin[2];
    for (int i = 0; i < 2; ++i) {
      scores[i] = step == 0 ? 0 : w.running[i];
      fin[i] = step == 0 ? 0.0f : w.finished[i];
    }
    int hid_idx = w.seekers_first ? 1 : 0;
    int winner = team_r > 0.0f ? hid_idx : 1 - hid_idx;
    if (step >= A.num_prep) scores[winner] += 1;
    if (at_end) {
      fin[0] = scores[0] > scores[1] ? 1.0f : (scores[0] < scores[1] ? 0.0f : 0.5f);
      fin[1] = scores[0] > scores[1] ? 0.0f : (scores[0] < scores[1] ? 1.0f : 0.5f);
    }
    for (int i = 0; i < 2; ++i) {
      w.running[i] = scores[i];
      w.finished[i] = fin[i];
    }
    w.team_r = team_r;
    w.rew_seen = rew_seen ? 1 : 0;
  });
}

// ---- K2 / K3: the physics step from given forces, then (kSweep) the
// sweep on the moved bodies. Locks and grabs are inputs. ----------------------

template <bool kSweep>
MHS_HD void step_load(const StepArgs& A, const Layout& L, const Blk& K) {
  load_physics(A, L, K);
  copy_in(K, A.ext_force, L.n_body * 3, MHS_AT(ext_f));
  copy_in(K, A.ext_torque, L.n_body * 3, MHS_AT(ext_t));
  if constexpr (kSweep) load_sweep(A, L, K);
}

template <bool kSweep>
MHS_HD void step_store(const StepArgs& A, const Layout& L, const Blk& K) {
  store_bodies(A, L, K);
  if constexpr (kSweep) store_sweep(A, L, K);
}

template <bool kSweep>
__device__ void step_world(const StepArgs& A, World& w) {
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  lanes(L.n_body, [&](int b) { set_dynamic(w, b); });
  warp_sync();
  physics_step(phys_params(A), L, w);
  if constexpr (kSweep) {
    const bool rew_seen = sweep(sweep_params(A), L, w);
    lane0([&]() { w.rew_seen = rew_seen ? 1 : 0; });
  }
}

#ifndef MHS_HOST_BUILD
__device__ __forceinline__ Blk block_worlds(long long W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w0 = blockIdx.x * WORLDS_PER_BLOCK;
  const long long left = W - w0;
  return Blk{reinterpret_cast<World*>(smem), W, w0,
             left < WORLDS_PER_BLOCK ? static_cast<int>(left)
                                     : WORLDS_PER_BLOCK};
}

// At most 168 registers a thread, so that 3 blocks (12 worlds) fit an SM
// by registers as by shared memory.
__global__ void __launch_bounds__(BLOCK_THREADS, 3)
    megastep_kernel(const MegaArgs A) {
  const Blk K = block_worlds(A.W);
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  mega_load(A, L, K);
  __syncthreads();
  const int wi = threadIdx.x / WARP;
  if (wi < K.nw) megastep_world(A, K.sw[wi]);
  __syncthreads();
  mega_store(A, L, K);
}

template <bool kSweep>
__global__ void __launch_bounds__(BLOCK_THREADS, 3)
    step_kernel(const StepArgs A) {
  const Blk K = block_worlds(A.W);
  const Layout L = make_layout(A.n_boxes, A.n_ramps, A.n_agents);
  step_load<kSweep>(A, L, K);
  __syncthreads();
  const int wi = threadIdx.x / WARP;
  if (wi < K.nw) step_world<kSweep>(A, K.sw[wi]);
  __syncthreads();
  step_store<kSweep>(A, L, K);
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
static_assert(SLOTS_PER_LANE * WARP >= N_SLOTS, "slots per lane");

constexpr int SMEM_BYTES = WORLDS_PER_BLOCK * static_cast<int>(sizeof(World));

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entries: the same code, the block's worlds one after
// another and each world's lanes one after another in every phase.
template <class Args, class Load, class Run, class Store>
static void host_blocks(const Args& a, Load load, Run run, Store store) {
  World* sw = new World[WORLDS_PER_BLOCK];
  const Layout L = make_layout(a.n_boxes, a.n_ramps, a.n_agents);
  for (int w0 = 0; w0 < a.W; w0 += WORLDS_PER_BLOCK) {
    const int left = a.W - w0;
    const Blk K{sw, a.W, w0, left < WORLDS_PER_BLOCK ? left : WORLDS_PER_BLOCK};
    load(a, L, K);
    for (int j = 0; j < K.nw; ++j) run(a, sw[kReverse ? K.nw - 1 - j : j]);
    store(a, L, K);
  }
  delete[] sw;
}

extern "C" int mhs_megastep_host(void* const* ptrs, int n_ptrs, const int* ip,
                                 int n_i, const float* fp, int n_f) {
  MegaArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f)) return 1;
  host_blocks(a, mega_load, megastep_world, mega_store);
  return 0;
}

extern "C" int mhs_physics_host(void* const* ptrs, int n_ptrs, const int* ip,
                                int n_i, const float* fp, int n_f) {
  StepArgs a;
  if (!fill_step_args(&a, ptrs, n_ptrs, N_PHYS_PTRS, ip, n_i, fp, n_f))
    return 1;
  host_blocks(a, step_load<false>, step_world<false>, step_store<false>);
  return 0;
}

extern "C" int mhs_fused_host(void* const* ptrs, int n_ptrs, const int* ip,
                              int n_i, const float* fp, int n_f) {
  StepArgs a;
  if (!fill_step_args(&a, ptrs, n_ptrs, N_FUSED_PTRS, ip, n_i, fp, n_f))
    return 1;
  host_blocks(a, step_load<true>, step_world<true>, step_store<true>);
  return 0;
}
#else
// Dynamic shared memory above 48 KB must be allowed per kernel (and per
// device) before a launch.
template <class Kernel>
static int allow_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

extern "C" int mhs_megastep(void* const* ptrs, int n_ptrs, const int* ip,
                            int n_i, const float* fp, int n_f, void* stream) {
  MegaArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, fp, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W <= 0) return 0;
  const int attr = allow_smem(megastep_kernel);
  if (attr != 0) return attr;
  const int blocks = (a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK;
  megastep_kernel<<<blocks, BLOCK_THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(a);
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
  const int attr = allow_smem(step_kernel<kSweep>);
  if (attr != 0) return attr;
  const int blocks = (a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK;
  step_kernel<kSweep><<<blocks, BLOCK_THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(a);
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

// Launch shape and occupancy of the three entries: out[0] worlds per
// block, out[1] shared bytes per world, out[2..4] resident blocks per SM
// of the megastep, physics and fused kernels.
extern "C" int mhs_megastep_occupancy(int* out) {
  out[0] = WORLDS_PER_BLOCK;
  out[1] = static_cast<int>(sizeof(World));
  int err = allow_smem(megastep_kernel);
  err = err ? err : allow_smem(step_kernel<false>);
  err = err ? err : allow_smem(step_kernel<true>);
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], megastep_kernel, BLOCK_THREADS, SMEM_BYTES));
  err = err ? err : static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], step_kernel<false>, BLOCK_THREADS, SMEM_BYTES));
  err = err ? err : static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], step_kernel<true>, BLOCK_THREADS, SMEM_BYTES));
  return err;
}
#endif
