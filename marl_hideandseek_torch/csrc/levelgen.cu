// K7: level-1 generation - the procedural arena of
// env/levelgen.py::generate_training_world for a batch of worlds, from
// their draws to every leaf of the packed state, in one launch.
//
// Replaces no Pallas kernel. The JAX package generates levels in jnp
// (marl_hideandseek_tpu/env/levelgen.py, geometry.py), which XLA fuses
// into a few programs; op by op, the port's plain version
// (env/levelgen.py::generate_training_world with env/geometry.py's wall
// grammar) issues ~40,000 PyTorch kernels from the host a call whatever
// the number of worlds, and the card waits on their dispatch. This
// kernel computes that function with its op order: the wall grammar
// (border walls, 12 ops of "connect two parallel walls and cut a door
// into the connector" with 5 attempts, or "cut a door into a long
// wall"), the scaling to the arena and the walls' boxes, then the
// rejection placement of every box, ramp and agent slot (21 poses each,
// the first that clears every placed AABB, else the first), their
// inertia, and the episode's tail (agent activity and types, counts,
// keys). The random draws are not made here: the threefry kernel makes
// them from JAX's key tree in a few batched launches
// (env/levelgen.py::level_draws) and this kernel maps them to their
// ranges, so a world still equals JAX's generate_world for its key.
// Built with --fmad=false, with the CUDA math library's sinf / cosf that
// PyTorch's CUDA sin / cos reach, it agrees with the plain version on
// the card to the last bit.
//
// Bound: latency and instructions, not bytes. A world reads ~8 KB of
// draws and writes ~3 KB of state, but its program is sequential: 12
// grammar ops, each depending on the walls the last one left, then 15
// placements (17 in 3v3), each against the boxes placed before it. So
// the design keeps one world's program on one warp and spreads each
// step's independent work over the lanes: the 36 wall slots for the
// list masks (two ballots) and the partner search with its blocker test
// over the listed walls; the 21 trials of a placement, each tested
// against up to 47 placed AABBs, with a ballot and find-first for the
// first clear trial (the plain version's argmin over the ranks). The
// scalars of the program (wall count, op budgets, the attempt's choices)
// are computed alike on every lane, so they need no broadcast; lane 0
// writes the world's arrays (walls, placed AABBs, poses) in shared
// memory, ~2 KB a world, between warp barriers. Worlds are independent,
// so warps run them side by side: WORLDS_PER_BLOCK worlds a block, as
// many blocks as worlds need (1 for a fixed world, 256 worlds for a
// compact reset, 65,536 for a full reset at 64k). Once the block's
// worlds are done, its threads write every leaf from shared memory in
// the packed [..., W] layout, consecutive threads on consecutive worlds
// of one row, so the stores coalesce.
//
// The body counts arrive at run time (capacity: common.cuh), so one
// build serves 1v1, 2v2, 3v3 and the openai_hns_3v3 cell. The draws are
// read from G rows: G = W, or G = 1 under UseFixedWorld, where every
// world is drawn from the zero key.
//
// Host build (-DMHS_HOST_BUILD): the lanes of each phase and the block's
// warps and store items run one after another (lanes.cuh;
// -DMHS_LANES_REVERSE in reverse), the blocks one after another.

#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "lanes.cuh"

using namespace mhs;

namespace {

constexpr int WORLDS_PER_BLOCK = 8;
constexpr int BLOCK_THREADS = WORLDS_PER_BLOCK * WARP;
constexpr int OPS = 12;              // geometry.MAX_TOTAL_OPS
constexpr int ATTEMPTS = 5;          // geometry.CONNECT_ATTEMPTS
constexpr int MAX_CONNECT = 6;
constexpr int MAX_ADD_DOORS = 7;
constexpr int N_WALL_BITS = 2 + OPS * (2 + 3 * ATTEMPTS);  // 206
constexpr int N_WALL_U = OPS * (1 + 2 * ATTEMPTS);         // 132
constexpr int N_TRIALS = 21;         // levelgen.MAX_REJECTIONS + 1
constexpr int POSE_U = 4 * N_TRIALS; // x, y of each trial, then yaws
constexpr int MAX_PLACED = MAX_WALLS + MAX_BOXES + MAX_RAMPS;
constexpr float EPS_H = 0x1.0c6f7ap-20f;      // float32(1e-6)
constexpr float PI_F = 0x1.921fb6p+1f;        // float32(pi)
constexpr int OWNER_UNOWNABLE = 3;
constexpr int AGENT_SEEKER = 0;
constexpr int AGENT_HIDER = 1;

// The inputs, then the 37 leaves of the packed EnvState in field order.
enum Input {
  WALL_BITS, WALL_U, COUNT_BITS, POSE, EP_KEY, LEVEL_KEY, NUM_HIDERS,
  NUM_SEEKERS, SEEKERS_FIRST, N_INPUTS
};
enum Leaf {
  POS, QUAT, VEL, OMEGA, HALF_EXT, INV_MASS, INV_INERTIA, FRICTION,
  ACTIVE, LOCKED, OWNER, WALL_POS, WALL_HALF, WALL_ACTIVE, PLANE_POINT,
  PLANE_NORMAL, PLANE_ACTIVE, GRAB_TARGET, GRAB_R2, GRAB_REL_Q, GRAB_SEP,
  AGENT_TYPE, AGENT_ACTIVE, OUT_HIDERS, OUT_SEEKERS, OUT_BOXES, OUT_RAMPS,
  STEP, EPISODE_COUNTER, OUT_EP_KEY, OUT_LEVEL_KEY, OUT_SEEKERS_FIRST,
  RUNNING_SCORES, FINISHED_SCORES, HIDER_TEAM_REWARD, ACT_HIT_T,
  ACT_HIT_ID, N_LEAVES
};
constexpr int N_PTRS = N_INPUTS + N_LEAVES;
constexpr int N_INTS = 5;            // W, G, boxes, ramps, agents

struct GenArgs {
  const uint32_t* wall_bits;   // [G, N_WALL_BITS, 2] (high, low) words
  const float* wall_u;         // [G, N_WALL_U]
  const uint32_t* count_bits;  // [G, 2, 2]
  const float* pose_u;         // [G, bodies, 2, 42]
  const uint32_t* ep_key;      // [2, W]
  const uint32_t* level_key;   // [2, W]
  const long long* num_hiders; // [W]
  const long long* num_seekers;
  const unsigned char* seekers_first;
  void* out[N_LEAVES];
  int W, G, nb, nr, na;
};

// One world in shared memory. Walls hold the unit square's endpoints
// during the grammar and the arena's after scaling; placed AABBs are the
// walls' (slots [0, 36)), then the box and ramp slots'.
struct World {
  float p1[2][MAX_WALLS], p2[2][MAX_WALLS];
  float lo[MAX_PLACED][3], hi[MAX_PLACED][3];
  float pos[MAX_BODIES][3];
  float qw[MAX_BODIES], qz[MAX_BODIES];
  int n_walls, total_boxes, num_elong;
};

#ifdef MHS_HOST_BUILD
inline int popc64(uint64_t m) { return __builtin_popcountll(m); }
inline int low_bit64(uint64_t m) { return __builtin_ctzll(m); }
// Bit i set where f(i), i < n <= 64, over the warp's lanes.
template <class F>
inline uint64_t warp_mask(int n, F&& f) {
  uint64_t m = 0;
  lanes(n, [&](int i) {
    if (f(i)) m |= 1ull << i;
  });
  return m;
}
#else
__device__ __forceinline__ int popc64(uint64_t m) { return __popcll(m); }
__device__ __forceinline__ int low_bit64(uint64_t m) {
  return __ffsll(static_cast<long long>(m)) - 1;
}
template <class F>
__device__ __forceinline__ uint64_t warp_mask(int n, F&& f) {
  uint64_t m = 0;
  for (int base = 0; base < n; base += WARP) {
    const int i = base + lane_id();
    const bool b = i < n && f(i);
    m |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, b)) << base;
  }
  return m;
}
#endif

// prng.randint_from_bits: jax.random.randint's map of its two 32-bit
// draws to [minval, maxval) (int32 semantics, 32-bit wraparound).
MHS_HD int randint(uint32_t hi, uint32_t lo, int minval, int maxval) {
  const uint64_t span =
      maxval > minval ? static_cast<uint64_t>(maxval - minval) : 1u;
  uint64_t mult = 65536u % span;
  mult = ((mult * mult) & 0xffffffffu) % span;
  const uint64_t off =
      ((((hi % span) * mult) & 0xffffffffu) + lo % span) & 0xffffffffu;
  return minval + static_cast<int>(off % span);
}

// The i-th randint of a draw row: its (high, low) words.
MHS_HD int draw_int(const uint32_t* bits, int i, int minval, int maxval) {
  return randint(bits[2 * i], bits[2 * i + 1], minval, maxval);
}

// Index of the nth (0-based) set bit; 0 if none (geometry._pick_nth_true).
MHS_HD int nth_bit(uint64_t m, int nth) {
  for (int k = 0; m != 0; ++k, m >>= 1)
    if ((m & 1u) && nth-- == 0) return k;
  return 0;
}

// A wall in a frame: the stored one (ax = 0) or the xy-swapped one
// (ax = 1) the vertical connect runs on (geometry._swap_xy; swapping is
// exact, so reading through the frame equals swapping the arrays).
struct Seg {
  float ax, ay, bx, by;
};

MHS_HD Seg get(const World& s, int ax, int k) {
  return Seg{s.p1[ax][k], s.p1[1 - ax][k], s.p2[ax][k], s.p2[1 - ax][k]};
}

MHS_HD bool horizontal(const Seg& g) { return fabsf(g.ay - g.by) < EPS_H; }

// geometry._sort_endpoints (the test is the same in either frame).
MHS_HD Seg sorted(Seg g) {
  if (g.ax > g.bx || g.ay > g.by) return Seg{g.bx, g.by, g.ax, g.ay};
  return g;
}

// geometry._set_wall: every lane has read what it needs before lane 0
// writes, and sees the write after.
MHS_DEV void set_wall(World& s, int ax, int idx, Seg g) {
  g = sorted(g);
  warp_sync();
  lane0([&] {
    s.p1[ax][idx] = g.ax;
    s.p1[1 - ax][idx] = g.ay;
    s.p2[ax][idx] = g.bx;
    s.p2[1 - ax][idx] = g.by;
  });
  warp_sync();
}

// geometry._append_wall: slot clamp(n, 0, 35), then n + 1 (n itself is
// not clamped; at most 34 walls arise).
MHS_DEV void append_wall(World& s, int ax, int& n, Seg g) {
  set_wall(s, ax, n < 0 ? 0 : (n > MAX_WALLS - 1 ? MAX_WALLS - 1 : n), g);
  ++n;
}

// geometry.add_door: wall idx ends at a door of size ds (half its size
// hd) whose centre lies in the middle 40% of its span, at uniform u; a
// new wall runs from the door to the old end.
MHS_DEV void add_door(World& s, int ax, int& n, int idx, float ds, float hd,
                      float u) {
  const Seg g = get(s, ax, idx);
  const bool is_x = horizontal(g);
  const float rat = 0.3f + 0.4f * u;
  const float lo = (is_x ? g.ax : g.ay) + ds;
  const float hi = (is_x ? g.bx : g.by) - ds;
  const float c = lo + rat * (hi - lo);
  const float old_end = is_x ? g.bx : g.by;
  const float cm = c - hd, cp = c + hd;
  const Seg shrunk = is_x ? Seg{g.ax, g.ay, cm, g.by}
                          : Seg{g.ax, g.ay, g.bx, cm};
  const Seg added = is_x ? Seg{cp, g.ay, old_end, g.ay}
                         : Seg{g.ax, cp, g.ax, old_end};
  set_wall(s, ax, idx, shrunk);
  append_wall(s, ax, n, added);
}

// geometry._find_another_wall in frame ax: the listed walls that overlap
// wall `chosen` in x, are long enough with it, and have no listed wall
// between them; the first in list order from position `start`. Lanes
// over the candidates, each testing every listed wall as a blocker.
// Returns the slot, or -1 if none.
MHS_DEV int find_partner(const World& s, int ax, uint64_t list, int chosen,
                         float min_len, uint32_t start_hi,
                         uint32_t start_lo) {
  const Seg c = get(s, ax, chosen);
  const float c_len = c.bx - c.ax;
  const uint64_t valid = warp_mask(MAX_WALLS, [&](int j) {
    if (!((list >> j) & 1u) || j == chosen) return false;
    const Seg g = get(s, ax, j);
    const bool overlap = !((c.ax >= g.bx) || (c.bx <= g.ax));
    const bool len_ok = (c_len >= min_len) && (g.bx - g.ax >= min_len);
    if (!(overlap && len_ok)) return false;
    const float ib_lo0 = fmax2(c.ax, g.ax) - 0.1f;
    const float ib_hi0 = fmin2(c.bx, g.bx) + 0.1f;
    const float y_min = fmin2(c.ay, g.ay), y_max = fmax2(c.ay, g.ay);
    for (uint64_t m = list; m != 0; m &= m - 1) {
      const int k = low_bit64(m);
      if (k == j) continue;
      const Seg b = get(s, ax, k);
      if (fmax2(b.ax, ib_lo0) < fmin2(b.bx, ib_hi0) && b.ay > y_min &&
          b.ay < y_max)
        return false;
    }
    return true;
  });
  if (valid == 0) return -1;
  const int span = popc64(list) > 0 ? popc64(list) : 1;
  const int start = randint(start_hi, start_lo, 0, span);
  int best = -1, best_rank = MAX_WALLS + 1;
  for (uint64_t m = valid; m != 0; m &= m - 1) {
    const int j = low_bit64(m);
    const int pos = popc64(list & ((1ull << j) - 1u));
    const int rank = ((pos - start) % span + span) % span;
    if (rank < best_rank) {
      best_rank = rank;
      best = j;
    }
  }
  return best;
}

// geometry._connect_walls_canonical: join horizontal walls a and b with
// a vertical connector at uniform u0, split both at it, and cut a door
// into it at uniform u1.
MHS_DEV void connect(World& s, int ax, int& n, int a, int b, float u0,
                     float u1) {
  const bool a_low = get(s, ax, a).ay <= get(s, ax, b).ay;
  const int first = a_low ? a : b, second = a_low ? b : a;
  const Seg f = get(s, ax, first), g = get(s, ax, second);
  const float high = fmin2(f.bx, g.bx);
  const float low = fmax2(f.ax, g.ax);
  const float rat = 0.4f + 0.2f * u0;
  const float x = low + rat * (high - low);
  const int connector = n;
  append_wall(s, ax, n, Seg{x, f.ay, x, g.ay});
  set_wall(s, ax, first, Seg{f.ax, f.ay, x, f.by});
  set_wall(s, ax, second, Seg{g.ax, g.ay, x, g.by});
  append_wall(s, ax, n, Seg{x, f.ay, f.bx, f.ay});
  append_wall(s, ax, n, Seg{x, g.ay, g.bx, g.ay});
  add_door(s, ax, n, connector, 0.1f, 0.05f, u1);
}

// geometry.op_connect_and_add_door: up to 5 attempts, each on a random
// orientation (the vertical one on the swapped frame), a random listed
// wall and its first partner; the first attempt with a partner connects.
MHS_DEV void op_connect(World& s, int& n, const uint32_t* bits,
                        const float* u) {
  for (int t = 0; t < ATTEMPTS; ++t) {
    const uint32_t* b = bits + 6 * t;
    const int ax = randint(b[0], b[1], 0, 2) == 1 ? 0 : 1;
    const int nn = n;
    const uint64_t list = warp_mask(MAX_WALLS, [&](int k) {
      return k < nn && horizontal(get(s, ax, k));
    });
    const int list_len = popc64(list);
    const int nth = randint(b[2], b[3], 0, list_len > 1 ? list_len : 1);
    const int chosen = nth_bit(list, nth);
    const int other = find_partner(s, ax, list, chosen,
                                   ax == 0 ? 0.3f : 0.5f, b[4], b[5]);
    if (other >= 0) {
      connect(s, ax, n, chosen, other, u[2 * t], u[2 * t + 1]);
      return;
    }
  }
}

// geometry.op_add_door: a door into a random wall longer than three door
// widths.
MHS_DEV void op_door(World& s, int& n, uint32_t hi, uint32_t lo, float u) {
  const int idx = randint(hi, lo, 0, n > 1 ? n : 1);
  const Seg g = get(s, 0, idx);
  const float length = horizontal(g) ? g.bx - g.ax : g.by - g.ay;
  if (length > 0.6f) add_door(s, 0, n, idx, 0.2f, 0.1f, u);
}

// geometry.build_walls: border walls, op counts (1-6 connects, 4-6
// doors), then ops chosen uniformly among the types with budget left.
// Returns the wall count.
MHS_DEV int make_walls(World& s, const uint32_t* bits, const float* u) {
  lanes(MAX_WALLS, [&](int k) {
    s.p1[0][k] = s.p1[1][k] = s.p2[0][k] = s.p2[1][k] = 0.0f;
  });
  int n = 0;
  append_wall(s, 0, n, Seg{0.0f, 0.0f, 1.0f, 0.0f});
  append_wall(s, 0, n, Seg{0.0f, 0.0f, 0.0f, 1.0f});
  append_wall(s, 0, n, Seg{0.0f, 1.0f, 1.0f, 1.0f});
  append_wall(s, 0, n, Seg{1.0f, 1.0f, 1.0f, 0.0f});
  int budget[2] = {1 + draw_int(bits, 0, 0, MAX_CONNECT),
                   4 + draw_int(bits, 1, 0, MAX_ADD_DOORS - 4)};
  for (int i = 0; i < OPS; ++i) {
    const int n_avail = (budget[0] > 0) + (budget[1] > 0);
    const int r = draw_int(bits, 2 + i, 0, n_avail > 1 ? n_avail : 1);
    if (n_avail == 0) continue;
    const int op = budget[0] > 0 && r == 0 ? 0 : 1;
    --budget[op];
    if (op == 0)
      op_connect(s, n, bits + 2 * (2 + OPS + 3 * ATTEMPTS * i),
                 u + 2 * ATTEMPTS * i);
    else
      op_door(s, n, bits[2 * (2 + OPS + 3 * ATTEMPTS * OPS + i)],
              bits[2 * (2 + OPS + 3 * ATTEMPTS * OPS + i) + 1],
              u[2 * ATTEMPTS * OPS + i]);
  }
  return n;
}

// geometry.walls_to_obbs on the arena's wall k.
MHS_HD void wall_box(const World& s, int k, V3* pos, V3* half) {
  const Seg g = get(s, 0, k);
  const bool horiz = horizontal(g);
  const float cx = 0.5f * (g.ax + g.bx), cy = 0.5f * (g.ay + g.by);
  *pos = V3{cx, cy, 1.25f};
  *half = V3{horiz ? g.bx - cx : 0.2f, horiz ? 0.2f : g.by - cy, 1.25f};
}

// A body slot's shape (levelgen._training_geometry): boxes elongated
// below num_elong, ramps with their wedge's centre offset, agents.
struct Shape {
  V3 half, off;
  float inv_mass, friction;
  bool agent;
};

MHS_HD Shape shape(const GenArgs& A, int num_elong, int b) {
  const V3 zero{0.0f, 0.0f, 0.0f};
  if (b < A.nb) {
    const bool elong = b < num_elong;
    return Shape{elong ? V3{4.0f, 0.75f, 1.0f} : V3{1.0f, 1.0f, 1.0f}, zero,
                 0.5f, elong ? 4.0f : 2.0f, false};
  }
  if (b < A.nb + A.nr)
    return Shape{V3{1.0f, 1.5f, 1.0f}, V3{0.0f, -0.5f, 0.0f}, 0.5f, 1.0f,
                 false};
  return Shape{V3{1.0f, 1.0f, 1.0f}, zero, 1.0f, 16.0f, true};
}

// levelgen.box_inv_inertia (PyTorch's CUDA division by a scalar
// multiplies by its reciprocal: m / 3 is m * (1 / 3)); agents keep only
// the yaw component.
MHS_HD V3 inv_inertia(const Shape& sh) {
  const V3 h = sh.half;
  const float a2 = h.x * h.x, b2 = h.y * h.y, c2 = h.z * h.z;
  const float m3 = (1.0f / fmax2(sh.inv_mass, 1e-9f)) * (1.0f / 3.0f);
  const float i0 = m3 * (b2 + c2), i1 = m3 * (a2 + c2), i2 = m3 * (a2 + b2);
  const bool pos = sh.inv_mass > 0.0f;
  V3 r{pos ? 1.0f / fmax2(i0, 1e-9f) : 0.0f,
       pos ? 1.0f / fmax2(i1, 1e-9f) : 0.0f,
       pos ? 1.0f / fmax2(i2, 1e-9f) : 0.0f};
  if (sh.agent) r = V3{r.x * 0.0f, r.y * 0.0f, r.z * 1.0f};
  return r;
}

// One candidate pose of levelgen._rejection_place: (x, y, 1) uniform in
// the arena, yaw uniform in [0, pi), and its rotated AABB.
struct Trial {
  V3 pos, lo, hi;
  float cw, sz;
};

// prng.uniform_scale to [-18, 18): one rounding of the exact u * 36 - 18.
MHS_HD float arena(float u) {
  return fmax2(static_cast<float>(static_cast<double>(u) * 36.0 + -18.0),
               -18.0f);
}

MHS_HD Trial trial(const float* u, int t, const Shape& sh) {
  Trial r;
  r.pos = V3{arena(u[2 * t]), arena(u[2 * t + 1]), 1.0f};
  const float half_yaw = 0.5f * (u[2 * N_TRIALS + t] * PI_F);
  r.cw = cosf(half_yaw);
  r.sz = sinf(half_yaw);
  const Q4 q{r.cw, 0.0f, 0.0f, r.sz};
  const V3 c = add(r.pos, quat_rotate(q, sh.off));
  // math3d.obb_world_aabb: |quat_to_mat(q)| times the half extents,
  // summed over each row. One product of each row is zero for a yaw, so
  // the sum's order does not matter.
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const V3 h = sh.half;
  const V3 wh{fabsf(1.0f - 2.0f * (yy + zz)) * h.x +
                  fabsf(2.0f * (xy - wz)) * h.y +
                  fabsf(2.0f * (xz + wy)) * h.z,
              fabsf(2.0f * (xy + wz)) * h.x +
                  fabsf(1.0f - 2.0f * (xx + zz)) * h.y +
                  fabsf(2.0f * (yz - wx)) * h.z,
              fabsf(2.0f * (xz - wy)) * h.x +
                  fabsf(2.0f * (yz + wx)) * h.y +
                  fabsf(1.0f - 2.0f * (xx + yy)) * h.z};
  r.lo = sub(c, wh);
  r.hi = add(c, wh);
  return r;
}

// math3d.aabb_overlap of a trial with placed AABB j.
MHS_HD bool overlaps(const World& s, const Trial& t, int j) {
  return t.lo.x <= s.hi[j][0] && t.lo.y <= s.hi[j][1] &&
         t.lo.z <= s.hi[j][2] && s.lo[j][0] <= t.hi.x &&
         s.lo[j][1] <= t.hi.y && s.lo[j][2] <= t.hi.z;
}

// World w's program on its warp: walls, then every slot's placement.
MHS_DEV void generate(const GenArgs& A, World& s, long long w) {
  const long long g = A.G == 1 ? 0 : w;
  const int n_ent = A.nb + A.nr + A.na;
  const int n = make_walls(s, A.wall_bits + g * (2 * N_WALL_BITS),
                           A.wall_u + g * N_WALL_U);
  // geometry.scale_walls to the arena, then each wall's AABB.
  warp_sync();
  lanes(MAX_WALLS, [&](int k) {
    s.p1[0][k] = 36.0f * s.p1[0][k] + -18.0f;
    s.p1[1][k] = 36.0f * s.p1[1][k] + -18.0f;
    s.p2[0][k] = 36.0f * s.p2[0][k] + -18.0f;
    s.p2[1][k] = 36.0f * s.p2[1][k] + -18.0f;
    V3 pos, half;
    wall_box(s, k, &pos, &half);
    const V3 lo = sub(pos, half), hi = add(pos, half);
    s.lo[k][0] = lo.x;
    s.lo[k][1] = lo.y;
    s.lo[k][2] = lo.z;
    s.hi[k][0] = hi.x;
    s.hi[k][1] = hi.y;
    s.hi[k][2] = hi.z;
  });
  warp_sync();
  uint64_t placed = n >= MAX_WALLS ? (1ull << MAX_WALLS) - 1u
                                   : (1ull << (n > 0 ? n : 0)) - 1u;

  const uint32_t* cb = A.count_bits + g * 4;
  const int total_boxes = randint(cb[0], cb[1], 3, A.nb + 1);
  int num_elong = 3 + randint(cb[2], cb[3], 0,
                              total_boxes - 3 > 1 ? total_boxes - 3 : 1);
  num_elong = num_elong < total_boxes ? num_elong : total_boxes;

  for (int b = 0; b < n_ent; ++b) {
    const Shape sh = shape(A, num_elong, b);
    const float* u = A.pose_u + (g * n_ent + b) * POSE_U;
    const uint64_t ok = warp_mask(N_TRIALS, [&](int t) {
      const Trial tr = trial(u, t, sh);
      for (uint64_t m = placed; m != 0; m &= m - 1)
        if (overlaps(s, tr, low_bit64(m))) return false;
      return true;
    });
    const Trial tr = trial(u, ok != 0 ? low_bit64(ok) : 0, sh);
    // Agents are not added to the overlap set (level_gen.cpp:285).
    const bool keep = !sh.agent && (b >= A.nb || b < total_boxes);
    const int j = MAX_WALLS + b;
    warp_sync();
    lane0([&] {
      s.pos[b][0] = tr.pos.x;
      s.pos[b][1] = tr.pos.y;
      s.pos[b][2] = tr.pos.z;
      s.qw[b] = tr.cw;
      s.qz[b] = tr.sz;
      if (keep) {
        s.lo[j][0] = tr.lo.x;
        s.lo[j][1] = tr.lo.y;
        s.lo[j][2] = tr.lo.z;
        s.hi[j][0] = tr.hi.x;
        s.hi[j][1] = tr.hi.y;
        s.hi[j][2] = tr.hi.z;
      }
    });
    warp_sync();
    if (keep) placed |= 1ull << j;
  }
  lane0([&] {
    s.n_walls = n;
    s.total_boxes = total_boxes;
    s.num_elong = num_elong;
  });
}

// Rows of leaf k in the packed layout (every axis but the world axis).
MHS_HD int leaf_rows(const GenArgs& A, int k) {
  const int nb = A.nb + A.nr + A.na, na = A.na;
  switch (k) {
    case POS: case VEL: case OMEGA: case HALF_EXT: case INV_INERTIA:
      return 3 * nb;
    case QUAT: return 4 * nb;
    case INV_MASS: case FRICTION: case ACTIVE: case LOCKED: case OWNER:
      return nb;
    case WALL_POS: case WALL_HALF: return 3 * MAX_WALLS;
    case WALL_ACTIVE: return MAX_WALLS;
    case PLANE_POINT: case PLANE_NORMAL: return 3 * MAX_PLANES;
    case PLANE_ACTIVE: return MAX_PLANES;
    case GRAB_R2: return 3 * na;
    case GRAB_REL_Q: return 4 * na;
    case GRAB_TARGET: case GRAB_SEP: case AGENT_TYPE: case AGENT_ACTIVE:
    case ACT_HIT_T: case ACT_HIT_ID:
      return na;
    case OUT_EP_KEY: case OUT_LEVEL_KEY: case RUNNING_SCORES:
    case FINISHED_SCORES:
      return 2;
    default: return 1;
  }
}

MHS_HD bool byte_leaf(int k) {
  return k == ACTIVE || k == LOCKED || k == WALL_ACTIVE ||
         k == PLANE_ACTIVE || k == AGENT_ACTIVE || k == OUT_SEEKERS_FIRST;
}

MHS_HD uint32_t word(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
  return u;
#endif
}

// The episode's tail (levelgen.generate_training_world): team sizes,
// agent activity and types.
struct Teams {
  int nh, ns;
  bool flip;
  MHS_HD bool active(int a) const { return a < nh + ns; }
  MHS_HD int type(int a) const {
    const int size0 = flip ? ns : nh;
    const int t = a < size0 ? (flip ? AGENT_SEEKER : AGENT_HIDER)
                            : (flip ? AGENT_HIDER : AGENT_SEEKER);
    return active(a) ? t : 0;
  }
};

// Element (row r, world w) of leaf k: a 32-bit word, or a byte for the
// bool leaves.
MHS_HD uint32_t element(const GenArgs& A, const World& s, int k, int r,
                        long long w) {
  const Teams tm{static_cast<int>(A.num_hiders[w]),
                 static_cast<int>(A.num_seekers[w]),
                 A.seekers_first[w] != 0};
  const int c3 = r % 3, b3 = r / 3;
  const int agent_lo = A.nb + A.nr;
  switch (k) {
    case POS: return word(s.pos[b3][c3]);
    case QUAT: {
      const int c = r % 4;
      return word(c == 0 ? s.qw[r / 4] : (c == 3 ? s.qz[r / 4] : 0.0f));
    }
    case HALF_EXT: return word(comp(shape(A, s.num_elong, b3).half, c3));
    case INV_MASS: return word(shape(A, s.num_elong, r).inv_mass);
    case INV_INERTIA:
      return word(comp(inv_inertia(shape(A, s.num_elong, b3)), c3));
    case FRICTION: return word(shape(A, s.num_elong, r).friction);
    case ACTIVE:
      return r < A.nb ? r < s.total_boxes
                      : (r < agent_lo || tm.active(r - agent_lo));
    case OWNER:
      return r >= agent_lo && tm.active(r - agent_lo) ? OWNER_UNOWNABLE : 0;
    case WALL_POS: case WALL_HALF: {
      V3 pos, half;
      wall_box(s, b3, &pos, &half);
      return word(comp(k == WALL_POS ? pos : half, c3));
    }
    case WALL_ACTIVE: return r < s.n_walls;
    case PLANE_NORMAL: return word(c3 == 2 ? 1.0f : 0.0f);
    case PLANE_ACTIVE: return r == 0;
    case GRAB_TARGET: case ACT_HIT_ID: return 0xffffffffu;
    case GRAB_REL_Q: return word(r % 4 == 0 ? 1.0f : 0.0f);
    case AGENT_TYPE: return static_cast<uint32_t>(tm.type(r));
    case AGENT_ACTIVE: return tm.active(r);
    case OUT_HIDERS: return static_cast<uint32_t>(tm.nh);
    case OUT_SEEKERS: return static_cast<uint32_t>(tm.ns);
    case OUT_BOXES: return static_cast<uint32_t>(s.total_boxes);
    case OUT_RAMPS: return static_cast<uint32_t>(A.nr);
    case OUT_EP_KEY: return A.ep_key[r * static_cast<long long>(A.W) + w];
    case OUT_LEVEL_KEY:
      return A.level_key[r * static_cast<long long>(A.W) + w];
    case OUT_SEEKERS_FIRST: return tm.flip;
    case HIDER_TEAM_REWARD: return word(1.0f);
    case ACT_HIT_T: return word(F_INF);
    default: return 0;  // zeros: velocities, planes' points, grab, counters
  }
}

// The block's worlds w0 .. w0 + nw - 1: each on its warp, then every
// leaf out of shared memory, consecutive threads on consecutive worlds.
MHS_DEV void level_block(const GenArgs& A, World* sw, long long w0, int nw) {
  block_warps(nw, [&](int wi) { generate(A, sw[wi], w0 + wi); });
  block_sync();
  for (int k = 0; k < N_LEAVES; ++k) {
    const int rows = leaf_rows(A, k);
    block_items(rows * nw, [&](int i) {
      const int r = i / nw, wi = i - r * nw;
      const long long at = r * static_cast<long long>(A.W) + w0 + wi;
      const uint32_t v = element(A, sw[wi], k, r, w0 + wi);
      if (byte_leaf(k))
        static_cast<unsigned char*>(A.out[k])[at] =
            static_cast<unsigned char>(v);
      else
        static_cast<uint32_t*>(A.out[k])[at] = v;
    });
  }
}

bool fill_args(GenArgs* a, void* const* ptrs, int n_ptrs, const int* ip,
               int n_i, int n_f) {
  if (n_ptrs != N_PTRS || n_i != N_INTS || n_f != 0) return false;
  a->wall_bits = static_cast<const uint32_t*>(ptrs[WALL_BITS]);
  a->wall_u = static_cast<const float*>(ptrs[WALL_U]);
  a->count_bits = static_cast<const uint32_t*>(ptrs[COUNT_BITS]);
  a->pose_u = static_cast<const float*>(ptrs[POSE]);
  a->ep_key = static_cast<const uint32_t*>(ptrs[EP_KEY]);
  a->level_key = static_cast<const uint32_t*>(ptrs[LEVEL_KEY]);
  a->num_hiders = static_cast<const long long*>(ptrs[NUM_HIDERS]);
  a->num_seekers = static_cast<const long long*>(ptrs[NUM_SEEKERS]);
  a->seekers_first = static_cast<const unsigned char*>(ptrs[SEEKERS_FIRST]);
  for (int k = 0; k < N_LEAVES; ++k) a->out[k] = ptrs[N_INPUTS + k];
  a->W = ip[0];
  a->G = ip[1];
  a->nb = ip[2];
  a->nr = ip[3];
  a->na = ip[4];
  return a->W >= 0 && (a->G == 1 || a->G == a->W) && a->nb >= 0 &&
         a->nb <= MAX_BOXES && a->nr >= 0 && a->nr <= MAX_RAMPS &&
         a->na > 0 && a->na <= MAX_AGENTS;
}

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entry: the same block function, blocks one after
// another.
extern "C" int mhs_levelgen_host(void* const* ptrs, int n_ptrs,
                                 const int* ip, int n_i, const float* fp,
                                 int n_f) {
  (void)fp;
  GenArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, n_f)) return 1;
  World* sw = new World[WORLDS_PER_BLOCK];
  for (long long w0 = 0; w0 < a.W; w0 += WORLDS_PER_BLOCK) {
    const long long left = a.W - w0;
    level_block(a, sw, w0,
                static_cast<int>(left < WORLDS_PER_BLOCK ? left
                                                         : WORLDS_PER_BLOCK));
  }
  delete[] sw;
  return 0;
}
#else
namespace {
__global__ void __launch_bounds__(BLOCK_THREADS)
    levelgen_kernel(const GenArgs A) {
  __shared__ World sw[WORLDS_PER_BLOCK];
  const long long w0 = static_cast<long long>(blockIdx.x) * WORLDS_PER_BLOCK;
  const long long left = A.W - w0;
  level_block(A, sw, w0,
              static_cast<int>(left < WORLDS_PER_BLOCK ? left
                                                       : WORLDS_PER_BLOCK));
}
}  // namespace

// Returns a cudaError_t code (0 on success).
extern "C" int mhs_levelgen(void* const* ptrs, int n_ptrs, const int* ip,
                            int n_i, const float* fp, int n_f, void* stream) {
  (void)fp;
  GenArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W == 0) return 0;
  const int blocks = (a.W + WORLDS_PER_BLOCK - 1) / WORLDS_PER_BLOCK;
  levelgen_kernel<<<blocks, BLOCK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape: out[0] worlds per block, out[1] shared bytes per block,
// out[2] resident blocks per SM.
extern "C" int mhs_levelgen_occupancy(int* out) {
  out[0] = WORLDS_PER_BLOCK;
  out[1] = static_cast<int>(sizeof(World) * WORLDS_PER_BLOCK);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], levelgen_kernel, BLOCK_THREADS, 0));
}
#endif
