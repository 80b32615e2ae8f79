// K6: observation assembly - the eleven leaves of
// env/observations.py::build_observations_packed in one launch.
//
// Replaces no Pallas kernel. The JAX package assembles observations in
// jnp (marl_hideandseek_tpu/env/observations.py:226), which XLA fuses into
// a few programs; op by op, the port's plain version
// (marl_hideandseek_torch/env/observations.py::build_observations_plain)
// issues ~760 PyTorch kernels from the host a call, and the card waits on
// their dispatch. This kernel computes that function with its op order:
// qconj, qrot, qmul, qnorm (rsqrtf), euler (atan2f, asinf), rel_posvel,
// each feature multiplied by its gate. Built with --fmad=false, it agrees
// with the plain version on the card to the last bit wherever the math
// library's functions do.
//
// Bound: bytes. A 2v2 world at full capacity reads ~1.7 KB (15 bodies'
// pose, velocity, size, lock and owner; the agents' grab, type and
// activity; the sweep's visibility and lidar) and writes ~5.0 KB (4
// agents x 313 words over 11 leaves) against ~25 K operations: 0.13 ms
// at 65,536 worlds on 3.35 TB/s. So the design touches each byte once,
// in whole sectors, keeps everything between in shared memory, and
// overlaps the writes with the next tile's work. A block takes tiles of
// TILE consecutive worlds, as many blocks as fit on the card, each
// looping over its tiles:
//
// (1) Load: a thread takes an input row (one body component, one
//     agent's flag, a visibility column, a lidar ray) and reads its
//     TILE worlds: in the packed [..., W] layout (world stride 1) that is
//     32 contiguous bytes, read as two 16-byte words. Each input is read
//     through the strides it is given, so views of world-major state
//     need no copy (they take the word-by-word path). Lidar and
//     visibility rows go straight to the output (a transpose: consecutive
//     rows are consecutive words there); the rest to shared memory.
// (2) Compute: a thread per (world, agent, column), the columns being the
//     agent itself, its 5 other-agent slots, the boxes and the ramps, all
//     on one instruction path; each writes its row of features into the
//     tile's staged leaves. The other-agent slots (others_index_matrix)
//     and their range mask are computed here: slot c of agent a is
//     c + (c >= a), in range below A.
// (3) Store: each staged leaf's [TILE, A, F] range is contiguous in the
//     world-first output. One thread hands each to the tensor memory
//     accelerator as a bulk copy, which drains while the block loads and
//     computes its next tile (a ragged last tile: the block's threads
//     write it, consecutive threads on consecutive 16-byte words).
//
// Entity counts arrive at run time (capacity: common.cuh), so one build
// serves 1v1, 2v2 and 3v3, and any W.
//
// Host build (-DMHS_HOST_BUILD): the block's items run one after another
// in each phase (lanes.cuh's block_items; -DMHS_LANES_REVERSE in reverse),
// and tiles one after another; stores are the threads' stores.

#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "lanes.cuh"

using namespace mhs;

namespace {

constexpr int TILE = 8;              // worlds per block: a multiple of 8
constexpr int BLOCK_THREADS = 256;
constexpr int N_LIDAR = 30;
constexpr int N_OTHERS = MAX_AGENTS - 1;
constexpr int BODY_WORDS = 13;       // pos 3, quat 4, vel 3, omega 3
constexpr int F_SELF = 13;
constexpr int F_AGENT = 14;
constexpr int F_BOX = 17;
constexpr int F_RAMP = 14;
constexpr int AGENT_HIDER = 1;
constexpr int OWNER_HIDER = 2;

// Pointer order: the inputs, then the leaves (ObsArgs).
enum Input {
  POS, QUAT, VEL, OMEGA, HALF_EXT, LOCKED, OWNER, TARGET, TYPE, ACTIVE,
  N_BOXES, N_RAMPS, STEP, VIS, LIDAR, N_INPUTS
};
enum Leaf {
  PREP, SELF, SELF_TYPE, SELF_MASK, SELF_LIDAR, AGENT, BOX, RAMP,
  VIS_AGENTS, VIS_BOXES, VIS_RAMPS, N_LEAVES
};
constexpr int N_PTRS = N_INPUTS + N_LEAVES;
constexpr int N_SCALARS = 5;         // W, boxes, ramps, agents, prep steps
constexpr int N_INTS = N_SCALARS + 3 * N_INPUTS;

struct ObsArgs {
  const void* in[N_INPUTS];
  uint32_t* out[N_LEAVES];
  // Element strides of each input: its row dimensions (0 where it has
  // fewer than two), then its world axis.
  long long stride[N_INPUTS][3];
  int W, n_boxes, n_ramps, n_agents, num_prep;
};

// Staged words hold floats and ints alike.
MHS_HD float as_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
#endif
}
MHS_HD uint32_t as_word(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof(u));
  return u;
#endif
}

// The leaves computed in shared memory; the lidar and visibility leaves
// are copies, which the load writes straight to the output.
MHS_HD bool staged(int k) { return k != SELF_LIDAR && k < VIS_AGENTS; }

// Shapes of one launch. A block's shared memory: S words a world of
// staged inputs (rows [0, r_scalar) of the load, S odd against bank
// conflicts), then each staged leaf's [TILE, A, F] block at word
// off[leaf].
struct Layout {
  int nb, nr, na, n_tgt, n_cols, agent_lo;
  int r_body, r_half, r_lock, r_agent, r_scalar, r_lidar, r_vis;
  int S, width[N_LEAVES], off[N_LEAVES], words;
  bool bulk;  // every staged leaf starts on a 16-byte boundary
};

MHS_HD Layout make_layout(int nb, int nr, int na) {
  Layout L;
  L.nb = nb;
  L.nr = nr;
  L.na = na;
  L.n_tgt = N_OTHERS + nb + nr;
  L.n_cols = 1 + N_OTHERS + nb + nr;
  L.agent_lo = nb + nr;
  L.r_body = (nb + nr + na) * BODY_WORDS;
  L.r_half = L.r_body + 3 * nb;
  L.r_lock = L.r_half + 2 * (nb + nr);
  L.r_agent = L.r_lock + 3 * na;
  L.r_scalar = L.r_agent + 3;
  L.r_lidar = L.r_scalar + na * N_LIDAR;
  L.r_vis = L.r_lidar + na * L.n_tgt;
  L.S = L.r_scalar | 1;
  const int width[N_LEAVES] = {1, F_SELF, 1, 1, N_LIDAR, N_OTHERS * F_AGENT,
                               nb * F_BOX, nr * F_RAMP, N_OTHERS, nb, nr};
  int at = TILE * L.S;
  for (int k = 0; k < N_LEAVES; ++k) {
    L.width[k] = width[k];
    L.off[k] = staged(k) ? at : -1;
    if (staged(k)) at += TILE * na * width[k];
  }
  L.words = at;
  L.bulk = false;
  return L;
}

// One row of the tile's load: element (i0, i1) of an input in each of
// the tile's worlds, and the words it goes to (staged, or output).
struct Row {
  const char* src;   // world w0's element
  long long step;    // bytes between consecutive worlds
  bool byte;         // a bool input, read as one byte
  uint32_t* dst;     // world 0's word
  int dstep;         // words between consecutive worlds' words
};

// Word j of world w0's [A, F] block of leaf k in the output.
MHS_HD uint32_t* out_row(const ObsArgs& A, const Layout& L, int k, int w0,
                         int j) {
  return A.out[k] + static_cast<long long>(w0) * L.na * L.width[k] + j;
}

MHS_HD Row row_at(const ObsArgs& A, int k, int i0, int i1, int w0,
                  uint32_t* dst, int dstep) {
  const int size = (k == LOCKED || k == ACTIVE) ? 1 : 4;
  const long long e = i0 * A.stride[k][0] + i1 * A.stride[k][1] +
                      w0 * A.stride[k][2];
  return Row{static_cast<const char*>(A.in[k]) + e * size,
             A.stride[k][2] * size, size == 1, dst, dstep};
}

// Row `row` of the tile starting at world w0: rows [0, r_scalar) go to
// each world's staged inputs (S words apart), lidar and visibility rows
// to their place in the output, where consecutive rows are consecutive
// words of a world's [A, F] block.
MHS_HD Row load_row(const ObsArgs& A, const Layout& L, int row, int w0,
                    uint32_t* sm) {
  uint32_t* dst = sm + row;
  if (row < L.r_body) {
    const int b = row / BODY_WORDS, c = row - b * BODY_WORDS;
    if (c < 3) return row_at(A, POS, b, c, w0, dst, L.S);
    if (c < 7) return row_at(A, QUAT, b, c - 3, w0, dst, L.S);
    if (c < 10) return row_at(A, VEL, b, c - 7, w0, dst, L.S);
    return row_at(A, OMEGA, b, c - 10, w0, dst, L.S);
  }
  if (row < L.r_half) {
    const int j = row - L.r_body;
    return row_at(A, HALF_EXT, j / 3, j % 3, w0, dst, L.S);
  }
  if (row < L.r_lock) {
    const int j = row - L.r_half, n = L.nb + L.nr;
    return j < n ? row_at(A, LOCKED, j, 0, w0, dst, L.S)
                 : row_at(A, OWNER, j - n, 0, w0, dst, L.S);
  }
  if (row < L.r_agent) {
    const int j = row - L.r_lock, k = j / L.na, a = j - k * L.na;
    return row_at(A, k == 0 ? TARGET : (k == 1 ? TYPE : ACTIVE), a, 0, w0,
                  dst, L.S);
  }
  if (row < L.r_scalar) {
    const int j = row - L.r_agent;
    return row_at(A, j == 0 ? N_BOXES : (j == 1 ? N_RAMPS : STEP), 0, 0, w0,
                  dst, L.S);
  }
  if (row < L.r_lidar) {
    const int j = row - L.r_scalar;
    return row_at(A, LIDAR, j / N_LIDAR, j % N_LIDAR, w0,
                  out_row(A, L, SELF_LIDAR, w0, j), L.na * N_LIDAR);
  }
  const int j = row - L.r_lidar, a = j / L.n_tgt, t = j - a * L.n_tgt;
  const int leaf = t < N_OTHERS ? VIS_AGENTS
                                : (t < N_OTHERS + L.nb ? VIS_BOXES : VIS_RAMPS);
  const int c = t - (leaf == VIS_AGENTS ? 0 : N_OTHERS) -
                (leaf == VIS_RAMPS ? L.nb : 0);
  return row_at(A, VIS, a, t, w0,
                out_row(A, L, leaf, w0, a * L.width[leaf] + c),
                L.na * L.width[leaf]);
}

MHS_HD uint32_t fetch(const char* src, bool byte) {
  if (byte) return *reinterpret_cast<const unsigned char*>(src) != 0 ? 1u : 0u;
  return *reinterpret_cast<const uint32_t*>(src);
}

// Row r's words of the tile's nw worlds. A whole tile of a packed row
// (world stride 1, aligned) is read as 16-byte words (8-byte for bools);
// any other layout word by word, every load issued before any store.
MHS_DEV void copy_row(const Row& r, int nw) {
#ifndef MHS_HOST_BUILD
  const uintptr_t at = reinterpret_cast<uintptr_t>(r.src);
  if (nw == TILE && !r.byte && r.step == 4 && (at & 15) == 0) {
    uint4 v[TILE / 4];
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q)
      v[q] = reinterpret_cast<const uint4*>(r.src)[q];
#pragma unroll
    for (int q = 0; q < TILE / 4; ++q) {
      r.dst[(4 * q) * r.dstep] = v[q].x;
      r.dst[(4 * q + 1) * r.dstep] = v[q].y;
      r.dst[(4 * q + 2) * r.dstep] = v[q].z;
      r.dst[(4 * q + 3) * r.dstep] = v[q].w;
    }
    return;
  }
  if (nw == TILE && r.byte && r.step == 1 && (at & 7) == 0) {
    uint2 v[TILE / 8];
#pragma unroll
    for (int q = 0; q < TILE / 8; ++q)
      v[q] = reinterpret_cast<const uint2*>(r.src)[q];
#pragma unroll
    for (int q = 0; q < TILE / 8; ++q)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint32_t word = b < 4 ? v[q].x : v[q].y;
        r.dst[(8 * q + b) * r.dstep] = ((word >> (8 * (b & 3))) & 0xffu) != 0;
      }
    return;
  }
#endif
  uint32_t v[TILE];
#pragma unroll
  for (int wi = 0; wi < TILE; ++wi)
    if (wi < nw) v[wi] = fetch(r.src + wi * r.step, r.byte);
#pragma unroll
  for (int wi = 0; wi < TILE; ++wi)
    if (wi < nw) r.dst[wi * r.dstep] = v[wi];
}

struct Pose {
  V3 pos;
  Q4 q;
  V3 vel, om;
};

MHS_HD Pose body(const uint32_t* in, int b) {
  const uint32_t* p = in + b * BODY_WORDS;
  Pose s;
  s.pos = V3{as_float(p[0]), as_float(p[1]), as_float(p[2])};
  s.q = Q4{as_float(p[3]), as_float(p[4]), as_float(p[5]), as_float(p[6])};
  s.vel = V3{as_float(p[7]), as_float(p[8]), as_float(p[9])};
  s.om = V3{as_float(p[10]), as_float(p[11]), as_float(p[12])};
  return s;
}

MHS_HD float flag(bool b) { return b ? 1.0f : 0.0f; }

// (2) Item (world wi, agent a, column col) of the tile. Every column
// runs the same instructions, so that a warp's lanes do not diverge over
// the columns' kinds: math3d.rel_posvel against the column's body, where
// the self column keeps its own position, its own rotation (euler of the
// agent's quaternion, not of a relative one) and rotates its own
// velocities, as the plain self features do; then the kind's extra
// features and its gate.
MHS_HD void compute_item(const ObsArgs& A, const Layout& L, int wi, int a,
                         int col, uint32_t* sm) {
  const uint32_t* in = sm + wi * L.S;
  const uint32_t* lk = in + L.r_half;
  const uint32_t* owner = lk + L.nb + L.nr;
  const uint32_t* target = in + L.r_lock;
  const uint32_t* type = target + L.na;
  const uint32_t* active = type + L.na;
  const int wa = wi * L.na + a;
  const float act = flag(active[a] != 0);
  // The column's kind, body slot and index among its kind.
  const bool self = col == 0;
  const int c = col - 1;
  const bool agent = !self && c < N_OTHERS;
  const int j = c + (c >= a ? 1 : 0);                 // others_index_matrix
  const int o = j < L.na ? j : L.na - 1;
  const int e = c - N_OTHERS;                          // box, then ramp slot
  const int slot = self ? L.agent_lo + a : (agent ? L.agent_lo + o : e);
  const Pose me = body(in, L.agent_lo + a);
  const Pose en = body(in, slot);
  const Q4 inv = qconj(me.q);
  const V3 x_rel = qrot_c(inv, sub(en.pos, me.pos), false);
  const Q4 q_rel = qnorm(quat_mul(inv, en.q));
  const V3 x = self ? me.pos : x_rel;
  const V3 eul = euler(self ? me.q : q_rel);
  const V3 lin = qrot_c(inv, self ? me.vel : sub(en.vel, me.vel), false);
  const V3 ang = qrot_c(inv, self ? me.om : sub(en.om, me.om), false);
  float f[F_BOX] = {x.x, x.y, x.z, eul.x, eul.y, eul.z,
                    lin.x, lin.y, lin.z, ang.x, ang.y, ang.z};
  uint32_t* dst;
  int n;
  float gate;
  if (self) {
    f[12] = flag(static_cast<int>(target[a]) >= 0);
    n = F_SELF;
    gate = act;
    dst = sm + L.off[SELF] + wa * F_SELF;
    const int prep = A.num_prep - static_cast<int>(in[L.r_agent + 2]);
    sm[L.off[PREP] + wa] = static_cast<uint32_t>(prep < 0 ? 0 : prep);
    sm[L.off[SELF_TYPE] + wa] = type[a];
    sm[L.off[SELF_MASK] + wa] = as_word(act);
  } else if (agent) {
    f[12] = flag(static_cast<int>(type[o]) == AGENT_HIDER);
    f[13] = flag(static_cast<int>(target[o]) >= 0);
    n = F_AGENT;
    gate = flag(active[o] != 0 && j < L.na) * act;
    dst = sm + L.off[AGENT] + wa * (N_OTHERS * F_AGENT) + c * F_AGENT;
  } else {
    const float locked = flag(lk[e] != 0);
    const int own = static_cast<int>(owner[e]);
    const float hider_lock = locked * flag(own == OWNER_HIDER);
    const float other_lock = locked * flag(own != OWNER_HIDER);
    if (e < L.nb) {
      const uint32_t* h = in + L.r_body + 3 * e;
      f[12] = 2.0f * as_float(h[0]);
      f[13] = 2.0f * as_float(h[1]);
      f[14] = 2.0f * as_float(h[2]);
      f[15] = hider_lock;
      f[16] = other_lock;
      n = F_BOX;
      gate = flag(e < static_cast<int>(in[L.r_agent])) * act;
      dst = sm + L.off[BOX] + wa * (L.nb * F_BOX) + e * F_BOX;
    } else {
      const int r = e - L.nb;
      f[12] = hider_lock;
      f[13] = other_lock;
      n = F_RAMP;
      gate = flag(r < static_cast<int>(in[L.r_agent + 1])) * act;
      dst = sm + L.off[RAMP] + wa * (L.nr * F_RAMP) + r * F_RAMP;
    }
  }
#pragma unroll
  for (int k = 0; k < F_BOX; ++k)
    if (k < n) dst[k] = as_word(f[k] * gate);
}

// (3) Leaf k's staged [nw, A, F] block to its contiguous range of the
// output, by the block's threads; 16-byte words where both sides are
// aligned to them.
MHS_DEV void store_leaf(const ObsArgs& A, const Layout& L, int k, int w0,
                        int nw, const uint32_t* sm) {
  const int n = nw * L.na * L.width[k];
  uint32_t* dst = out_row(A, L, k, w0, 0);
  const uint32_t* src = sm + L.off[k];
  int head = 0;
#ifndef MHS_HOST_BUILD
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    head = n & ~3;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    block_items(head >> 2, [&](int i) { d4[i] = s4[i]; });
  }
#endif
  block_items(n - head, [&](int i) { dst[head + i] = src[head + i]; });
}

#ifndef MHS_HOST_BUILD
// The tensor memory accelerator's bulk copies from shared to global
// memory (sm_90): one thread hands the copy over and the block goes on.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The committed copies have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// This thread's shared-memory writes, visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
#endif

// One tile: (1) load, (2) compute, (3) store. On the card the staged
// leaves of a whole tile leave as bulk copies, which drain while the
// block loads and computes its next tile; their shared memory is written
// again only after they have read it.
MHS_DEV void obs_tile(const ObsArgs& A, const Layout& L, int w0, int nw,
                      uint32_t* sm) {
  block_items(L.r_vis, [&](int row) {
    copy_row(load_row(A, L, row, w0, sm), nw);
  });
#ifndef MHS_HOST_BUILD
  if (threadIdx.x == 0) bulk_wait_read();
#endif
  block_sync();
  const int per_world = L.na * L.n_cols;
  block_items(nw * per_world, [&](int i) {
    const int wi = i / per_world, r = i - wi * per_world;
    const int a = r / L.n_cols;
    compute_item(A, L, wi, a, r - a * L.n_cols, sm);
  });
#ifndef MHS_HOST_BUILD
  fence_async_shared();
  block_sync();
  if (L.bulk && nw == TILE) {
    // 16-byte aligned and a multiple of 16 bytes: w0 is a multiple of 8.
    if (threadIdx.x == 0) {
      for (int k = 0; k < N_LEAVES; ++k)
        if (staged(k) && L.width[k] > 0)
          bulk_store(out_row(A, L, k, w0, 0), sm + L.off[k],
                     sizeof(uint32_t) * TILE * L.na * L.width[k]);
      bulk_commit();
    }
    return;
  }
#endif
  block_sync();
  for (int k = 0; k < N_LEAVES; ++k)
    if (staged(k)) store_leaf(A, L, k, w0, nw, sm);
}

bool fill_args(ObsArgs* a, void* const* ptrs, int n_ptrs, const int* ip,
               int n_i, int n_f) {
  if (n_ptrs != N_PTRS || n_i != N_INTS || n_f != 0) return false;
  for (int k = 0; k < N_INPUTS; ++k) a->in[k] = ptrs[k];
  for (int k = 0; k < N_LEAVES; ++k)
    a->out[k] = static_cast<uint32_t*>(ptrs[N_INPUTS + k]);
  a->W = ip[0];
  a->n_boxes = ip[1];
  a->n_ramps = ip[2];
  a->n_agents = ip[3];
  a->num_prep = ip[4];
  for (int k = 0; k < N_INPUTS; ++k)
    for (int d = 0; d < 3; ++d) a->stride[k][d] = ip[N_SCALARS + 3 * k + d];
  return a->W >= 0 && a->n_boxes >= 0 && a->n_boxes <= MAX_BOXES &&
         a->n_ramps >= 0 && a->n_ramps <= MAX_RAMPS && a->n_agents > 0 &&
         a->n_agents <= MAX_AGENTS;
}

}  // namespace

#ifdef MHS_HOST_BUILD
// Host rehearsal entry: the same tile function, tiles one after another.
extern "C" int mhs_observations_host(void* const* ptrs, int n_ptrs,
                                     const int* ip, int n_i, const float* fp,
                                     int n_f) {
  (void)fp;
  ObsArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, n_f)) return 1;
  const Layout L = make_layout(a.n_boxes, a.n_ramps, a.n_agents);
  uint32_t* sm = new uint32_t[L.words];
  for (int w0 = 0; w0 < a.W; w0 += TILE) {
    const int left = a.W - w0;
    obs_tile(a, L, w0, left < TILE ? left : TILE, sm);
  }
  delete[] sm;
  return 0;
}
#else
namespace {
size_t smem_bytes(const Layout& L) { return sizeof(uint32_t) * L.words; }

// Each block takes tiles blockIdx.x, + gridDim.x, ...; before it exits,
// its last bulk copies have read their shared memory.
__global__ void __launch_bounds__(BLOCK_THREADS)
    observations_kernel(const ObsArgs A, const Layout L) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tiles = (A.W + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w0 = t * TILE, left = A.W - w0;
    obs_tile(A, L, w0, left < TILE ? left : TILE, smem);
  }
  if (threadIdx.x == 0) bulk_wait_read();
}

// The launch's shared bytes and the blocks resident on the whole card,
// set up and counted once per device and shared size.
cudaError_t launch_shape(const Layout& L, size_t* smem, int* resident) {
  struct Shape {
    size_t smem;
    int resident;
  };
  static Shape known[64];
  *smem = smem_bytes(L);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Shape* k = dev < 64 ? &known[dev] : nullptr;
  if (k && k->smem == *smem && k->resident > 0) {
    *resident = k->resident;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(observations_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, observations_kernel, BLOCK_THREADS, *smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *resident = per_sm * sms;
  if (err == cudaSuccess && k) *k = Shape{*smem, *resident};
  return err;
}
}  // namespace

// Returns a cudaError_t code (0 on success). As many blocks as fit on the
// card at once, each looping over its tiles.
extern "C" int mhs_observations(void* const* ptrs, int n_ptrs, const int* ip,
                                int n_i, const float* fp, int n_f,
                                void* stream) {
  (void)fp;
  ObsArgs a;
  if (!fill_args(&a, ptrs, n_ptrs, ip, n_i, n_f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.W == 0) return 0;
  Layout L = make_layout(a.n_boxes, a.n_ramps, a.n_agents);
  L.bulk = true;
  for (int k = 0; k < N_LEAVES; ++k)
    if (staged(k) && (reinterpret_cast<uintptr_t>(a.out[k]) & 15) != 0)
      L.bulk = false;
  size_t smem = 0;
  int resident = 0;
  const cudaError_t err = launch_shape(L, &smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (a.W + TILE - 1) / TILE;
  observations_kernel<<<tiles < resident ? tiles : resident, BLOCK_THREADS,
                        smem, static_cast<cudaStream_t>(stream)>>>(a, L);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape of a configuration: out[0] worlds per tile, out[1] shared
// bytes per block, out[2] resident blocks per SM.
extern "C" int mhs_observations_occupancy(int n_boxes, int n_ramps,
                                          int n_agents, int* out) {
  size_t smem = 0;
  int resident = 0, sms = 0, dev = 0;
  cudaError_t err =
      launch_shape(make_layout(n_boxes, n_ramps, n_agents), &smem, &resident);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = TILE;
  out[1] = static_cast<int>(smem);
  out[2] = sms > 0 ? resident / sms : 0;
  return static_cast<int>(err);
}
#endif
