"""Procedural wall/door grammar, batched over worlds.

Port of ``marl_hideandseek_tpu/env/geometry.py`` (reference:
src/geo_gen.cpp:429-505): start from the unit-square border walls, apply
a random sequence of "connect two parallel walls and cut a door into the
connector" and "cut a door into a long wall" operations, then scale to
the [-18, 18]^2 arena. Every world of the batch runs the same bounded
sequence of steps at once: per-world indices become gathers, per-world
writes become masked selects, and an operation a world does not take is
masked out. Draws follow the JAX version's key tree (``prng.py``): every
world's draws come from its own key, drawn up front in a few batched
launches (``draw_walls``), so a world's walls equal JAX's for its key.

A wall set is ``(p1 [W, MAX_WALLS, 2], p2 [W, MAX_WALLS, 2], n [W])`` in
the normalized unit square, with p1 <= p2 componentwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch.config import MAX_WALLS
from marl_hideandseek_torch.ops import threefry as tf
from marl_hideandseek_torch.utils import tracing

DOOR_SIZE_CONNECT = 0.1
DOOR_SIZE_ADD = 0.2
MAX_ADD_DOORS = 7
MAX_CONNECT = 6
MAX_TOTAL_OPS = 12
CONNECT_ATTEMPTS = 5
_EPS_H = 1e-6
WALL_HALF_THICKNESS = 0.2
WALL_HEIGHT = 2.5


class WallSet(NamedTuple):
    p1: torch.Tensor  # [W, MAX_WALLS, 2] f32
    p2: torch.Tensor  # [W, MAX_WALLS, 2] f32
    n: torch.Tensor   # [W] i64 live walls


# Draws of one world's wall grammar: randint word pairs and uniforms.
N_WALL_BITS = 2 + MAX_TOTAL_OPS * (2 + 3 * CONNECT_ATTEMPTS)
N_WALL_U = MAX_TOTAL_OPS * (1 + 2 * CONNECT_ATTEMPTS)


class WallDraws(NamedTuple):
    """Every draw of ``make_walls`` for W worlds. A randint is kept as
    its two 32-bit draws (``prng.randint_bits``), mapped to its range
    when the state gives the bound.

    ``bits [W, N_WALL_BITS, 2]`` u32, each randint's (high, low) words:
    the connect and door counts (2), each op's choice (OPS), each op's
    connect attempts' orientation, wall and partner (OPS x 5 x 3), each
    op's door wall (OPS). ``u [W, N_WALL_U]`` f32: each op's connect
    attempts' connector ratio and door (OPS x 5 x 2), then each op's door
    position (OPS). K7 (``ops/levelgen.py``) reads them as they are;
    ``words`` cuts them for the plain grammar."""

    bits: torch.Tensor
    u: torch.Tensor

    def words(self):
        """The randints' int64 words, cut: (counts ([W, 2], ..), sel
        ([W, OPS], ..), conn ([W, OPS, 5, 3], ..), add ([W, OPS], ..)),
        each a (high, low) pair."""
        w = self.bits.shape[0]
        n_c = MAX_TOTAL_OPS * CONNECT_ATTEMPTS * 3
        hi, lo = (tf.words(self.bits[..., j]) for j in (0, 1))

        def cut(x):
            return (x[:, :2], x[:, 2:2 + MAX_TOTAL_OPS],
                    x[:, 2 + MAX_TOTAL_OPS:2 + MAX_TOTAL_OPS + n_c].reshape(
                        w, MAX_TOTAL_OPS, CONNECT_ATTEMPTS, 3),
                    x[:, 2 + MAX_TOTAL_OPS + n_c:])

        return tuple(zip(cut(hi), cut(lo)))

    @property
    def conn_u(self) -> torch.Tensor:
        """[W, OPS, 5, 2]: the connect attempts' uniforms."""
        n_u = MAX_TOTAL_OPS * CONNECT_ATTEMPTS * 2
        return self.u[:, :n_u].reshape(self.u.shape[0], MAX_TOTAL_OPS,
                                       CONNECT_ATTEMPTS, 2)

    @property
    def add_u(self) -> torch.Tensor:
        """[W, OPS]: the door ops' uniforms."""
        return self.u[:, MAX_TOTAL_OPS * CONNECT_ATTEMPTS * 2:]


def draw_walls(keys: torch.Tensor) -> WallDraws:
    """The draws of JAX's ``make_walls(key)`` for keys ``[W, 2]``
    (geometry.py:312-349): counts from ``split(split(key)[0])``, then per
    op key (``split(split(key)[1], MAX_TOTAL_OPS)``) the choice and the
    op key, whose connect attempts split 5 then 4 ways and whose door
    splits 2 ways."""
    w = keys.shape[0]
    k_counts, k_ops = prng.split(keys).unbind(1)
    k_cd = prng.split(k_counts)                            # [W, 2, 2]
    k_sel, k_op = prng.split(prng.split(k_ops, MAX_TOTAL_OPS)).unbind(2)
    att = prng.split(prng.split(k_op, CONNECT_ATTEMPTS), 4)  # [W,O,5,4,2]
    k_wall, k_door = prng.split(k_op).unbind(2)            # [W, O, 2]
    # One launch pair for every randint, one launch for every uniform.
    cat = lambda ks: prng.u32(torch.cat(
        [prng.i32(k).reshape(w, -1, 2) for k in ks], 1))
    rk = cat([k_cd, k_sel, att[..., :3, :], k_wall])
    bits = prng.bits(prng.split(rk))                       # [W, 206, 2]
    uk = cat([prng.split(att[..., 3, :]), k_door])
    return WallDraws(bits=bits, u=prng.uniform(uk))


def _where_ws(pred, a: WallSet, b: WallSet) -> WallSet:
    p = pred[:, None, None]
    return WallSet(torch.where(p, a.p1, b.p1), torch.where(p, a.p2, b.p2),
                   torch.where(pred, a.n, b.n))


def _swap_xy(ws: WallSet) -> WallSet:
    return WallSet(ws.p1.flip(-1), ws.p2.flip(-1), ws.n)


def wall_is_horizontal(ws: WallSet) -> torch.Tensor:
    return torch.abs(ws.p1[..., 1] - ws.p2[..., 1]) < _EPS_H


def wall_length(ws: WallSet) -> torch.Tensor:
    return torch.where(wall_is_horizontal(ws),
                       ws.p2[..., 0] - ws.p1[..., 0],
                       ws.p2[..., 1] - ws.p1[..., 1])


def wall_active(ws: WallSet) -> torch.Tensor:
    return torch.arange(MAX_WALLS, device=ws.n.device) < ws.n[:, None]


def _row(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[w, idx[w]] for arr [W, K, 2]."""
    return arr[torch.arange(arr.shape[0], device=arr.device), idx]


def _sort_endpoints(p1, p2):
    swap = ((p1[:, 0] > p2[:, 0]) | (p1[:, 1] > p2[:, 1]))[:, None]
    return torch.where(swap, p2, p1), torch.where(swap, p1, p2)


def _write(arr, idx, val, do):
    oh = (torch.arange(MAX_WALLS, device=arr.device) == idx[:, None]) & \
        do[:, None]
    return torch.where(oh[..., None], val[:, None, :], arr)


def _set_wall(ws: WallSet, idx, p1, p2, do) -> WallSet:
    p1, p2 = _sort_endpoints(p1, p2)
    return WallSet(_write(ws.p1, idx, p1, do), _write(ws.p2, idx, p2, do),
                   ws.n)


def _append_wall(ws: WallSet, p1, p2, do) -> WallSet:
    p1, p2 = _sort_endpoints(p1, p2)
    idx = torch.clamp(ws.n, 0, MAX_WALLS - 1)
    return WallSet(_write(ws.p1, idx, p1, do), _write(ws.p2, idx, p2, do),
                   ws.n + do.long())


def _pick_nth_true(mask: torch.Tensor, nth: torch.Tensor) -> torch.Tensor:
    """Index of the nth (0-based) set element per row; 0 if none."""
    cs = torch.cumsum(mask.long(), dim=-1)
    hit = (cs == (nth + 1)[:, None]).to(torch.int8)
    return torch.argmax(hit, dim=-1)


def _xy(x, y):
    return torch.stack([x, y], dim=-1)


def add_door(ws: WallSet, idx, door_size: float, u, do) -> WallSet:
    """Cut a door into wall ``idx`` (reference: geo_gen.cpp:275-307): the
    wall ends at the door and a new wall runs from the door to the old
    end; the door centre, ``u [W]`` uniform, lies in the middle 40% of
    the span."""
    p1 = _row(ws.p1, idx)
    p2 = _row(ws.p2, idx)
    is_x = torch.abs(p1[:, 1] - p2[:, 1]) < _EPS_H
    rat = 0.3 + 0.4 * u
    lo = torch.where(is_x, p1[:, 0], p1[:, 1]) + door_size
    hi = torch.where(is_x, p2[:, 0], p2[:, 1]) - door_size
    c = lo + rat * (hi - lo)
    old_end = torch.where(is_x, p2[:, 0], p2[:, 1])

    def set_ax(v, val):
        return _xy(torch.where(is_x, val, v[:, 0]),
                   torch.where(is_x, v[:, 1], val))

    shrunk_p2 = set_ax(p2, c - 0.5 * door_size)
    new_p1 = set_ax(p1, c + 0.5 * door_size)
    new_p2 = set_ax(p1, old_end)
    ws = _set_wall(ws, idx, p1, shrunk_p2, do)
    return _append_wall(ws, new_p1, new_p2, do)


def _find_another_wall(ws: WallSet, list_mask, chosen, min_len, start_bits):
    """First valid partner of horizontal wall ``chosen`` in rotated list
    order from a random start (reference: geo_gen.cpp:177-270; the start
    a randint of ``start_bits``). Returns (slot, found)."""
    dev = list_mask.device
    k = torch.arange(MAX_WALLS, device=dev)
    cand = list_mask & (k != chosen[:, None])
    cp1 = _row(ws.p1, chosen)
    cp2 = _row(ws.p2, chosen)
    cy = cp1[:, 1:2]
    c_len = (cp2[:, 0] - cp1[:, 0])[:, None]
    jy = ws.p1[..., 1]
    j_len = ws.p2[..., 0] - ws.p1[..., 0]
    overlap = ~((cp1[:, 0:1] >= ws.p2[..., 0]) | (cp2[:, 0:1] <= ws.p1[..., 0]))
    len_ok = (c_len >= min_len[:, None]) & (j_len >= min_len[:, None])

    high = torch.minimum(cp2[:, 0:1], ws.p2[..., 0])         # [W, K]
    low = torch.maximum(cp1[:, 0:1], ws.p1[..., 0])
    bp1x = ws.p1[:, None, :, 0]
    bp2x = ws.p2[:, None, :, 0]
    by = ws.p1[:, None, :, 1]
    ib_lo = torch.maximum(bp1x, low[..., None] - 0.1)
    ib_hi = torch.minimum(bp2x, high[..., None] + 0.1)
    y_min = torch.minimum(cy, jy)[..., None]
    y_max = torch.maximum(cy, jy)[..., None]
    blocker = (list_mask[:, None, :] & (k[None, :] != k[:, None]) &
               (ib_lo < ib_hi) & (by > y_min) & (by < y_max))
    blocked = blocker.any(dim=-1)
    valid = cand & overlap & len_ok & ~blocked

    list_len = list_mask.long().sum(-1)
    pos = torch.cumsum(list_mask.long(), dim=-1) - 1
    span = torch.clamp(list_len, min=1)
    start = prng.randint_from_bits(*start_bits, 0, span)
    rank = torch.where(valid, (pos - start[:, None]) % span[:, None],
                       MAX_WALLS + 1)
    return torch.argmin(rank, dim=-1), valid.any(dim=-1)


def _connect_walls_canonical(ws: WallSet, idx_a, idx_b, u, do) -> WallSet:
    """Join two horizontal walls with a vertical connector, split both at
    the connector, and cut a door into it (geo_gen.cpp:340-375); ``u [W,
    2]`` uniform: the connector's place, the door's."""
    ya = _row(ws.p1, idx_a)[:, 1]
    yb = _row(ws.p1, idx_b)[:, 1]
    first = torch.where(ya <= yb, idx_a, idx_b)
    second = torch.where(ya <= yb, idx_b, idx_a)
    f_p1, f_p2 = _row(ws.p1, first), _row(ws.p2, first)
    s_p1, s_p2 = _row(ws.p1, second), _row(ws.p2, second)
    high = torch.minimum(f_p2[:, 0], s_p2[:, 0])
    low = torch.maximum(f_p1[:, 0], s_p1[:, 0])
    rat = 0.4 + 0.2 * u[:, 0]
    x = low + rat * (high - low)

    connector_idx = ws.n
    ws = _append_wall(ws, _xy(x, f_p1[:, 1]), _xy(x, s_p1[:, 1]), do)
    ws = _set_wall(ws, first, f_p1, _xy(x, f_p2[:, 1]), do)
    ws = _set_wall(ws, second, s_p1, _xy(x, s_p2[:, 1]), do)
    ws = _append_wall(ws, _xy(x, f_p1[:, 1]), _xy(f_p2[:, 0], f_p1[:, 1]), do)
    ws = _append_wall(ws, _xy(x, s_p1[:, 1]), _xy(s_p2[:, 0], s_p1[:, 1]), do)
    return add_door(ws, connector_idx, DOOR_SIZE_CONNECT, u[:, 1], do)


def op_connect_and_add_door(ws: WallSet, bits, u, do) -> WallSet:
    """WallConnectAndAddDoor with up to 5 attempts (geo_gen.cpp:311-409).
    The vertical case runs on xy-swapped geometry. ``bits`` ([W, 5, 3]
    each): the attempts' orientation, wall and partner randints; ``u
    [W, 5, 2]`` their connector and door uniforms."""
    done = torch.zeros_like(do)
    hi, lo = bits
    for t in range(CONNECT_ATTEMPTS):
        horiz = prng.randint_from_bits(hi[:, t, 0], lo[:, t, 0], 0, 2) == 1
        act = wall_active(ws)
        h_mask = act & wall_is_horizontal(ws)
        sw = _swap_xy(ws)
        ws_c = _where_ws(horiz, ws, sw)
        list_mask = torch.where(horiz[:, None], h_mask,
                                act & wall_is_horizontal(sw))
        min_len = torch.where(horiz, 0.3, 0.5)
        list_len = list_mask.long().sum(-1)
        nth = prng.randint_from_bits(hi[:, t, 1], lo[:, t, 1], 0,
                                     torch.clamp(list_len, min=1))
        chosen = _pick_nth_true(list_mask, nth)
        other, found = _find_another_wall(ws_c, list_mask, chosen, min_len,
                                          (hi[:, t, 2], lo[:, t, 2]))
        do_here = do & ~done & found & (list_len > 0)
        ws_c = _connect_walls_canonical(ws_c, chosen, other, u[:, t],
                                        do_here)
        ws = _where_ws(horiz, ws_c, _swap_xy(ws_c))
        done = done | found
    return ws


def op_add_door(ws: WallSet, bits, u, do) -> WallSet:
    """WallAddDoor (geo_gen.cpp:411-421): a door into a random wall (a
    randint of ``bits``) longer than three door widths, at ``u``."""
    idx = prng.randint_from_bits(*bits, 0, torch.clamp(ws.n, min=1))
    length = wall_length(ws)[torch.arange(idx.shape[0], device=idx.device),
                             idx]
    do = do & (length > 3.0 * DOOR_SIZE_ADD)
    return add_door(ws, idx, DOOR_SIZE_ADD, u, do)


def make_walls(keys: torch.Tensor) -> WallSet:
    """The full grammar for the worlds of keys ``[n, 2]``
    (geo_gen.cpp:429-465)."""
    return build_walls(draw_walls(keys))


def build_walls(d: WallDraws) -> WallSet:
    """The grammar from its draws: border walls, op counts (1-6
    connects, 4-6 doors), then ops chosen uniformly among the types with
    budget left until both budgets are spent."""
    n, device = d.bits.shape[0], d.bits.device
    counts_w, sel, conn, add = d.words()
    conn_u, add_u = d.conn_u, d.add_u
    z = torch.zeros((n, MAX_WALLS, 2), device=device)
    ws = WallSet(z, z.clone(), torch.zeros(n, dtype=torch.long,
                                           device=device))
    t = torch.ones(n, dtype=torch.bool, device=device)

    def pt(x, y):
        with tracing.span("host_read.levelgen_consts"):
            return torch.tensor([x, y], device=device).expand(n, 2)

    ws = _append_wall(ws, pt(0.0, 0.0), pt(1.0, 0.0), t)
    ws = _append_wall(ws, pt(0.0, 0.0), pt(0.0, 1.0), t)
    ws = _append_wall(ws, pt(0.0, 1.0), pt(1.0, 1.0), t)
    ws = _append_wall(ws, pt(1.0, 1.0), pt(1.0, 0.0), t)

    hi, lo = counts_w
    counts = torch.stack(
        [1 + prng.randint_from_bits(hi[:, 0], lo[:, 0], 0, MAX_CONNECT),
         4 + prng.randint_from_bits(hi[:, 1], lo[:, 1], 0,
                                    MAX_ADD_DOORS - 4)], -1)
    for i in range(MAX_TOTAL_OPS):
        avail = counts > 0
        n_avail = avail.long().sum(-1)
        r = prng.randint_from_bits(sel[0][:, i], sel[1][:, i], 0,
                                   torch.clamp(n_avail, min=1))
        op = _pick_nth_true(avail, r)
        do = n_avail > 0
        counts = counts - (torch.nn.functional.one_hot(op, 2) *
                           do[:, None].long())
        is_connect = op == 0
        ws = op_connect_and_add_door(
            ws, (conn[0][:, i], conn[1][:, i]), conn_u[:, i],
            do & is_connect)
        ws = op_add_door(ws, (add[0][:, i], add[1][:, i]), add_u[:, i],
                         do & ~is_connect)
    return ws


def scale_walls(ws: WallSet, lo: float, hi: float) -> WallSet:
    rng = hi - lo
    return WallSet(lo + rng * ws.p1, lo + rng * ws.p2, ws.n)


def walls_to_obbs(ws: WallSet):
    """Wall segments -> static boxes (pos [W, K, 3], half [W, K, 3],
    active [W, K]); degenerate walls from short door cuts are kept."""
    horiz = wall_is_horizontal(ws)
    center = 0.5 * (ws.p1 + ws.p2)
    half_x = torch.where(horiz, ws.p2[..., 0] - center[..., 0],
                         WALL_HALF_THICKNESS)
    half_y = torch.where(horiz, WALL_HALF_THICKNESS,
                         ws.p2[..., 1] - center[..., 1])
    zc = torch.full_like(half_x, 0.5 * WALL_HEIGHT)
    pos = torch.stack([center[..., 0], center[..., 1], zc], dim=-1)
    half = torch.stack([half_x, half_y, zc], dim=-1)
    return pos, half, wall_active(ws)
