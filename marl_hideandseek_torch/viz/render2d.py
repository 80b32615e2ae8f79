"""Top-down 2-D world renderer.

Port of ``marl_hideandseek_tpu/viz/render2d.py``: walls, boxes, ramps and
agents of one world of a classic (world-major) ``EnvState``.
``world_shapes`` lists what to draw - the same shapes, colours, alphas,
agent heading lines and axis limits as JAX's - reading each leaf it needs
to the host once. Two back ends draw that list:

* ``render_world`` onto a matplotlib Axes, patch for patch as JAX's
  ``render_world`` draws (matplotlib is imported only there);
* ``rasterize_world`` into an RGB array in numpy, written as PNG by
  ``write_png`` (zlib): the frames of ``replay`` and ``viewer``, which
  need no matplotlib, so they run where it is not installed. Frames carry
  no text; their file names number them.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np

from marl_hideandseek_torch.config import ARENA_HALF, EnvConfig
from marl_hideandseek_torch.types import AGENT_HIDER, body_slot_ranges

LIMIT = ARENA_HALF + 2          # the axes span [-LIMIT, LIMIT] both ways
FRAME_PX = 560                  # JAX's 7 x 7 in figure at 80 dpi
HEADING_LW = 1.5                # points, as JAX draws the heading lines


def _host(x, world_idx: int) -> np.ndarray:
    return x[world_idx].detach().cpu().numpy()


def _yaw(q) -> float:
    return np.arctan2(2 * (q[0] * q[3] + q[1] * q[2]),
                      1 - 2 * (q[2] ** 2 + q[3] ** 2))


def _obb_corners(p, q, h) -> np.ndarray:
    c, s = np.cos(_yaw(q)), np.sin(_yaw(q))
    rot = np.array([[c, -s], [s, c]])
    corners = np.array([[-h[0], -h[1]], [h[0], -h[1]],
                        [h[0], h[1]], [-h[0], h[1]]])
    return corners @ rot.T + p[:2]


def world_shapes(cfg: EnvConfig, state, world_idx: int = 0) -> List[dict]:
    """What JAX's ``render_world`` draws for world ``world_idx``, in its
    order: ``{"kind": "rect", "xy", "w", "h", "color"}`` for walls,
    ``{"kind": "polygon", "xy" [4, 2], "color", "alpha"}`` for boxes and
    ramps, ``{"kind": "circle", "center", "radius", "color"}`` and
    ``{"kind": "line", "x", "y", "color", "lw"}`` for agents."""
    st, b = state.statics, state.bodies
    out = []
    for p, h, a in zip(_host(st.wall_pos, world_idx),
                       _host(st.wall_half_ext, world_idx),
                       _host(st.wall_active, world_idx)):
        if a:
            out.append({"kind": "rect", "xy": (p[0] - h[0], p[1] - h[1]),
                        "w": 2 * h[0], "h": 2 * h[1], "color": "#444444"})

    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, agent_hi) = \
        body_slot_ranges(cfg)
    pos, quat = _host(b.pos, world_idx), _host(b.quat, world_idx)
    half = _host(b.half_ext, world_idx)
    active, locked = _host(b.active, world_idx), _host(b.locked, world_idx)
    for i in range(box_lo, box_hi):
        if active[i]:
            out.append({"kind": "polygon",
                        "xy": _obb_corners(pos[i], quat[i], half[i]),
                        "color": "#c0392b" if locked[i] else "#e67e22",
                        "alpha": 0.8})
    for i in range(ramp_lo, ramp_hi):
        if active[i]:
            out.append({"kind": "polygon",
                        "xy": _obb_corners(pos[i], quat[i], [1.0, 1.5, 1.0]),
                        "color": "#7f8c8d" if locked[i] else "#9b59b6",
                        "alpha": 0.8})

    agent_types = _host(state.agent_type, world_idx)
    agent_act = _host(state.agent_active, world_idx)
    for i in range(agent_hi - agent_lo):
        if not agent_act[i]:
            continue
        p, q = pos[agent_lo + i], quat[agent_lo + i]
        out.append({"kind": "circle", "center": p[:2], "radius": 0.9,
                    "color": ("#27ae60" if agent_types[i] == AGENT_HIDER
                              else "#2980b9")})
        yaw = _yaw(q)
        fwd = np.array([-np.sin(yaw), np.cos(yaw)])  # body +y
        out.append({"kind": "line", "x": [p[0], p[0] + 1.6 * fwd[0]],
                    "y": [p[1], p[1] + 1.6 * fwd[1]], "color": "black",
                    "lw": HEADING_LW})
    return out


def render_world(cfg: EnvConfig, state, world_idx: int = 0, ax=None,
                 title=None):
    """Draw world ``world_idx`` of world-major ``state`` onto a matplotlib
    Axes (a new 7 x 7 in figure's when ``ax`` is None); returns the Axes."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle, Polygon, Rectangle

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 7))
    for sh in world_shapes(cfg, state, world_idx):
        if sh["kind"] == "rect":
            ax.add_patch(Rectangle(sh["xy"], sh["w"], sh["h"],
                                   color=sh["color"]))
        elif sh["kind"] == "polygon":
            ax.add_patch(Polygon(sh["xy"], closed=True, color=sh["color"],
                                 alpha=sh["alpha"]))
        elif sh["kind"] == "circle":
            ax.add_patch(Circle(sh["center"], sh["radius"],
                                color=sh["color"]))
        else:
            ax.plot(sh["x"], sh["y"], color=sh["color"], lw=sh["lw"])
    ax.set_xlim(-LIMIT, LIMIT)
    ax.set_ylim(-LIMIT, LIMIT)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    return ax


def _rgb(color: str) -> np.ndarray:
    if color == "black":
        return np.zeros(3)
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], float)


def rasterize_world(cfg: EnvConfig, state, world_idx: int = 0,
                    size: int = FRAME_PX) -> np.ndarray:
    """``world_shapes`` painted in order onto a white ``[size, size, 3]``
    u8 image of the square [-LIMIT, LIMIT]^2 (row 0 at the top), each
    pixel coloured by the shapes that hold its centre, blended with their
    alpha; heading lines ``lw`` points wide at 80 dpi."""
    px = 2 * LIMIT / size
    c = -LIMIT + (np.arange(size) + 0.5) * px
    x, y = np.meshgrid(c, c[::-1])
    img = np.full((size, size, 3), 255.0)
    for sh in world_shapes(cfg, state, world_idx):
        kind = sh["kind"]
        if kind == "rect":
            x0, y0 = sh["xy"]
            inside = ((x >= x0) & (x <= x0 + sh["w"]) &
                      (y >= y0) & (y <= y0 + sh["h"]))
        elif kind == "polygon":
            v = sh["xy"]
            e = np.roll(v, -1, 0) - v
            cross = [e[k, 0] * (y - v[k, 1]) - e[k, 1] * (x - v[k, 0])
                     for k in range(len(v))]
            inside = (np.all([cr >= 0 for cr in cross], 0) |
                      np.all([cr <= 0 for cr in cross], 0))
        elif kind == "circle":
            cx, cy = sh["center"]
            inside = (x - cx) ** 2 + (y - cy) ** 2 <= sh["radius"] ** 2
        else:
            (x0, x1), (y0, y1) = sh["x"], sh["y"]
            d = np.array([x1 - x0, y1 - y0])
            t = np.clip(((x - x0) * d[0] + (y - y0) * d[1]) /
                        max(float(d @ d), 1e-12), 0.0, 1.0)
            dist = np.hypot(x - (x0 + t * d[0]), y - (y0 + t * d[1]))
            inside = dist <= sh["lw"] / 72 * 80 / 2 * px
        a = sh.get("alpha", 1.0)
        img[inside] = a * _rgb(sh["color"]) + (1 - a) * img[inside]
    return np.round(img).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """An ``[H, W, 3]`` u8 image as an 8-bit RGB PNG (no filter, zlib)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data +
                struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" +
                chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
                chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
                chunk(b"IEND", b""))


def save_episode_frames(cfg: EnvConfig, states, world_idx, out_dir,
                        every: int = 10):
    """Write ``frame_<t>.png`` for every ``every``-th state of ``states``
    (world-major states, live or loaded from checkpoints)."""
    os.makedirs(out_dir, exist_ok=True)
    for t, state in enumerate(states):
        if t % every == 0:
            write_png(os.path.join(out_dir, f"frame_{t:05d}.png"),
                      rasterize_world(cfg, state, world_idx))
