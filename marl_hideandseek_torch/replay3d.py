"""3-D replay: a checkpoint record log as one self-contained HTML page
(port of scripts/replay3d.py).

    python -m marl_hideandseek_torch.replay3d LOG [--out replay.html]
        [--world 0] [--every 2] [--num-hiders 3] [--num-seekers 3]
        [--device cuda|cpu]

Frames are restored as ``replay`` restores them (``unpack_checkpoints``,
``HideAndSeekEnv.load_checkpoints``) and written as the JAX package's
scene JSON - walls ``p``/``h``; bodies ``p``/``q``/``h``/``k``/``l`` and
``t`` for agents; frames ``i``/``s`` - rounded as scripts/replay3d.py
rounds them, into the same page (``PAGE``, the JAX script's ``_PAGE``
verbatim): a dependency-free canvas renderer with an orbit camera,
play/pause and a frame scrubber, which any browser opens offline.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from marl_hideandseek_torch.config import EnvConfig
from marl_hideandseek_torch.replay import replay_env, replay_states
from marl_hideandseek_torch.types import EnvState, body_slot_ranges
from marl_hideandseek_torch.utils.ckptlog import CkptLogReader

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>hide&seek 3-D replay</title>
<style>
 body{margin:0;background:#101418;color:#cfd8e3;font:13px sans-serif}
 #bar{padding:6px 10px;display:flex;gap:10px;align-items:center}
 #cv{display:block;margin:auto;background:#151a21}
 input[type=range]{flex:1}
 button{background:#2a3442;color:#cfd8e3;border:0;padding:4px 12px;
        border-radius:4px;cursor:pointer}
</style></head><body>
<div id="bar">
 <button id="play">&#9654;</button>
 <input id="seek" type="range" min="0" max="0" value="0">
 <span id="lab"></span>
 <span style="opacity:.6">drag: orbit &middot; wheel: zoom</span>
</div>
<canvas id="cv" width="960" height="720"></canvas>
<script>
const SCENE = __SCENE__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const seek = document.getElementById('seek'), lab = document.getElementById('lab');
const playBtn = document.getElementById('play');
seek.max = SCENE.frames.length - 1;
let frame = 0, playing = false, yaw = 0.7, pitch = 0.9, dist = 58;
const BOX_F = [[0,1,3,2],[4,6,7,5],[0,4,5,1],[2,3,7,6],[0,2,6,4],[1,5,7,3]];
const BOX_V = s => [[-1,-1,-1],[-1,-1,1],[-1,1,-1],[-1,1,1],
                    [1,-1,-1],[1,-1,1],[1,1,-1],[1,1,1]]
                   .map(v => [v[0]*s[0], v[1]*s[1], v[2]*s[2]]);
// Wedge (data/ramp_collision.obj): verts scaled by half_ext.
const WED_V = s => [[1,1,1],[1,1,-1],[1,-2,-1],[-1,1,1],[-1,1,-1],[-1,-2,-1]]
                   .map(v => [v[0]*s[0], v[1]*s[1]/1, v[2]*s[2]]);
const WED_F = [[0,1,2],[3,5,4],[0,3,4,1],[1,4,5,2],[0,2,5,3]];
function qrot(q, v){
  const [w,x,y,z] = q, [vx,vy,vz] = v;
  const cx = y*vz - z*vy, cy = z*vx - x*vz, cz = x*vy - y*vx;
  const dx = y*cz - z*cy, dy = z*cx - x*cz, dz = x*cy - y*cx;
  return [vx + 2*w*cx + 2*dx, vy + 2*w*cy + 2*dy, vz + 2*w*cz + 2*dz];
}
function draw(){
  const f = SCENE.frames[frame];
  ctx.fillStyle = '#151a21'; ctx.fillRect(0, 0, cv.width, cv.height);
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const eye = [dist*cy_*cp, dist*sy*cp, dist*sp + 4];
  function cam(p){
    let x = p[0]-eye[0], y = p[1]-eye[1], z = p[2]-eye[2];
    let X = -sy*x + cy_*y;
    let Y = -cy_*sp*x - sy*sp*y + cp*z;
    let Z = -(cy_*cp*x + sy*cp*y + sp*z);
    return [X, Y, Z];
  }
  function proj(c){
    const s = 700 / Math.max(c[2], 1);
    return [cv.width/2 + c[0]*s, cv.height/2 - c[1]*s];
  }
  const faces = [];
  function emit(verts, faceIdx, col){
    for (const fi of faceIdx){
      const vs = fi.map(i => verts[i]), cs = vs.map(cam);
      if (cs.some(c => c[2] < 1)) continue;
      const e1 = [vs[1][0]-vs[0][0], vs[1][1]-vs[0][1], vs[1][2]-vs[0][2]];
      const e2 = [vs[2][0]-vs[0][0], vs[2][1]-vs[0][1], vs[2][2]-vs[0][2]];
      let n = [e1[1]*e2[2]-e1[2]*e2[1], e1[2]*e2[0]-e1[0]*e2[2],
               e1[0]*e2[1]-e1[1]*e2[0]];
      const nl = Math.hypot(...n) || 1; n = n.map(v => v/nl);
      const mid = cs.reduce((a,c)=>a+c[2],0)/cs.length;
      const lit = 0.55 + 0.45*Math.abs(n[0]*0.4 + n[1]*0.25 + n[2]*0.88);
      faces.push({d: mid, pts: cs.map(proj),
                  col: col.map(c => Math.min(255, c*lit))});
    }
  }
  // floor grid tile
  emit([[-19,-19,0],[19,-19,0],[-19,19,0],[19,19,0]], [[0,1,3,2]], [42,50,60]);
  for (const w of SCENE.walls)
    emit(BOX_V(w.h).map(v => [v[0]+w.p[0], v[1]+w.p[1], v[2]+w.p[2]]),
         BOX_F, [120,126,134]);
  for (const b of f.bodies){
    const base = b.k == 2 ? WED_V(b.h) : BOX_V(b.h);
    const verts = base.map(v => {
      const r = qrot(b.q, v);
      return [r[0]+b.p[0], r[1]+b.p[1], r[2]+b.p[2]];
    });
    let col = b.k == 0 ? [205,160,70] : b.k == 2 ? [150,90,170] :
              (b.t == 1 ? [80,170,230] : [230,90,80]);   // hider/seeker
    if (b.l) col = col.map(c => 0.55*c + 60);             // locked tint
    emit(verts, b.k == 2 ? WED_F : BOX_F, col);
    if (b.k == 1){  // agent heading marker
      const tip = qrot(b.q, [0, b.h[1]*1.6, 0]);
      emit([[b.p[0],b.p[1],b.p[2]+b.h[2]],
            [b.p[0]+tip[0],b.p[1]+tip[1],b.p[2]+tip[2]+b.h[2]*0.2],
            [b.p[0],b.p[1],b.p[2]+b.h[2]*0.6]], [[0,1,2]], [250,250,160]);
    }
  }
  faces.sort((a,b) => b.d - a.d);
  for (const fc of faces){
    ctx.beginPath();
    ctx.moveTo(fc.pts[0][0], fc.pts[0][1]);
    for (let i = 1; i < fc.pts.length; i++) ctx.lineTo(fc.pts[i][0], fc.pts[i][1]);
    ctx.closePath();
    ctx.fillStyle = `rgb(${fc.col[0]|0},${fc.col[1]|0},${fc.col[2]|0})`;
    ctx.fill();
    ctx.strokeStyle = 'rgba(10,12,16,.35)'; ctx.stroke();
  }
  lab.textContent = `frame ${f.i} (step ${f.s})  world ${SCENE.world}`;
  seek.value = frame;
}
seek.oninput = () => { frame = +seek.value; draw(); };
playBtn.onclick = () => { playing = !playing;
  playBtn.innerHTML = playing ? '&#10074;&#10074;' : '&#9654;'; };
setInterval(() => { if (playing){
  frame = (frame + 1) % SCENE.frames.length; draw(); } }, 66);
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008;
  pitch = Math.min(1.5, Math.max(0.1, pitch + (e.clientY - drag[1]) * 0.005));
  drag = [e.clientX, e.clientY]; draw(); };
cv.onwheel = e => { e.preventDefault();
  dist = Math.min(150, Math.max(15, dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  draw(); };
draw();
</script></body></html>
"""


def scene_walls(state: EnvState, w: int) -> list:
    """World ``w``'s active walls as the scene's ``{"p", "h"}``."""
    st = state.statics
    pos = st.wall_pos[w].cpu().numpy()
    half = st.wall_half_ext[w].cpu().numpy()
    act = st.wall_active[w].cpu().numpy()
    return [{"p": pos[k].round(3).tolist(), "h": half[k].round(3).tolist()}
            for k in range(pos.shape[0]) if act[k]]


def scene_frame(cfg: EnvConfig, state: EnvState, w: int, i: int) -> dict:
    """World ``w`` of world-major ``state`` as frame ``i`` of the scene:
    its active bodies (kind ``k`` 0 box, 1 agent, 2 ramp; agents with
    their type ``t``) and its step ``s``."""
    (box_lo, box_hi), (ramp_lo, ramp_hi), (agent_lo, _) = \
        body_slot_ranges(cfg)
    b = state.bodies
    pos, quat = b.pos[w].cpu().numpy(), b.quat[w].cpu().numpy()
    half = b.half_ext[w].cpu().numpy()
    active, locked = b.active[w].cpu().numpy(), b.locked[w].cpu().numpy()
    atype = state.agent_type[w].cpu().numpy()
    bodies = []
    for k in range(pos.shape[0]):
        if not active[k]:
            continue
        kind = (0 if box_lo <= k < box_hi
                else 2 if ramp_lo <= k < ramp_hi else 1)
        d = {"p": pos[k].round(3).tolist(),
             "q": quat[k].round(4).tolist(),
             "h": half[k].round(3).tolist(),
             "k": kind,
             "l": int(locked[k])}
        if kind == 1:
            d["t"] = int(atype[k - agent_lo])
        bodies.append(d)
    return {"i": i, "s": int(state.step[w]), "bodies": bodies}


def build_scene(reader: CkptLogReader, env, world: int, every: int) -> dict:
    """The scene of every ``every``-th frame of a log, world ``world``:
    the walls of the first kept frame, then each frame's bodies."""
    frames, walls = [], None
    for i, state in replay_states(reader, env, every):
        if walls is None:
            walls = scene_walls(state, world)
        frames.append(scene_frame(env.cfg, state, world, i))
    return {"world": world, "walls": walls or [], "frames": frames}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log")
    p.add_argument("--out", type=str, default="replay.html")
    p.add_argument("--world", type=int, default=0)
    p.add_argument("--every", type=int, default=2)
    p.add_argument("--num-hiders", type=int, default=3)
    p.add_argument("--num-seekers", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    with CkptLogReader(args.log) as reader:
        env = replay_env(reader, args.num_hiders, args.num_seekers,
                         args.device)
        scene = build_scene(reader, env, args.world, args.every)
    with open(args.out, "w") as f:
        f.write(PAGE.replace("__SCENE__", json.dumps(scene)))
    print(f"wrote {args.out}: {len(scene['frames'])} frames, "
          f"{os.path.getsize(args.out) / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
