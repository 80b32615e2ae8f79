"""A whole run of each kind of cell through the harness at a tiny size on
the CPU (the look for a card skipped), sound and with each fault planted
under the timed path (``portbench/faults.py``): ``correct`` comes out true,
then false. Each case in its own process, since a fault patches the
program's classes. CPU only; tens of seconds a case, each worker on one
thread."""

import json
import os
import subprocess
import sys

import pytest

from portbench import core

TINY = {
    "sim_2v2_w64k": {"num_worlds": 8, "probe": {"worlds": 8,
                                                 "first_within": 5}},
    "sim_2v2_rgbd_w16k": {"num_worlds": 4, "probe": {"worlds": 4,
                                                      "first_within": 5}},
    "serve_2v2_w16k": {"num_worlds": 4, "warmup_steps": 2,
                       "probe": {"agents": 16, "worlds": 4,
                                 "first_within": 5}},
    "train_2v2_w4k": {"num_worlds": 4, "probe": {"agents": 16, "worlds": 4}},
}
CASES = [(c, None) for c in TINY] + [
    (c, f) for c in ("sim_2v2_w64k", "serve_2v2_w16k", "train_2v2_w4k")
    for f in ("unchanged", "half_batch", "altered")]


def run_case(cell: str, fault) -> dict:
    code = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "from portbench import run\n"
        f"r = run.execute({cell!r}, {2 ** 31 + 4242}, 0.5, False,\n"
        f"    device='cpu', fault={fault!r}, mix_override={TINY[cell]!r},\n"
        "    env_override={'episode_len': 20}, log=lambda s: None)\n"
        "print(json.dumps(run.plain_json(r)))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")   # workers share the CPU
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_check_catches_fault(cell, fault):
    r = run_case(cell, fault)
    assert r["correct"] is (fault is None), r["checks"]
