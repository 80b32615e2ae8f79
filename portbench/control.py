"""Readings that set the limits of a cell's check: the program's sound runs
against the reference, the control (the reference one precision below the
configuration's, on the same program run), and planted faults.

    python3 -m portbench.control --workload CELL --seeds 11,12,13
        [--seconds S] [--fault unchanged|half_batch|altered] [--out FILE]

One process runs every seed (the kernels load once): set-up, a window of
``S`` seconds (0 for training, whose readings need none) and the steps
past it that the probes need, then the check twice, sound and control
(with ``--fault``, the fault's readings alone). One JSON line a seed, on
standard output and appended to ``FILE``. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from portbench import core


def readings(cell_name: str, seed: int, seconds: float, fault=None,
             device="cuda", mix_override=None, env_override=None) -> dict:
    import torch

    from portbench.drivers import common

    bench = core.benchmark()
    cell = core.cell(bench, cell_name)
    conf = core.load_json(core.config_file(bench, cell["config"]))
    conf["env"].update(env_override or {})
    mix = core.traffic(cell["traffic"])
    mix.update(mix_override or {})
    common.float32_exact()
    run = common.Run(conf, mix, seed, device, fault=fault)
    drv = core.driver(mix["driver"]).Driver(run)
    t0 = time.perf_counter()
    drv.setup()
    drv.window(seconds)
    drv.finish_probes()
    drv.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "fault": fault, "run_s": time.perf_counter() - t0,
           "sound": drv.check()}
    if fault is None:
        run.control = True
        out["control"] = drv.check()
    out["limits"] = mix["limits"]
    del drv
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for k, v in core.cache_dirs().items():
        os.environ.setdefault(k, v)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds, args.fault)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
