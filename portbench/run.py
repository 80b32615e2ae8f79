"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. The cell (BENCHMARK.json's ``workloads``)
names a configuration (``portbench/configs/``) and a traffic mix
(``portbench/traffic/``), whose ``driver`` (``portbench/drivers/``) builds
the system under test from the seed, warms up the cell's shapes, and runs
the window for ``S`` seconds. With ``--trace 0`` the result line holds the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``portbench/layer_metrics/<metric>.py`` from spans, counters and
a ``torch.profiler`` stretch after the window, with the device's busy
time and the trace's breakdown. Then the check: what the timed path
produced against the frozen plain reference (``portbench/reference/``);
each number compared is printed beside its limit, on the last lines of
standard error and last in the result line. The last line of standard
output is the result, one JSON object.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), outside a checkout that holds the program, or
if ``jax``, ``jaxlib``, ``flax`` or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from portbench import core


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def limits_line(numbers: dict, limits: dict) -> list:
    """[[name, reading, limit], ...] of every number with a limit; a
    reading that is missing or not finite is the string "nan" or "inf"
    (JSON has no such numbers) and fails."""
    out = []
    for k, lim in limits.items():
        v = numbers.get(k, math.inf)
        out.append([k, v if math.isfinite(v) else str(v), lim])
    return out


def passes(checks: list) -> bool:
    return all(isinstance(v, (int, float)) and v <= lim
               for _, v, lim in checks)


def plain_json(x):
    """``x`` with every non-finite float as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: plain_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain_json(v) for v in x]
    return x


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device="cuda", control: bool = False, fault: str = None,
            mix_override: dict = None, env_override: dict = None,
            log=print) -> dict:
    """Set-up, window, trace and check of one run; returns the result
    object (without the import guard, which ``main`` applies)."""
    t_proc = time.perf_counter() - core.process_start_seconds_ago()
    import torch

    from portbench.drivers import common

    bench = core.benchmark()
    cell = core.cell(bench, cell_name)
    conf = core.load_json(core.config_file(bench, cell["config"]))
    mix = core.traffic(cell["traffic"])
    mix.update(mix_override or {})
    conf["env"].update(env_override or {})
    common.float32_exact()
    run = common.Run(conf, mix, seed, device, trace=trace, control=control,
                     fault=fault)
    drv = core.driver(mix["driver"]).Driver(run)
    drv.setup()
    common.sync(run.device)
    setup_s = time.perf_counter() - t_proc
    win = drv.window(seconds)
    drv.finish_probes()
    result = {"correct": False, "attempted": win["attempted"], "failed": 0}
    # The program's peak, before the traced stretch's counts run the
    # frozen reference on the card.
    on_card = run.device.type == "cuda"
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if on_card else 0)}
    if trace:
        out = {}
        drv.profile_segment(out)
        values = drv.layer_values()
        ctx = {"spans": run.spans.spans, "trace": out, "values": values,
               "window_s": win["elapsed"], "config": conf, "mix": mix}
        metrics = {}
        for m in core.metrics_of(bench, cell_name, "per_layer"):
            v = core.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": out.get("device_ops", []),
                               "idle_gaps": out.get("idle_gaps", [])}
    else:
        metrics = {k: {"value": v, "unit": m["unit"]}
                   for m in core.metrics_of(bench, cell_name, "end_to_end")
                   for k, v in win["metrics"].items() if k == m["name"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if trace:
        device_info.update(busy_s=out.get("busy_s"),
                           window_s=out.get("window_s"))
    log(json.dumps(plain_json({"counters": drv.counters(), "setup_s": setup_s,
                    "window_s": win["elapsed"], "power": power_limit()
                    if on_card else None})))
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = drv.check()
    limits = mix["limits"]
    checks = limits_line(numbers, limits)
    result["correct"] = passes(checks)
    result["failed"] = int(numbers.get("probes_missing", 0))
    result["metrics"] = metrics
    result["device"] = device_info
    result["numbers"] = {k: v for k, v in numbers.items() if k not in limits}
    result["check_s"] = time.perf_counter() - t0
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    for k, v in core.cache_dirs().items():
        os.environ.setdefault(k, v)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {torch.cuda.device_count()} cards, the cell asks "
              f"for {cell['chips']}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, v, lim in result["checks"]:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(plain_json(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
