"""The harness's data: BENCHMARK.json, the configuration and traffic files,
the window drivers and the per-layer metric readers, each found by its name.

    portbench/configs/<config>.json        a configuration's sizes
    portbench/traffic/<traffic>.json       a traffic mix: its driver and
                                           parameters, and its limits
    portbench/drivers/<driver>.py          the window driver of a kind
    portbench/layer_metrics/<metric>.py    reads one per-layer metric

Nothing here lists cells, configurations or metrics: a new one is new
files and new BENCHMARK.json entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "marl_hideandseek_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise SystemExit(f"portbench: no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(PKG / "traffic" / f"{name}.json")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str) -> ModuleType:
    """``layer_metrics/<name>.py`` (a metric's name may hold dots)."""
    return load_module(PKG / "layer_metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``kind`` metrics ("end_to_end" or "per_layer") that cell
    ``cell_name`` reports: those that list it, or list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_start_seconds_ago() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs() -> dict:
    """Fixed cache directories inside the checkout for the toolchains the
    program may use; the port's own kernels build into
    ``marl_hideandseek_torch/_build/``."""
    base = ROOT / ".portbench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "cuda")}
