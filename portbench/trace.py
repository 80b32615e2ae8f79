"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, reduced to the device's busy time (the union of the intervals in
which a kernel or copy ran, so overlapping kernels count once), per-kernel
device time, the longest device operations and the idle gaps named by the
host operation the profiler shows running in them."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

MARK = "portbench.window"
GAPS_NAMED = 2000        # the longest gaps that are named
NAME_CHARS = 160         # a kernel's name in the breakdown, cut to this


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the body; on exit ``out`` holds the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(MARK):
            yield
            sync()
        out["host_window_s"] = time.perf_counter() - t0
    out.update(reduce(prof))


def _intervals(prof):
    from torch.autograd import DeviceType

    dev, cpu, mark = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.name == MARK:
            # The marker's own device-side annotation spans the whole
            # stretch and is no device work.
            if e.device_type != DeviceType.CUDA:
                mark = (tr.start, tr.end)
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    return dev, cpu, mark


def reduce(prof) -> dict:
    dev, cpu, mark = _intervals(prof)
    if mark is None or not dev:
        return {"busy_s": None, "window_s": None, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    lo, hi = mark
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev
                 if e > lo and s < hi)
    busy, gaps = 0.0, []
    cur_s, cur_e = None, None
    prev_end = lo
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    busy += cur_e - cur_s
    if hi > prev_end:
        gaps.append((prev_end, hi))
    kernels = {}
    for s, e, n in dev:
        t, c = kernels.get(n, (0.0, 0))
        kernels[n] = (t + (e - s) * 1e-6, c + 1)
    device_ops = sorted(([n[:NAME_CHARS], t] for n, (t, _) in kernels.items()),
                        key=lambda r: -r[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": kernels, "device_ops": device_ops,
            "idle_gaps": name_gaps(gaps, cpu)}


def name_gaps(gaps, cpu) -> list:
    """Idle time by the innermost host operation that spans each gap's
    middle, over the GAPS_NAMED longest gaps; the 10 largest sums."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    if cpu:
        starts = np.array([c[0] for c in cpu], dtype=np.float64)
        ends = np.array([c[1] for c in cpu], dtype=np.float64)
        names = [c[2] for c in cpu]
    sums = {}
    for g0, g1 in gaps:
        name = "(no host operation)"
        if cpu:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                name = names[inside[np.argmin(ends[inside] - starts[inside])]]
        sums[name] = sums.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(([n, t] for n, t in sums.items()), key=lambda r: -r[1])[:10]


def kernel_time(trace: dict, func: str):
    """(device seconds per launch, launches) of the kernels whose name
    holds ``func(`` (the CUDA function, in whatever namespace) in the
    traced window, or None if none ran."""
    t = c = 0
    for name, (s, n) in trace.get("kernels", {}).items():
        if f"{func}(" in name:
            t, c = t + s, c + n
    return (t / c, c) if c else None
