"""The program's own spans of the traced stretch, for the readers of
``layer_metrics/`` whose source is ``program_span``.

The port records a span for each phase it runs while a ``torch.profiler``
profile records (``marl_hideandseek_torch/utils/tracing.py``), so the
traced stretch after the window leaves them in the process's store. The
first reader of a run takes them (``tracing.take()``) and keeps them in the
run's ``ctx``; the others read that copy. Each reading is per unit of the
cell: per ``update`` span for training, per ``env.step`` span for the serve
loop and the simulator.

A checkout whose program has no tracing module, or a ``ctx`` without a
traced stretch, gives nothing (``None``)."""

from __future__ import annotations

KEY = "program_spans"
HOST_READ = "host_read."


def taken(ctx):
    """The stretch's spans (``tracing.Span`` records), or None."""
    if not (ctx.get("trace") or {}).get("window_s"):
        return None
    if KEY not in ctx:
        try:
            from marl_hideandseek_torch.utils import tracing
        except ImportError:
            ctx[KEY] = None
        else:
            ctx[KEY] = tracing.take().spans
    return ctx[KEY]


def count(spans, name: str, parent=None) -> int:
    return sum(1 for s in spans
               if s.name == name and (parent is None or s.parent == parent))


def device_ms_per(ctx, name: str, unit: str, parent=None):
    """Device-clock ms of the spans ``name`` (inside ``parent``, if
    given), summed, per ``unit`` span; None without either, or where a
    span holds no device time."""
    spans = taken(ctx)
    if not spans:
        return None
    units = count(spans, unit)
    ms = [s.device_ms for s in spans
          if s.name == name and (parent is None or s.parent == parent)]
    if not units or not ms or any(m is None for m in ms):
        return None
    return sum(ms) / units


def host_reads_per_step(ctx):
    """``host_read.*`` spans per ``env.step`` span."""
    spans = taken(ctx)
    if not spans:
        return None
    steps = count(spans, "env.step")
    if not steps:
        return None
    return sum(1 for s in spans if s.name.startswith(HOST_READ)) / steps
