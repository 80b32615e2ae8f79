"""The readers of the program's spans (``portbench/spans.py`` and the
``layer_metrics/`` files whose source is ``program_span``) on a made-up
traced stretch: one update of two rollout steps and two minibatches. CPU
only."""

import math
import sys

import pytest

from marl_hideandseek_torch.utils import tracing
from portbench import core, spans


def stretch():
    """(name, parent, device ms) of the made-up spans, in closing order."""
    rows = [("rollout.forward", "rollout", 10.0)]
    for ms, obs in ((5.0, 1.0), (7.0, 2.0)):
        rows += [("host_read.reset_trigger", "env.step", 0.5),
                 ("env.observations", "env.step", obs),
                 ("env.step", "rollout", ms)]
    rows += [("rollout.forward", "rollout", 12.0), ("rollout", "update", 40.0),
             ("ppo.loss", "ppo", 20.0), ("ppo.adam", "ppo", 3.0),
             ("ppo.loss", "ppo", 22.0), ("ppo.adam", "ppo", 4.0),
             ("ppo", "update", 60.0), ("host_read.pbt_rank", "pbt", 0.1),
             ("pbt", "update", 1.0), ("update", None, 110.0)]
    return [tracing.Span(n, p, i, i + 1, ms)
            for i, (n, p, ms) in enumerate(rows)]


def ctx_of(records):
    return {"spans": {}, "values": {}, "window_s": 1.0,
            "trace": {"busy_s": 0.5, "window_s": 1.0},
            spans.KEY: records}


@pytest.mark.parametrize("name,want", [
    ("forward_ms.train", 22.0), ("env_ms.train", 12.0), ("loss_ms", 42.0),
    ("adam_ms", 7.0), ("obs_ms.sim", 1.5), ("host_reads.train", 1.5),
    ("host_reads.serve", 1.5), ("host_reads.sim", 1.5)])
def test_reader_reads_a_made_up_stretch(name, want):
    got = core.metric_reader(name).read(ctx_of(stretch()))
    assert math.isclose(got, want), (name, got)


@pytest.mark.parametrize("name", ["forward_ms.train", "obs_ms.sim",
                                  "host_reads.sim"])
def test_reader_without_its_unit_reads_nothing(name):
    kept = [s for s in stretch() if s.name not in ("update", "env.step")]
    assert core.metric_reader(name).read(ctx_of(kept)) is None
    assert core.metric_reader(name).read(ctx_of([])) is None


def test_device_time_missing_reads_nothing():
    cpu = [s._replace(device_ms=None) for s in stretch()]
    assert core.metric_reader("loss_ms").read(ctx_of(cpu)) is None
    assert core.metric_reader("host_reads.sim").read(ctx_of(cpu)) == 1.5


def test_spans_are_taken_once_a_run(monkeypatch):
    calls = []

    def take():
        calls.append(1)
        return tracing.Taken(stretch(), 0)

    monkeypatch.setattr(tracing, "take", take)
    ctx = ctx_of(None)
    del ctx[spans.KEY]
    assert core.metric_reader("loss_ms").read(ctx) == 42.0
    assert core.metric_reader("adam_ms").read(ctx) == 7.0
    assert len(calls) == 1


def test_nothing_without_a_stretch_or_a_tracing_module(monkeypatch):
    ctx = ctx_of(None)
    del ctx[spans.KEY]
    ctx["trace"] = {}
    assert spans.taken(ctx) is None and spans.KEY not in ctx
    ctx["trace"] = {"busy_s": 0.5, "window_s": 1.0}
    # A program without the module (the package holds no such attribute).
    from marl_hideandseek_torch import utils
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "marl_hideandseek_torch.utils.tracing",
                        None)
    assert core.metric_reader("host_reads.serve").read(ctx) is None
