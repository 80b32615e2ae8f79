"""The import guard compares whole top-level module names; the run
refuses to start without a card. CPU only."""

import subprocess
import sys
import types

from portbench import core


def test_guard_catches_a_planted_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert core.forbidden_modules() == ["jax", "jax.numpy"]


def test_guard_catches_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "marl_hideandseek_tpu.env",
                        types.ModuleType("marl_hideandseek_tpu.env"))
    assert core.forbidden_modules() == ["marl_hideandseek_tpu.env"]


def test_guard_passes_the_port(monkeypatch):
    for name in ("marl_hideandseek_torch", "marl_hideandseek_torch.env",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == []


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sim_2v2_w64k", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
