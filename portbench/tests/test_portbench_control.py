"""On the card, at a size a test run holds: the sound run passes every
limit of its cell and the control (the reference one precision below the
configuration's) fails at least one. Marked ``gpu``; skips without a
card (decided in the ``cuda`` fixture)."""

import pytest
import torch

SMALL = {
    "sim_2v2_w64k": {"num_worlds": 2048},
    "sim_2v2_rgbd_w16k": {"num_worlds": 1024},
    "serve_2v2_w16k": {"num_worlds": 1024, "probe": {
        "agents": 4096, "worlds": 64, "first_within": 20}},
    "train_2v2_w4k": {"num_worlds": 256},
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def fails(numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items()
            if not numbers.get(k, float("inf")) <= lim]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_sound_passes(cuda, cell):
    from portbench import control

    r = control.readings(cell, 2 ** 31 + 17, 0.0, mix_override=SMALL[cell],
                         env_override={"episode_len": 48})
    assert fails(r["sound"], r["limits"]) == [], r["sound"]
    assert fails(r["control"], r["limits"]), r["control"]
