"""PyTorch port: the routed ensemble forward (``train/rollout.py::
apply_ensemble``) against the naive one, on the CPU.

The naive forward (``testing.naive_ensemble``) runs every policy on every
agent with the inputs shared (the train policies' full forward, the past
policies' actor-only step) and then picks each agent's policy; the routed
one runs each agent through its own policy only. Both backbones (the
flagship's pooled encoder with the Dreamer critic, ``openai_hns`` with its
masked attention and plain value head), 4 policies with and without a 2 +
2 train/past split, on assignments balanced as ``infer.py`` deals them,
skewed, with an empty policy and all on one policy; and one policy, which
is not routed. Only the row count of each product changes, so logits,
values and every recurrent-state leaf agree within 1e-5 of the naive
output's largest magnitude (at least 1): float32 rounding. The host tally
counts N rows needed and P x ``cap`` run, from one ``host_read.route`` a
call.
"""

import collections

import pytest
import torch

from marl_hideandseek_torch import prng
from marl_hideandseek_torch import policy as tpolicy
from marl_hideandseek_torch.models.actor_critic import tree_map
from marl_hideandseek_torch.testing import naive_ensemble
from marl_hideandseek_torch.train.rollout import (
    ROUTE,
    ROUTE_ALIGN,
    apply_ensemble,
    route_plan,
)
from marl_hideandseek_torch.utils import tracing

torch.set_num_threads(1)

P, W, A, C = 4, 64, 4, 32
N = W * A
TOL = 1e-5


def rel(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def observations(g, n=N):
    """Normalized observations in the packed env's flat layout: 0/1
    visibility, some entity rows all zero."""
    def data(e, f):
        x = torch.randn(n, e, f, generator=g)
        return (x * (torch.rand(n, e, 1, generator=g) < 0.8)).reshape(n, -1)

    def mask(e):
        return (torch.rand(n, e, generator=g) < 0.5).to(torch.float32)

    return {"prep_counter": torch.rand(n, 1, generator=g),
            "self_data": torch.randn(n, 13, generator=g),
            "self_type": torch.randint(0, 2, (n, 1), generator=g).float(),
            "self_mask": torch.ones(n, 1),
            "self_lidar": torch.rand(n, 30, generator=g),
            "agent_data": data(5, 14), "box_data": data(9, 17),
            "ramp_data": data(2, 14), "vis_agents_mask": mask(5),
            "vis_boxes_mask": mask(9), "vis_ramps_mask": mask(2)}


@pytest.fixture(scope="module", params=["pooled", "openai_hns"])
def case(request):
    """(policy, parameters moved by seeded noise so that the policies
    differ and the zero-initialized critic takes part, observations,
    recurrent state)."""
    pol = tpolicy.make_policy(backbone=request.param, num_policies=P,
                              num_rnn_channels=C, device="cpu",
                              key=prng.key(5))
    g = torch.Generator().manual_seed(0)
    params = {k: v.detach() + 0.02 * torch.randn(v.shape, generator=g)
              for k, v in pol.actor_critic.named_parameters()}
    rnn = tree_map(lambda x: 0.5 * torch.randn(x.shape, generator=g),
                   pol.actor_critic.init_recurrent_state(N))
    return pol, params, observations(g), rnn


def assignments(kind):
    """[N] policies: ``infer.py``'s round robin (hiders t0, seekers t1;
    exactly N / 4 each at a multiple of 16 worlds), 90 % on policy 0,
    none on the last policy, or all on policy 2 (with the 2 + 2 split, an
    empty train group)."""
    g = torch.Generator().manual_seed(1)
    if kind == "balanced":
        w = torch.arange(W)
        t0, t1 = w % P, (w + 1 + w // P) % P
        is_h = torch.arange(A) < A // 2
        return torch.where(is_h, t0[:, None], t1[:, None]).reshape(-1).to(
            torch.int32)
    if kind == "skewed":
        probs = torch.tensor([0.9, 0.04, 0.03, 0.03])
        return torch.multinomial(probs, N, True, generator=g).to(torch.int32)
    if kind == "empty":
        return torch.randint(0, P - 1, (N,), generator=g, dtype=torch.int32)
    return torch.full((N,), 2, dtype=torch.int32)


def cap(assign):
    top = int(torch.bincount(assign.long(), minlength=P).max())
    return min(N, -(-top // ROUTE_ALIGN) * ROUTE_ALIGN)


@pytest.mark.parametrize("kind", ["balanced", "skewed", "empty", "one"])
@pytest.mark.parametrize("num_train", [None, 2])
def test_routed_forward_matches_naive(case, kind, num_train):
    pol, params, obs, rnn = case
    assign = assignments(kind)
    before = ROUTE.read()
    with torch.no_grad(), tracing.recording() as rec:
        got = apply_ensemble(pol, params, rnn, obs, assign, P, num_train)
    names = collections.Counter(s.name for s in rec.take().spans)
    want = naive_ensemble(pol, params, rnn, obs, assign, P, num_train)
    assert rel(got[0], want[0]) <= TOL
    assert rel(got[1], want[1]) <= TOL
    leaves = lambda t: [x for e in t for x in e]
    assert [x.shape for x in leaves(got[2])] == [(1, N, C)] * 4
    for a, b in zip(leaves(got[2]), leaves(want[2])):
        assert rel(a, b) <= TOL
    if num_train:
        assert not bool(got[1][assign >= num_train].any())
        # The past agents' critic state passes through bit for bit.
        past = assign >= num_train
        for a, b in zip(got[2][1], rnn[1]):
            assert torch.equal(a[:, past], b[:, past])
    calls, needed, run = (a - b for a, b in zip(ROUTE.read(), before))
    assert (calls, needed, run) == (1, N, P * cap(assign))
    assert names["host_read.route"] == 1 and names["ensemble.route"] == 2


@pytest.mark.parametrize("kind", ["balanced", "skewed", "empty", "one"])
def test_route_plan_layout(kind):
    """Each agent's routed row holds that agent; a policy's rows hold its
    agents in agent order, then repeat its last one (agent 0 for a policy
    with none)."""
    assign = assignments(kind)
    plan = route_plan(assign, P)
    assert plan.cap == cap(assign) and plan.rows.shape == (P * plan.cap,)
    assert torch.equal(plan.rows[plan.back], torch.arange(N))
    for p, r in enumerate(plan.rows.reshape(P, plan.cap)):
        mine = torch.nonzero(assign == p)[:, 0]
        k = mine.numel()
        assert torch.equal(r[:k], mine)
        assert bool((r[k:] == (mine[-1] if k else 0)).all())


def test_one_policy_is_not_routed(case):
    """One policy runs on the whole batch as before: no plan, no read,
    nothing tallied, the naive forward's outputs bit for bit."""
    pol, params, obs, rnn = case
    one = {k: v[:1] for k, v in params.items()}
    zeros = torch.zeros(N, dtype=torch.int32)
    before = ROUTE.read()
    with torch.no_grad(), tracing.recording() as rec:
        got = apply_ensemble(pol, one, rnn, obs, zeros, 1)
    assert not any(s.name.endswith(".route") for s in rec.take().spans)
    assert ROUTE.read() == before
    want = naive_ensemble(pol, one, rnn, obs, zeros, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip([x for e in got[2] for x in e],
                    [x for e in want[2] for x in e]):
        assert torch.equal(a, b)
