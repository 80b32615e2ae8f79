"""How far rounding alone moves the first training update's Adam moments,
leaf by leaf, beside the distance between the card's update and the CPU's.

The set-up is that of ``tests/test_torch_gpu.py::test_ppo_update_matches_cpu``:
train.sh's configuration (PBT 2 + 2, grouped, the flagship policy at full
width) at 64 worlds, float32 with TF32 off, a rollout on ``--device``, then
``ppo_update`` on that device and on the CPU from the same buffer. Two more
CPU updates take the same buffer with every nonzero observation moved by one
float32 ulp, up and down. For each leaf of Adam's mu and nu the script
prints each run's largest difference from the CPU's, over the leaf's largest
moment (the test's measure, against the fixed bars of 1e-4 for mu and
2e-4 for nu that ``testing.rounding_bars`` floors its per-leaf bars at),
the leaf's largest moment, and the leaf's largest mu over the update's
largest (the leaf's share of the gradient). Run from the repository's root:

    python3 tools/ppo_rounding_witness.py [--device cuda] [--worlds 64]
        [--out table.json]

``--out`` also writes every leaf's row as JSON.
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from marl_hideandseek_torch import testing  # noqa: E402
from marl_hideandseek_torch.models.actor_critic import tree_map  # noqa: E402
from marl_hideandseek_torch.policy import make_policy  # noqa: E402
from marl_hideandseek_torch.train import __main__ as cli  # noqa: E402
from marl_hideandseek_torch.train import init_training, ppo  # noqa: E402
from marl_hideandseek_torch.train.rollout import collect_rollout  # noqa: E402

BARS = {k: testing.FIXED_BARS[k] for k in ("mu", "nu")}
SHOWN = 24     # printed rows, farthest from the CPU's first; JSON has all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env, cfg, pol = cli.build(cli.parse_args([
        "--ckpt-dir", "-", "--tb-dir", "-", "--run-name", "-",
        "--num-worlds", str(args.worlds), "--num-updates", "1",
        "--pbt-ensemble-size", "2", "--pbt-past-policies", "2",
        "--num-hiders", "2", "--num-seekers", "2", "--device",
        args.device]))
    dev = env.device
    mgr = init_training(dev, cfg, env, pol)
    st = mgr.state
    _, buf, _ = collect_rollout(cfg, env, pol, mgr.all_params(),
                                st.obs_stats, st.rollout, st.value_stats)
    stats = pol.obs_preprocess.update_state(st.obs_stats, {
        k: v.flatten(0, 2) for k, v in buf.obs.items()})

    def run(d, policy, obs=None):
        to = lambda x: x.to(d)
        opt = ppo.AdamState(mu=tree_map(to, st.opt_states.mu),
                            nu=tree_map(to, st.opt_states.nu),
                            count=to(st.opt_states.count))
        fields = dict(vars(buf))
        if obs is not None:
            fields["obs"] = obs
        b = type(buf)(**{k: tree_map(to, v) for k, v in fields.items()})
        return ppo.ppo_update(cfg, policy, tree_map(to, st.params), opt,
                              stats.to(d), tree_map(to, st.value_stats),
                              tree_map(to, st.hyper_params), b,
                              st.key.to(d))[1]

    cpu_dev = torch.device("cpu")
    cpu_pol = make_policy(device="cpu")
    runs = {"device": run(dev, pol)}
    cpu = run(cpu_dev, cpu_pol)
    cpu_obs = {k: v.to(cpu_dev) for k, v in buf.obs.items()}
    runs["ulp_up"] = run(cpu_dev, cpu_pol, testing.ulp_moved(cpu_obs, True))
    runs["ulp_down"] = run(cpu_dev, cpu_pol,
                           testing.ulp_moved(cpu_obs, False))

    top_mu = max(float(v.abs().max()) for v in cpu.mu.values())
    rows = []
    for name in ("mu", "nu"):
        for k, v in getattr(cpu, name).items():
            big = float(v.abs().max())
            row = dict(moment=name, leaf=k, largest=big,
                       mu_share=float(cpu.mu[k].abs().max()) / top_mu)
            for r, opt in runs.items():
                err = float((getattr(opt, name)[k].cpu() - v).abs().max())
                row[r] = err / big if big > 0 else 0.0
            rows.append(row)
    rows.sort(key=lambda r: -max(r[x] for x in runs) / BARS[r["moment"]])
    print(f"{'moment':6} {'leaf':60} {'device':>9} {'ulp_up':>9} "
          f"{'ulp_down':>9} {'largest':>9} {'mu_share':>9}")
    for r in rows[:SHOWN]:
        print(f"{r['moment']:6} {r['leaf'][-60:]:60} {r['device']:9.3e} "
              f"{r['ulp_up']:9.3e} {r['ulp_down']:9.3e} {r['largest']:9.3e} "
              f"{r['mu_share']:9.3e}")
    over = {r: sum(row[r] > BARS[row["moment"]] for row in rows)
            for r in runs}
    print(f"leaves over the test's bar: {over} of {len(rows)}; device "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(worlds=args.worlds, device=str(dev), bars=BARS,
                           over_bar=over, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
