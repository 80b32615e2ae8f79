"""Write a markdown manifest of a training run's checkpoints (port of
scripts/ckpt_manifest.py, over the port's layout).

    python -m marl_hideandseek_torch.ckpt_manifest RUN_NAME
        [--ckpt-root runs/ckpts] [--regen-cmd CMD]

Checkpoints stay out of git; the manifest ``<ckpt-root>/<RUN_NAME>/
CKPT_MANIFEST.md`` is what is committed: a section per checkpoint
``<update>.pt`` (``python -m marl_hideandseek_torch.train``'s files), in
update order, with its size and sha256, and the command that regenerates
the run.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys


def sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def checkpoint_steps(root: str) -> list:
    """The update counts of the ``<n>.pt`` files in ``root``, ascending."""
    return sorted((int(fn[:-3]) for fn in os.listdir(root)
                   if fn.endswith(".pt") and fn[:-3].isdigit()
                   and os.path.isfile(os.path.join(root, fn))))


def manifest(run_name: str, root: str, regen_cmd=None) -> str:
    """The manifest's markdown for the checkpoints in ``root``."""
    lines = [
        f"# Checkpoint manifest — {run_name}",
        "",
        "Blobs are NOT committed; regenerate with the command below and",
        "verify integrity against the hashes.",
        "",
    ]
    if regen_cmd:
        lines += ["## Regeneration", "", "```", regen_cmd, "```", ""]
    for step in checkpoint_steps(root):
        fn = f"{step}.pt"
        fp = os.path.join(root, fn)
        lines += [f"## update {step}", "",
                  f"- `{fn}` {os.path.getsize(fp)} B sha256 `{sha256(fp)}`",
                  ""]
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_name")
    p.add_argument("--ckpt-root", default="runs/ckpts")
    p.add_argument("--regen-cmd", default=None,
                   help="command line that regenerates the run")
    args = p.parse_args(argv)

    root = os.path.join(args.ckpt_root, args.run_name)
    if not os.path.isdir(root):
        sys.exit(f"no checkpoint dir: {root}")
    out_path = os.path.join(root, "CKPT_MANIFEST.md")
    text = manifest(args.run_name, root, args.regen_cmd)
    with open(out_path, "w") as f:
        f.write(text)
    print(f"wrote {out_path} ({len(checkpoint_steps(root))} checkpoints)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
