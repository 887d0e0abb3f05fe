"""Training launcher — the port of ``repro/launch/train.py``:
``python -m repro_torch.launch.train --arch <id> --smoke``.

Builds the arch's smoke config (the reduced widths its file names),
initialises its parameters from a seeded ``torch.Generator`` and drives
the fault-tolerant ``train.elastic.Runner`` (checkpoint, restart,
rescale) over a deterministic synthetic stream: a step's tokens come from
numpy at ``(seed, step)``, so a replay after a restart draws the same
batch. Runs on ``cuda`` unless ``--device cpu`` (no GPU and no
``--device cpu`` raises). ``--checkpoint-dir`` keeps the checkpoints
(default: a temporary directory, removed at exit).

The LM family trains its ``lm_loss`` with the arch's own optimizer, the
RecSys family its model's loss on batches of 32 (``RecsysArch.
_smoke_batch`` at ``(seed, step)``). A GNN id exits with the reference's
own message: the reference wires no training loop for it. A run at full
width exits, as the reference's does, because it needs a fleet of cards:
the placed cells that run it (``build_cell(..., weights="placed")`` on a
``DeviceMesh``, one rank a card; ``tools/torch_lm_timing.py --worlds
nccl:4`` runs qwen3-8b's ``train_4k`` so) are driven by a launcher per
host, and the reference's ``--distributed`` multi-host start is not
taken here.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from .. import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="train an arch's smoke config with the runner")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where the runner commits its checkpoints (default: a temporary "
                         "directory, removed at exit)")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..configs import get_arch
    from ..models import transformer as tf_m
    from ..train.elastic import Runner, RunnerConfig
    from ..train.optimizer import make_optimizer
    from ..train.train_step import init_train_state, make_train_step

    arch = get_arch(args.arch)
    if not args.smoke:
        raise SystemExit(
            "full-scale training needs a fleet of cards (the placed cells, one rank a card); "
            "run with --smoke for the reduced config (the dry run sizes the full-scale cells)")
    if arch.family not in ("lm", "recsys"):
        raise SystemExit(f"--smoke training loop not wired for family {arch.family}")
    dev = resolve_device(args.device)
    cfg = arch.smoke_cfg
    gen = torch.Generator().manual_seed(args.seed)
    oinit, oupd = make_optimizer(arch.optimizer)

    if arch.family == "lm":
        params = tf_m.init_params(gen, cfg, device=dev)
        step = make_train_step(lambda p, b: tf_m.lm_loss(p, cfg, b["tokens"], b["labels"]),
                               oupd)

        def batch_fn(i):
            toks = torch.from_numpy(np.random.default_rng([args.seed, i]).integers(
                0, cfg.vocab, size=(8, 33))).to(dev)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    else:
        init_fn, loss_fn_raw, _ = arch._fns(cfg)
        params = init_fn(gen, cfg, device=dev)
        step = make_train_step(lambda p, b: loss_fn_raw(p, cfg, b), oupd)

        def batch_fn(i):
            return arch._smoke_batch(cfg, 32, [args.seed, i], dev)

    with tempfile.TemporaryDirectory() as tmp:
        runner = Runner(
            RunnerConfig(
                total_steps=args.steps,
                checkpoint_dir=args.checkpoint_dir or tmp,
                checkpoint_every=args.checkpoint_every,
            ),
            step,
            batch_fn,
            init_train_state(params, oinit),
            device=dev,
        )
        _, hist = runner.run()
    losses = [h["loss"] for h in hist]
    print(f"trained {args.arch} {len(hist)} steps: loss {losses[0]:.4f} → {losses[-1]:.4f}"
          f" (restarts={runner.restarts})")


if __name__ == "__main__":
    main()
