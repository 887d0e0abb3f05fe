"""The check's control and its faults: what has to come out not correct.

* The control (``ControlDriver``) puts the reference in the program's
  place, computed one precision below the configuration's (the stored
  f16 values and the f32 queries rounded to bfloat16, summed in f32),
  and answers as the program does: a top-k for a serving mix, every
  document's score for a scan.
* The faults (``FAULTS``) break the program's own answers where they are
  produced: ``stale`` returns the previous batch's answers (a step that
  leaves its state unchanged), ``half`` answers the second half of the
  batch with the first half's, ``altered`` changes one answer of each
  batch, ``tail`` raises the last entry of every query's answer by 1 (a
  scan's last document, in the last partial block; a top-k's k-th
  score). A cell runs on one chip, so no exchange between chips can be
  left out.

Run the control on the card at a cell's own size, and the program beside
it on the same seeds, in one process::

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 10 [--program]

One JSON line a run: the cell, the side, the seed, ``correct`` and the
compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import reference

__all__ = ["ControlDriver", "FAULTS", "main"]


class ControlDriver:
    """The reference in bfloat16 in the program's place."""

    def __init__(self, mix: dict, device):
        self.mix, self.device = mix, torch.device(device)
        self.answers = "topk" if mix["kind"] == "retriever" else "scores"
        self.ref = None

    def build(self, host: dict, dim: int, value_format: str) -> None:
        t = lambda a: torch.from_numpy(a).to(self.device)
        self.ref = reference.Reference(t(host["components"].view("int32")), t(host["values"]),
                                       t(host["offsets"]), dim, control=True)

    def placed(self) -> dict:
        return {}

    def __call__(self, Q: torch.Tensor):
        S = self.ref.scores(Q)
        if self.answers == "scores":
            return S
        top = S.topk(int(self.mix["k"]), dim=1)
        return top.indices, top.values

    def release(self) -> None:
        self.ref = None


def _stale(prog):
    last = []

    def call(Q):
        out = prog(Q)
        if not last:
            last.append(out)
        answer, last[0] = last[0], out
        return answer
    return call


def _half(prog):
    def call(Q):
        out = prog(Q)
        parts = out if isinstance(out, tuple) else (out,)
        broken = []
        for a in parts:
            a = a.clone()
            h = a.shape[0] // 2
            a[a.shape[0] - h:] = a[:h]
            broken.append(a)
        return tuple(broken) if isinstance(out, tuple) else broken[0]
    return call


def _altered(prog):
    def call(Q):
        out = prog(Q)
        if isinstance(out, tuple):
            ids, scores = out[0].clone(), out[1]
            n = int(ids.max()) + 1
            ids[0, 0] = (ids[0, 0] + 1) % max(n, 2)
            return ids, scores
        out = out.clone()
        out[0, out[0].argmax()] *= 2
        return out
    return call


def _tail(prog):
    def call(Q):
        out = prog(Q)
        if isinstance(out, tuple):
            ids, scores = out
            scores = scores.clone()
            scores[:, -1] += 1.0
            return ids, scores
        out = out.clone()
        out[:, -1] += 1.0
        return out
    return call


#: fault name → wrapper of the program's call
FAULTS = {"stale": _stale, "half": _half, "altered": _altered, "tail": _tail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--program", action="store_true", help="also run the program on each seed")
    args = p.parse_args(argv)

    from .cells import ROOT, resolve

    sys.path.insert(0, str(ROOT / "src"))
    from . import harness

    if not torch.cuda.is_available():
        harness.log("the control runs on the card; no CUDA device")
        return 2
    cell = resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = [("control", ControlDriver(cell.mix, "cuda"))]
        if args.program:
            sides.append(("program", None))
        for side, driver in sides:
            r = harness.run(cell, seed, args.seconds, False, "cuda", driver=driver)
            print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "failed": r["failed"], "check": r["check"],
                              "metrics": r["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
