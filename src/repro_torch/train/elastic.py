"""Fault-tolerant training runner — the port of ``repro/train/elastic.py``.

* **Crash/restart** — every ``checkpoint_every`` steps (and at the last
  step) the whole train state is committed atomically
  (``train/checkpoint.py``); ``Runner.run`` wraps each step in a
  recovery loop: any exception restores the last committed step and
  replays from there. A deterministic per-step data stream
  (``batch_fn(step)``) makes the replay exact: bit for bit on the CPU,
  and on the card under ``torch.use_deterministic_algorithms(True)``.
* **Rescale** — checkpoints store host arrays, so a run restores onto
  another device; ``Runner.rescale(device)`` makes later restores put
  the state there (the reference's ``rescale(shardings)``).
* **Step deadline** — ``step_timeout_s`` synchronises the device after
  the step (``torch.cuda.synchronize``, where the reference calls
  ``jax.block_until_ready``) and treats a step past the deadline as a
  fault, recovered through the restart path.
* **Fault injection for tests** — ``FaultInjector`` raises at chosen
  steps, once each.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from . import checkpoint

__all__ = ["FaultInjector", "RunnerConfig", "Runner"]


class FaultInjector:
    """Deterministically raise at given global steps (once each)."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep_last: int = 3
    max_restarts: int = 10
    step_timeout_s: float | None = None  # None → no deadline enforcement


def _sync(metrics: dict) -> None:
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class Runner:
    """Drives ``step_fn`` with checkpoint/restart/rescale semantics."""

    def __init__(
        self,
        cfg: RunnerConfig,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        batch_fn: Callable,  # (step) -> batch  (deterministic per step!)
        init_state: Any,
        *,
        device=None,
        fault_injector: FaultInjector | None = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state = init_state
        self.device = device
        self.fault = fault_injector
        self.restarts = 0
        self.history: list[dict] = []

    # -- recovery ----------------------------------------------------------
    def _restore_or_init(self):
        last = checkpoint.latest_step(self.cfg.checkpoint_dir)
        if last is None:
            return self.init_state, 0
        state, meta = checkpoint.restore(
            self.cfg.checkpoint_dir, self.init_state, device=self.device
        )
        return state, int(meta["step"]) + 1

    def rescale(self, device) -> None:
        """Adopt another device: later restores put the state there."""
        self.device = device

    # -- main loop -----------------------------------------------------------
    def run(self) -> tuple[Any, list[dict]]:
        state, start = self._restore_or_init()
        step = start
        while step < self.cfg.total_steps:
            try:
                t0 = time.monotonic()
                if self.fault is not None:
                    self.fault.maybe_fail(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                if self.cfg.step_timeout_s is not None:
                    _sync(metrics)
                    dt = time.monotonic() - t0
                    if dt > self.cfg.step_timeout_s:
                        raise TimeoutError(f"step {step} exceeded deadline ({dt:.1f}s)")
                self.history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                if (step + 1) % self.cfg.checkpoint_every == 0 or step + 1 == self.cfg.total_steps:
                    checkpoint.save(
                        self.cfg.checkpoint_dir, step, state, keep_last=self.cfg.keep_last
                    )
                step += 1
            except Exception:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                state, step = self._restore_or_init()
        return state, self.history
