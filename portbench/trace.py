"""The traced run: ``torch.profiler`` over a fixed number of batches of the
program's calls alone (their queries made beforehand, so no kernel of
the benchmark's runs among them), read into device busy time, the time
of each device operation, and the idle gaps labelled by what the host
was doing.

The traced window is the ``portbench.traced`` range; device intervals
(kernels, copies, fills) are clipped to it. Busy time is the union of
the intervals; a gap's label is the innermost host operation that spans
its midpoint (``host: python`` where none does).
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["RANGE", "profile_batches", "summarize", "kernel_seconds"]

RANGE = "portbench.traced"
#: profiled batches before the traced range opens (the profiler's own warm-up)
WARM_BATCHES = 2
_TOP = 10


def profile_batches(call, batches: list) -> tuple:
    """Run ``call(Q)`` then ``synchronize`` for each prepared batch under
    the profiler → (the profiler, the batches inside the traced range)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        for Q in batches[:WARM_BATCHES]:
            call(Q)
            sync()
        with torch.profiler.record_function(RANGE):
            for Q in batches[WARM_BATCHES:]:
                call(Q)
                sync()
    return prof, len(batches) - WARM_BATCHES


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint union of [start, end] rows."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.stack(out)


def summarize(prof, batches: int) -> dict:
    """→ ``window_s``, ``busy_s``, ``device_s`` (every device operation
    summed), ``ops`` {name: seconds}, ``batches`` and the breakdown's
    ``device_ops`` and ``idle_gaps`` (top 10 each, seconds)."""
    events = prof.events()
    windows = [e for e in events if e.name == RANGE and e.device_type == torch.autograd.DeviceType.CPU]
    if not windows:
        raise RuntimeError(f"the profile holds no {RANGE!r} range")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end  # µs
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1 or e.name == RANGE:  # the range's own device-side mark
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((max(s, w0), min(t, w1), e.name))
        else:
            host.append((s, t, e.name))
    ops: dict = {}
    for s, t, name in dev:
        ops[name] = ops.get(name, 0.0) + (t - s) * 1e-6
    busy = _union(np.array([(s, t) for s, t, _ in dev], dtype=np.float64).reshape(-1, 2))
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)  # [gap start, gap end]
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict = {}
    if len(gaps):
        hs = np.array([h[0] for h in host], dtype=np.float64)
        he = np.array([h[1] for h in host], dtype=np.float64)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = ("host: " + host[inside[np.argmin(he[inside] - hs[inside])]][2]
                     if len(inside) else "host: python")
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-6
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0
    top = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]
    return {"batches": batches, "window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_s": sum(ops.values()), "ops": ops,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the operations whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in trace["ops"].items() if rx.search(name))
