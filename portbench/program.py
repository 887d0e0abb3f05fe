"""The program's own spans and counters (``repro_torch.spans``) in a traced
run of one cell, and the five readings taken from them.

    python3 -m portbench.program --workload <cell> --seed <n> [--seconds <s>] [--record-window]

runs the cell as ``portbench.run --trace 1`` does (the same set-up,
window, profiled pass and check, through ``harness.run``), with the
cell's driver wrapped in :class:`RecordingDriver`:

* set-up (the index build and the warm-up calls) is recorded, and before
  the last warm-up call the driver calls the program ``trace_batches``
  times on that batch with spans on: the host time of each stage, before
  any profiler has run (once a profile has run, every CUDA call of the
  process is slower: PERF.md, PR 29);
* the window is not recorded, unless ``--record-window`` asks for it (to
  measure what recording costs); the counters are read at the window's
  first call and again at the first profiled call, after its last;
* the harness's profiled pass runs with spans off, as ever;
* when the harness releases the program, the batches of that pass run
  twice more: under ``torch.profiler`` with spans on (each span is then a
  ``record_function`` range beside the device operations: the idle gaps
  get the port's stage names), and with spans on and the profiler off
  (the stages' host time after a profile, for comparison).

Prints one JSON line: the harness's result, with the cell's end-to-end
metrics read from the traced window too, and ``program``: the readings,
the spans' ``summary`` (count, total and self µs a stage) of the set-up
pass and of the one after the profile, the idle time by stage, the
breakdown of the spans-on profiled pass and the seconds the two passes
after the window took. :data:`READERS` take ``{"program": <the driver's
record>}``; each returns None where its inputs are absent.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import torch

from . import cells, drivers, trace

__all__ = ["OUTER", "RecordingDriver", "read_profile", "READERS", "main"]

#: the outermost span of a call into the program, by path
OUTER = ("repro_torch.search", "repro_torch.scan")
PREFIX = "repro_torch."
#: the CUDA runtime call that replays a captured plan
GRAPH_LAUNCH = "cudaGraphLaunch"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class RecordingDriver:
    """A driver of ``drivers.py`` with the program's spans recorded in
    set-up, a spans-on pass before the last warm-up call, its counters
    read around the window, and two more passes over the profiled
    batches run when the harness releases it. The record is
    :attr:`program`."""

    def __init__(self, inner, warm_batches: int, passes: int, record_window: bool = False):
        if warm_batches < 1:
            raise ValueError("the recorded pass runs before the last warm-up call: "
                             "warm_batches must be at least 1")
        self.inner, self.warm, self.passes = inner, int(warm_batches), int(passes)
        self.record_window = record_window
        self.answers = inner.answers
        self.calls = 0
        self.batches: list = []
        self.program: dict = {}
        self._recording = contextlib.ExitStack()

    def _start_recording(self) -> None:
        from repro_torch import spans

        spans.reset()
        self._recording.enter_context(spans.recording())

    def _stop_recording(self) -> dict:
        from repro_torch import spans

        self._recording.close()
        return spans.snapshot()

    def build(self, host: dict, dim: int, value_format: str) -> None:
        self._start_recording()
        self.inner.build(host, dim, value_format)

    def placed(self) -> dict:
        return self.inner.placed()

    def __call__(self, Q):
        from repro_torch import spans

        self.calls += 1
        if self.calls == self.warm:  # the last warm-up call
            setup = self._stop_recording()
            self.program["setup"] = {"spans": [s._asdict() for s in setup["spans"]],
                                     "dropped": setup["dropped"]}
            self.program["recorded"] = recorded_pass(self.inner, [Q] * self.passes)
        elif self.calls == self.warm + 1:  # the window's first call
            self.program["counters_window_start"] = dict(spans.counters)
            if self.record_window:
                self._start_recording()
        if _profiling():
            if "counters_window_end" not in self.program:
                self.program["counters_window_end"] = dict(spans.counters)
                if self.record_window:
                    self.program["window_summary"] = spans.summary(self._stop_recording()["spans"])
            self.batches.append(Q)
        return self.inner(Q)

    def release(self) -> None:
        if self.batches:
            self.program.update(extra_passes(self.inner, self.batches))
        self.batches = []
        self.inner.release()


def recorded_pass(call, batches: list) -> dict:
    """``call(Q)`` then a synchronize for each batch, spans on, profiler
    off → ``outer_us`` (the outermost spans' µs, one a call), the spans'
    ``summary``, ``dropped`` and the pass's ``seconds``."""
    from repro_torch import spans

    t0 = time.perf_counter()
    spans.reset()
    _sync()
    with spans.recording():
        for Q in batches:
            call(Q)
            _sync()
    snap = spans.snapshot()
    spans.reset()
    return {"outer_us": [(s.end_ns - s.start_ns) / 1e3 for s in snap["spans"]
                         if s.parent < 0 and s.name in OUTER],
            "summary": spans.summary(snap["spans"]), "dropped": snap["dropped"],
            "seconds": time.perf_counter() - t0}


def extra_passes(call, batches: list) -> dict:
    """The spans-on profiled pass and the spans-on unprofiled pass over
    ``batches`` (the first ``trace.WARM_BATCHES`` warm the profiler and
    are left out of both readings)."""
    from repro_torch import spans

    t0 = time.perf_counter()
    spans.reset()
    with spans.recording():
        prof, n = trace.profile_batches(call, batches)
    profiled = read_profile(prof)
    kept = [e for e in prof.events() if not _annotation(e)]
    profiled["breakdown"] = trace.summarize(types.SimpleNamespace(events=lambda: kept),
                                            n)["breakdown"]
    del prof
    after = recorded_pass(call, batches[trace.WARM_BATCHES:])
    return {"profiled": profiled, "recorded_after_profile": after,
            "passes_s": time.perf_counter() - t0}


def _annotation(e) -> bool:
    """A span's device-side mark (it covers the operations the range
    launched; it is not one)."""
    return e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith(PREFIX)


def _innermost(stages: list, t: float):
    """The shortest stage range that holds ``t``, or None."""
    best = None
    for s, e, name in stages:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best


def read_profile(prof) -> dict:
    """A spans-on profile of ``trace.profile_batches`` → ``window_s``,
    ``busy_s``, ``dispatch_idle_s`` (device idle while the host is
    inside a ``repro_torch.*`` range), ``idle_by_stage`` {innermost
    stage or ``outside``: seconds}, ``replay_bubble_s`` and
    ``replay_gaps``. A replay's operations are the device operations
    that share a correlation id with the ``cudaGraphLaunch`` inside
    ``repro_torch.plan.replay`` (``replay_link`` "graph"); failing that,
    the ones that start after the span opens and before the first device
    operation of the next ``repro_torch.plan.copy_out`` (``replay_link``
    "clock"). ``replay_bubble_s`` lists, one entry a replay, the device's
    idle time between its first and its last operation;
    ``replay_gaps`` gives that idle time by the operations before and
    after it (top 10, seconds)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    windows = [e for e in events if e.name == trace.RANGE and e.device_type == cpu]
    if not windows:
        raise RuntimeError(f"the profile holds no {trace.RANGE!r} range")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end  # µs
    dev, host, stages = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t <= w0 or s >= w1 or e.name == trace.RANGE or _annotation(e):
            continue
        if e.device_type == cuda:
            dev.append((s, t, e.id, e.name))
        elif e.name.startswith(PREFIX):
            stages.append((s, t, e.name))
        else:
            host.append((s, t, e.name, e.id))
    clipped = np.array([(max(s, w0), min(t, w1)) for s, t, _, _ in dev], dtype=np.float64)
    busy = trace._union(clipped.reshape(-1, 2))
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    idle: dict = {}
    for g0, g1 in gaps:
        cuts = sorted({g0, g1, *(x for s, e, _ in stages for x in (s, e) if g0 < x < g1)})
        for a, b in zip(cuts[:-1], cuts[1:]):
            inner = _innermost(stages, 0.5 * (a + b))
            label = inner[2] if inner else "outside"
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    replays, link, between = _replay_bubbles(dev, host, stages)
    top = sorted(between.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6,
            "dispatch_idle_s": sum(v for k, v in idle.items() if k != "outside"),
            "idle_by_stage": idle, "replay_bubble_s": replays, "replay_link": link,
            "replay_gaps": [list(kv) for kv in top]}


def _replay_bubbles(dev, host, stages):
    """→ (idle µs·1e-6 inside each replay's operations, how they were
    found, {"<op before> -> <op after>": idle seconds} over every replay)."""
    replays = sorted((s, e) for s, e, n in stages if n == PREFIX + "plan.replay")
    copies = sorted((s, e) for s, e, n in stages if n == PREFIX + "plan.copy_out")
    out, links, between = [], set(), {}
    for r0, r1 in replays:
        ids = {i for s, t, n, i in host if n == GRAPH_LAUNCH and r0 <= s <= r1}
        ops = [d for d in dev if d[2] in ids]
        link = "graph"
        if not ops:
            link = "clock"
            after = [c for c in copies if c[0] >= r1]
            if not after:
                continue
            c0, c1 = after[0]
            calls = {i for s, t, n, i in host if n.startswith("cuda") and c0 <= s <= c1}
            starts = [s for s, t, i, _ in dev if i in calls]
            if not starts:
                continue
            ops = [d for d in dev if r0 <= d[0] < min(starts)]
        if not ops:
            continue
        ops.sort()
        idle, end, last = 0.0, ops[0][1], ops[0][3]
        for s, t, _, name in ops[1:]:
            if s > end:
                idle += s - end
                key = f"{last[:60]} -> {name[:60]}"
                between[key] = between.get(key, 0.0) + (s - end) * 1e-6
            if t >= end:
                end, last = t, name
        out.append(idle * 1e-6)
        links.add(link)
    return out, (links.pop() if len(links) == 1 else "mixed" if links else None), between


# -- the readings ---------------------------------------------------------------------


def program_dispatch_us(rec):
    """Mean host µs of the outermost span (``search`` or ``scan``) over
    the spans-on pass of set-up."""
    outer = rec.get("program", {}).get("recorded", {}).get("outer_us")
    return sum(outer) / len(outer) if outer else None


def dispatch_idle_pct(rec):
    """Share of the spans-on profiled window with no device operation
    while the host is inside a ``repro_torch.*`` span, in %."""
    p = rec.get("program", {}).get("profiled")
    if not p or p["window_s"] <= 0:
        return None
    return 100 * p["dispatch_idle_s"] / p["window_s"]


def replay_bubble_us(rec):
    """Mean device-idle µs a batch inside the operations a plan's replay
    launched (flat and Seismic plans; None where no replay ran)."""
    p = rec.get("program", {}).get("profiled")
    bubbles = p and p["replay_bubble_s"]
    return 1e6 * sum(bubbles) / len(bubbles) if bubbles else None


def program_build_s(rec):
    """Seconds of set-up's ``build.pack`` and ``build.place`` spans
    (outermost ones of the two names)."""
    spans = rec.get("program", {}).get("setup", {}).get("spans")
    if not spans:
        return None
    names = {PREFIX + "build.pack", PREFIX + "build.place"}
    total = 0
    for s in spans:
        if s["name"] in names and (s["parent"] < 0 or spans[s["parent"]]["name"] not in names):
            total += s["end_ns"] - s["start_ns"]
    return total / 1e9 if total else None


def window_rebuilds(rec):
    """Plans captured and kernel libraries loaded inside the window."""
    p = rec.get("program", {})
    a, b = p.get("counters_window_start"), p.get("counters_window_end")
    if a is None or b is None:
        return None
    return sum(b.get(k, 0) - a.get(k, 0) for k in ("plan.captures", "kernels.loads"))


#: metric name → reader of ``{"program": RecordingDriver.program}``
READERS = {"program_dispatch_us": program_dispatch_us, "dispatch_idle_pct": dispatch_idle_pct,
           "replay_bubble_us": replay_bubble_us, "program_build_s": program_build_s,
           "window_rebuilds": window_rebuilds}


def readings(program: dict) -> dict:
    rec = {"program": program}
    return {name: fn(rec) for name, fn in READERS.items()}


def run(cell, seed: int, seconds: float, device="cuda", *, record_window=False, **kw) -> dict:
    """One traced run of ``cell`` through ``harness.run`` with the
    driver recorded; ``kw`` (``config``, ``mix``) as ``harness.run``
    takes them."""
    from . import harness

    cell = dataclasses.replace(cell, per_layer=[*cell.per_layer, *cell.end_to_end])
    mix = {**cell.mix, **(kw.get("mix") or {})}
    drv = RecordingDriver(drivers.make_driver(mix, device), mix["warm_batches"],
                          mix["trace_batches"], record_window)
    result = harness.run(cell, seed, seconds, True, device, driver=drv, **kw)
    p = drv.program
    result["program"] = {
        "readings": readings(p), "record_window": record_window,
        "summary": p.get("recorded", {}).get("summary"),
        "summary_after_profile": p.get("recorded_after_profile", {}).get("summary"),
        "window_summary": p.get("window_summary"),
        "idle_by_stage": p.get("profiled", {}).get("idle_by_stage"),
        "replay_link": p.get("profiled", {}).get("replay_link"),
        "replay_gaps": p.get("profiled", {}).get("replay_gaps"),
        "breakdown": p.get("profiled", {}).get("breakdown"),
        "passes_s": p.get("passes_s"),
        "setup_pass_s": p.get("recorded", {}).get("seconds"),
    }
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.program",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=cells.load_benchmark()["run_seconds"])
    p.add_argument("--record-window", action="store_true",
                   help="record spans in the window too (what recording costs)")
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(cells.ROOT / "build" / "triton_cache")
    sys.path.insert(0, str(cells.ROOT / "src"))
    from .harness import forbidden_loaded, log

    cell = cells.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s)")
        return 2
    result = run(cell, args.seed, args.seconds, "cuda", record_window=args.record_window)
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
