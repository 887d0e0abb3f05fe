"""One run of one cell: set-up, the measured window, the traced batches,
the check, and the result line's numbers.

Set-up makes the corpus and the query pool on the device from the seed
(``corpus.py``), hands the program the host CSR, builds and places its
index (``drivers.py``), and warms the cell's own batch shape. The window
is a closed loop, one batch in flight: the client densifies the next
batch of pool rows (two small kernels), then the program is called on
it and the batch ends when its answers are on the device. A batch's
latency is the device's clock between a CUDA event recorded just before
the call and one recorded just after it returns, read once it has
completed; ``qps`` is the queries of every batch completed over the
window's host-clock seconds. After the window the program is released
and the reference (``reference.py``) judges the answers (``check.py``).
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time

import torch

from . import cells, check, corpus, counts, drivers, reference, trace

__all__ = ["run", "process_age_s", "FORBIDDEN_MODULES", "forbidden_loaded"]

_T_IMPORT = time.perf_counter()

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: batches kept on the device between copies to the host (answers of the
#: serving cells)
_RING = 64


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names in ``modules`` (``sys.modules``),
    compared whole."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules if modules is None else modules)}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks; else since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def card(device: torch.device) -> dict:
    """The device part of the result line."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        info["power_limit_w"] = float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """A batch's latency in ms: CUDA events on the card; on the CPU the
    host clock (tests only)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return 1e3 * (time.perf_counter() - self.t0)


class _TopkAnswers:
    """Every batch's ``(ids, scores)``, through a device ring to the host."""

    def __init__(self, batch: int, k: int, device):
        self.ids = torch.empty((_RING, batch, k), dtype=torch.int64, device=device)
        self.scores = torch.empty((_RING, batch, k), dtype=torch.float32, device=device)
        self.host_ids, self.host_scores, self.n = [], [], 0

    def add(self, b: int, out) -> None:
        ids, scores = out
        j = b % _RING
        self.ids[j].copy_(ids)
        self.scores[j].copy_(scores)
        self.n = b + 1
        if j == _RING - 1:
            self._flush(_RING)

    def _flush(self, m: int) -> None:
        self.host_ids.append(self.ids[:m].to("cpu", copy=True))
        self.host_scores.append(self.scores[:m].to("cpu", copy=True))

    def answers(self, sched: torch.Tensor) -> check.Answers:
        if self.n % _RING:
            self._flush(self.n % _RING)
        k = self.ids.shape[2]
        rows = sched[torch.arange(self.n, device=sched.device) % sched.shape[0]].reshape(-1)
        return check.Answers(rows=rows, ids=torch.cat(self.host_ids).reshape(-1, k),
                             scores=torch.cat(self.host_scores).reshape(-1, k))


class _ScanAnswers:
    """The sampled batches' answers: one batch in ``check_every``, from a
    phase drawn from the seed, until ``check_slots`` batches are kept. A
    sampled batch's answer is read as each query's top-``k``, its scores of
    ``check_docs`` documents drawn from the seed, and every document's
    score for ``check_queries`` of its queries drawn from the seed. They
    are copied, without a wait, into host buffers made (pinned) in set-up,
    so the window holds no more device memory for them."""

    def __init__(self, mix: dict, batch: int, n_docs: int, seed: int, device):
        g = corpus.generator(seed, "check", device)
        self.k, self.every = int(mix["k"]), int(mix["check_every"])
        slots, full = int(mix["check_slots"]), int(mix["check_queries"])
        self.phase = int(torch.randint(0, self.every, (1,), generator=g, device=device))
        self.docs = torch.randperm(n_docs, generator=g, device=device)[:int(mix["check_docs"])]
        self.full = torch.stack([torch.randperm(batch, generator=g, device=device)[:full]
                                 for _ in range(slots)])
        pin = device.type == "cuda"
        buf = lambda *shape: torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        self.ids = torch.empty((slots, batch, self.k), dtype=torch.int64, pin_memory=pin)
        self.scores = buf(slots, batch, self.k)
        self.sampled = buf(slots, batch, self.docs.numel())
        self.rows = buf(slots, full, n_docs)
        self.batches = []

    def add(self, b: int, out) -> None:
        j = len(self.batches)
        if (b + self.phase) % self.every or j == self.ids.shape[0]:
            return
        top = out.topk(self.k, dim=1)
        self.ids[j].copy_(top.indices, non_blocking=True)
        self.scores[j].copy_(top.values, non_blocking=True)
        self.sampled[j].copy_(out[:, self.docs], non_blocking=True)
        self.rows[j].copy_(out[self.full[j]], non_blocking=True)
        self.batches.append(b)

    def answers(self, sched: torch.Tensor) -> check.Answers:
        """After the window, once the device has been waited for."""
        m = len(self.batches)
        if not m:
            raise RuntimeError("the window ended before the first sampled batch")
        B = self.ids.shape[1]
        rows = torch.cat([sched[b % sched.shape[0]] for b in self.batches])
        full_at = (B * torch.arange(m, device=self.full.device).unsqueeze(1) + self.full[:m])
        return check.Answers(rows=rows, ids=self.ids[:m].reshape(m * B, -1),
                             scores=self.scores[:m].reshape(m * B, -1),
                             sample_docs=self.docs, sample_scores=self.sampled[:m].reshape(m * B, -1),
                             full_at=full_at.reshape(-1),
                             full_scores=self.rows[:m].reshape(-1, self.rows.shape[2]))


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool, device="cuda", *,
        config: dict | None = None, mix: dict | None = None, driver=None, wrap=None) -> dict:
    """One run of ``cell`` → the result line (a dict). ``config`` and
    ``mix`` override entries of the cell's files (a test on the CPU
    shrinks ``n_docs``, ``pool``, ``batch``); ``driver`` replaces the
    program (the control) and ``wrap`` breaks its answers (the fault
    tests)."""
    dev = torch.device(device)
    cfg, mix = {**cell.config, **(config or {})}, {**cell.mix, **(mix or {})}
    n_docs, n_pool, B = int(cfg["n_docs"]), int(mix["pool"]), int(mix["batch"])
    dim, vfmt = int(cfg["dim"]), cfg["value_format"]
    rec = {"mix": mix, "spans": {}}

    t = time.perf_counter()
    docs, queries = corpus.make(cfg, n_docs, n_pool, seed, dev)
    stats = counts.corpus_stats(docs.comps, docs.offsets, vfmt, (queries.vals > 0).sum(dim=1))
    host = docs.host()
    del docs
    log(f"corpus: {stats['n_docs']} docs, {stats['nnz']} nonzeros, pool {queries.n} in "
        f"{time.perf_counter() - t:.3f} s")

    prog = driver or drivers.make_driver(mix, dev)
    t = time.perf_counter()
    prog.build(host, dim, vfmt)
    _sync(dev)
    rec["spans"]["index_build_s"] = time.perf_counter() - t
    log(f"index build and placement: {rec['spans']['index_build_s']:.3f} s")
    rec["placed_bytes"] = {name: a.numel() * a.element_size()
                           for name, a in prog.placed().items() if isinstance(a, torch.Tensor)}
    rec["stats"] = stats
    del host
    gc.collect()

    call = wrap(prog) if wrap else prog
    sched = corpus.schedule(n_pool, B, seed, dev)
    n_sched = sched.shape[0]
    qbuf = torch.empty((B, dim), dtype=torch.float32, device=dev)
    t = time.perf_counter()
    for i in range(int(mix["warm_batches"])):
        queries.densify(sched[i % n_sched], qbuf)
        call(qbuf)
        _sync(dev)
    warm_s = time.perf_counter() - t
    if prog.answers == "topk":
        kept = _TopkAnswers(B, int(mix["k"]), dev)
    else:
        kept = _ScanAnswers(mix, B, n_docs, seed, dev)
    timer = _Timer(dev)
    gc.collect()
    _sync(dev)

    rec["setup_s"] = process_age_s()
    log(f"set-up {rec['setup_s']:.3f} s (warm-up {warm_s:.3f} s)")
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # set-up's freed blocks; the plans' graph pools stay
        torch.cuda.reset_peak_memory_stats(dev)
    lat, host_s, nb = [], [], 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        queries.densify(sched[nb % n_sched], qbuf)
        timer.start()
        h0 = time.perf_counter()
        out = call(qbuf)
        h1 = time.perf_counter()
        lat.append(timer.stop())
        host_s.append(h1 - h0)
        kept.add(nb, out)
        out = None  # the answer is kept or read; the next batch does not find it held
        nb += 1
        if time.perf_counter() >= deadline:
            break
    t1 = time.perf_counter()
    _sync(dev)
    peak_window = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    rec["window"] = {"seconds": t1 - t0, "batch": B, "batches": nb, "queries": nb * B,
                     "batch_ms": lat, "host_call_s": host_s}
    rec["device_mem_window_bytes"] = peak_window
    log(f"window: {nb} batches of {B} in {t1 - t0:.3f} s")

    device = card(dev)
    if traced:
        first = nb % n_sched
        batches = [queries.dense(sched[(first + i) % n_sched])
                   for i in range(trace.WARM_BATCHES + int(mix["trace_batches"]))]
        prof, n_traced = trace.profile_batches(call, batches)
        rec["trace"] = trace.summarize(prof, n_traced)
        del prof, batches
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    if dev.type == "cuda":
        device["memory_peak_bytes"] = max(peak_setup, torch.cuda.max_memory_allocated(dev))

    answers = kept.answers(sched)
    del kept, call, qbuf
    prog.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    docs, _ = corpus.make(cfg, n_docs, n_pool, seed, dev)  # the reference's own copy
    ref = reference.Reference(docs.comps, docs.vals, docs.offsets, dim)
    numbers, summary = check.judge(ref, queries, answers, cell.limits)
    del ref, docs
    log(f"check: {summary['checked']} answers, {summary['failed']} failed, in "
        f"{time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cells.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = summary["checked"] > 0 and all(n["value"] <= n["limit"] for n in numbers.values())
    result = {"correct": bool(correct), "attempted": rec["window"]["queries"],
              "failed": summary["failed"], "metrics": metrics, "device": device}
    if traced:
        result["breakdown"] = rec["trace"]["breakdown"]
    result["check"] = numbers
    return result
