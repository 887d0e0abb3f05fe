"""Live index mutation: delta segments, tombstones, the crash-safe
generation flip and the background merge — the port of
``repro/serve/segments.py`` (DESIGN.md §10–§11).

* ``MutableRetriever`` wraps a *base* ``Retriever`` (or
  ``ShardedRetriever``) and an ordered list of immutable **delta
  segments** — each a self-contained sub-index built by the engine's
  ``build_arrays`` and saved as an ordinary ``manifest.json +
  arrays.npz`` artifact — with a **tombstone** mask per part for deletes
  and updates.
* ``search`` fans a padded query batch over base + segments, maps each
  part's local candidate ids through its id map to *stable* doc ids
  (dead rows and the sentinel slot map to -1, at -inf) and merges with
  the sentinel-safe ``api.merge_topk`` (dedupe on stable id): on the CPU
  the top-k is byte-identical to a ``Retriever.build`` over the live
  corpus in stable-id order (``live_corpus``).
* ``merge()`` folds segments and tombstones into a new base
  (``ForwardIndex.concat`` / ``select``) and commits by an **atomic
  generation flip**: ``generation_NNNN/`` is written whole, then the
  ``CURRENT`` file is replaced (``os.replace``). A crash before the flip
  leaves the previous generation loadable (the ``InjectedCrash`` hooks);
  orphan directories are ignored on open and reclaimed on retry.
* Every mutation and every flip bumps ``epoch``: the pipeline's
  ``ResultCache`` flushes at the next admission, and the fan-out plan
  key carries ``gen="g<N>"``, so a flip retires the facade plans.

A part's candidate budget grows by its own tombstone count (``k_part =
min(n_part, k + dead_part)``), so ``k`` live candidates survive the
mask; a change of budget makes a new part ``Retriever`` (on the card: a
new graph pool and new captures for every bucket the part serves).

On the card. The stable ids stay i64 on the host; each part's id map is
i32 on the device, and the gather, the masking and the merge run eagerly
on the device between the parts' replayed plans. The fan-out plan is a
``pipeline.FacadePlan`` (never captured) keyed ``shard="mut"``; each part
is a ``Retriever`` keyed ``shard="mut:<label>"`` whose own ``PlanCache``
captures and replays its graphs, and the facade keeps ``(label,
launches, stages)`` records of them, not the plans.

Threads and CUDA (a capture in the default, global mode forbids every
other thread's allocation, synchronisation and graph destruction):

* the serving thread captures a part's plan at its first search in a
  bucket, under ``pipeline.CUDA_EXCLUSIVE``, as every capture does;
* a writer places a new segment's arrays on the device under
  ``CUDA_EXCLUSIVE``; a delete touches only host state;
* the merge worker (``merge(background=True)``) sets its device, builds
  the new base on the host, and places it under ``CUDA_EXCLUSIVE``; it
  then prewarms the new base's plans holding ``CUDA_EXCLUSIVE`` across
  every warm-up and capture, each capture on the worker's own stream in
  ``"thread_local"`` mode, so the serving thread keeps replaying,
  allocating and copying meanwhile and only a first-touch capture of its
  own waits;
* a retired part (its budget moved, or a flip) is not dropped where it
  is retired: it joins ``_retired`` and is released — its graphs
  destroyed, its pool freed — under ``CUDA_EXCLUSIVE`` once no dispatch
  holds a snapshot of the parts, i.e. never beside a capture.

A sharded base filters its tombstones itself (``set_tombstones``, its
uniform budgets) and is served through its own fan-out plan; it takes
no prewarm, as in the reference.

On-disk layout under a mutable root (``open_retriever`` dispatches on
the ``CURRENT`` file), the reference's::

    root/CURRENT                     ← name of the live generation dir
    root/generation_0000/
        state.json                   ← atomic rewrite per mutation
        store.npz                    ← base CSR rows + stable ids
        base/                        ← ordinary (or sharded) artifact
        segment_0000/                ← ordinary artifact + store.npz
        segment_0001/…
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.forward_index import VALUE_FORMATS, ForwardIndex
from ..kernels import modes
from . import api
from . import pipeline as serve_pipeline
from .api import ArtifactError, Retriever, RetrieverConfig
from .pipeline import CUDA_EXCLUSIVE
from .sharded import ShardedRetriever

__all__ = [
    "InjectedCrash",
    "DeltaSegment",
    "MergeHandle",
    "MutablePlanCache",
    "MutableRetriever",
    "open_mutable",
    "MUTABLE_VERSION",
]

#: bumped whenever the mutable state layout changes incompatibly
MUTABLE_VERSION = 1
_MUTABLE_FORMAT = "repro.serve.mutable"
CURRENT_FILE = "CURRENT"
GEN_DIR_FMT = "generation_{:04d}"
SEGMENT_DIR_FMT = "segment_{:04d}"
STATE_FILE = "state.json"
STORE_FILE = "store.npz"


class InjectedCrash(RuntimeError):
    """Raised by the fault-injection hooks (``_crash_before_commit`` /
    ``crash_before_flip``) to simulate a process death between the
    payload write and the atomic commit."""


class MergeHandle:
    """Handle on a background merge (``merge(background=True)``): the
    generation build runs on a worker thread while queries keep serving
    generation N; ``result()`` joins and returns the new base, re-raising
    anything the merge raised (an injected crash surfaces here, not in
    the serving threads).

    The worker raises its own nice value (per thread on Linux), so on a
    saturated host the merge takes idle cycles between query bursts."""

    #: nice increment for the merge worker (0 disables the demotion)
    NICENESS = 10

    def __init__(self, run):
        self._result = None
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(run,), name="mutable-merge", daemon=True
        )
        self._thread.start()

    def _run(self, run) -> None:
        try:
            if self.NICENESS:
                # Linux scopes setpriority to one thread given a thread id;
                # elsewhere this raises and the merge runs at normal priority
                os.setpriority(
                    os.PRIO_PROCESS, threading.get_native_id(),
                    os.getpriority(os.PRIO_PROCESS, 0) + self.NICENESS,
                )
        except (AttributeError, OSError):
            pass
        try:
            self._result = run()
        except BaseException as e:  # noqa: BLE001  (re-raised by result())
            self._exc = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"merge still running after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


def _atomic_write(path: pathlib.Path, text: str) -> None:
    """Write-then-rename, the commit primitive: ``os.replace`` is atomic
    on POSIX, so a reader sees the old or the new content, never a part."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text, encoding="utf-8")
    os.replace(tmp, path)


def _store_dict(fwd: ForwardIndex, ids: np.ndarray) -> Dict[str, np.ndarray]:
    return {
        "components": fwd.components,
        "values": fwd.values,
        "offsets": fwd.offsets,
        "ids": np.asarray(ids, np.int64),
    }


def _load_store(path: pathlib.Path, dim: int, value_format: str
                ) -> Tuple[ForwardIndex, np.ndarray]:
    if not path.is_file():
        raise ArtifactError(f"missing row store {path}")
    with np.load(path) as z:
        fwd = ForwardIndex(
            components=z["components"],
            values=z["values"],
            offsets=z["offsets"],
            dim=dim,
            value_format=VALUE_FORMATS[value_format],
        )
        ids = z["ids"]
    if fwd.n_docs != len(ids):
        raise ArtifactError(f"row store {path} holds {fwd.n_docs} rows but {len(ids)} ids")
    return fwd, ids


def _place(arrays: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays → tensors on ``device``, under ``CUDA_EXCLUSIVE`` (a
    writer or the merge worker runs this beside the serving thread)."""
    with CUDA_EXCLUSIVE:
        return api._to_device(arrays, device)


@dataclasses.dataclass
class DeltaSegment:
    """One immutable delta segment: its stable doc ids, its CSR rows (the
    merge's source), its engine arrays on the device (the servable
    sub-index) and its tombstone mask."""

    ids: np.ndarray  # i64 [n] stable doc ids
    fwd: ForwardIndex  # the segment's own rows
    arrays: Mapping[str, torch.Tensor]  # EngineImpl.build_arrays, placed
    dead: np.ndarray  # bool [n]

    @property
    def n_docs(self) -> int:
        return len(self.ids)


@dataclasses.dataclass(frozen=True)
class _Part:
    """One fan-out target: a plan surface (a part ``Retriever``'s
    ``PlanCache`` or the sharded base's plan cache), its part-local →
    stable id map (i32 [n_local + 1] on the device; dead rows and the
    sentinel slot hold -1) and its label."""

    plans: object
    idmap: torch.Tensor
    n_local: int
    label: str


class MutablePlanCache:
    """The plan surface of a ``MutableRetriever`` — the ``buckets`` /
    ``bucket_for`` / ``get`` / ``created`` / ``search`` / ``compiles``
    contract of ``pipeline.PlanCache``, so the scheduler serves a mutable
    index unchanged.

    Each bucket's plan is a ``pipeline.FacadePlan`` over base + segments,
    keyed ``shard="mut"`` and ``gen="g<N>"``: a merge's flip changes the
    generation, so the plan is *retired* (counted in ``retired``) and
    made anew. ``compiles`` sums every part's plan creations and those of
    the parts retired before."""

    def __init__(self, retriever: "MutableRetriever", buckets=None):
        cfg = retriever.cfg
        self.retriever = retriever
        self.buckets = serve_pipeline.plan_buckets(cfg.batch_size, buckets)
        self.k = cfg.k
        self.device = retriever.device
        self._plans: Dict[int, serve_pipeline.FacadePlan] = {}
        self.retired = 0
        self._lock = threading.Lock()

    bucket_for = serve_pipeline.PlanCache.bucket_for

    @property
    def compiles(self) -> int:
        return self.retriever._part_compiles()

    def get(self, bucket: int) -> serve_pipeline.FacadePlan:
        with self._lock:
            gen = f"g{self.retriever.generation}"
            plan = self._plans.get(bucket)
            if plan is not None and plan.key.gen != gen:
                self.retired += 1
                plan = None
            if plan is None:
                cfg = self.retriever.cfg
                key = serve_pipeline.PlanKey(
                    cfg.engine, cfg.codec, cfg.backend, modes.check_backend(cfg.backend),
                    cfg.k, bucket, shard="mut", gen=gen, vq=cfg.vq,
                )
                plan = serve_pipeline.FacadePlan(key, self.retriever._dispatch)
                self._plans[bucket] = plan
            return plan

    def created(self) -> Dict[int, serve_pipeline.FacadePlan]:
        with self._lock:
            return dict(sorted(self._plans.items()))

    def search(self, Q) -> Tuple[torch.Tensor, torch.Tensor]:
        if Q.shape[0] == 0:
            return (torch.zeros((0, self.k), dtype=torch.int32, device=self.device),
                    torch.zeros((0, self.k), dtype=torch.float32, device=self.device))
        return self.get(self.bucket_for(Q.shape[0]))(Q)


class MutableRetriever:
    """Serving handle over a mutable index: the ``search`` / ``pipeline``
    / ``search_batch`` / ``make_plans`` surface of ``Retriever`` plus
    ``insert`` / ``delete`` / ``update`` / ``merge``. Construct with
    ``MutableRetriever.create`` (a fresh corpus, optionally persisted
    under a root directory), by wrapping a built base (``base_fwd``,
    ``base_ids``), or with ``open_retriever`` on a mutable root.

    Doc identity is the *stable id*: ``search`` returns stable ids, which
    survive merges. ``next_id`` is the id-space high-water mark (the
    merge's out-of-corpus sentinel) and ``epoch`` counts index-state
    changes (the result cache's invalidation trigger). The device is the
    base's."""

    def __init__(
        self,
        cfg: RetrieverConfig,
        base,
        *,
        base_fwd: ForwardIndex,
        base_ids: np.ndarray,
        base_dead: Optional[np.ndarray] = None,
        segments: Optional[List[DeltaSegment]] = None,
        next_id: Optional[int] = None,
        generation: int = 0,
        epoch: int = 0,
        root=None,
    ):
        if base_fwd.n_docs != len(base_ids):
            raise ValueError(f"base store holds {base_fwd.n_docs} rows but {len(base_ids)} ids")
        self.cfg = cfg
        self.impl = api.get_engine(cfg.engine)
        self.base = base
        self.device = base.device
        self.base_fwd = base_fwd
        self.base_ids = np.asarray(base_ids, np.int64)
        self.base_dead = (
            np.zeros(len(self.base_ids), bool)
            if base_dead is None else np.asarray(base_dead, bool).copy()
        )
        self.segments: List[DeltaSegment] = list(segments or [])
        all_ids = [self.base_ids] + [s.ids for s in self.segments]
        top = max((int(a.max()) for a in all_ids if a.size), default=-1)
        self.next_id = int(next_id) if next_id is not None else top + 1
        if self.next_id <= top:
            raise ValueError(f"next_id={next_id} ≤ live id {top}")
        self.generation = int(generation)
        self.epoch = int(epoch)
        self.root = pathlib.Path(root) if root is not None else None
        self.dim = base.dim
        self.value_scale = base.value_scale
        self.value_format = base.value_format
        self._handles: Optional[List[_Part]] = None
        self._wrappers: Dict[object, Retriever] = {}
        self._retired_compiles = 0
        #: retired part wrappers awaiting release (module docstring)
        self._retired: List[Retriever] = []
        #: dispatches holding a snapshot of the parts
        self._inflight = 0
        # single writer: every mutation (insert/delete/update/merge) holds
        # _write_lock for its whole run, so a background merge freezes the
        # logical corpus without read-side locks; _state_lock guards the
        # brief windows readers race (the part list, the flip's field
        # swap, tombstone flips, the in-flight count)
        self._write_lock = threading.RLock()
        self._state_lock = threading.RLock()
        #: overlap counters (read by ServeStats.sync_overlap): Σ merge
        #: wall-clock, Σ the flip's critical section (the bound on how
        #: long a query can block on a flip)
        self.merge_wall_us = 0.0
        self.blocked_swap_us = 0.0
        self.plans = MutablePlanCache(self)
        self._pipeline: serve_pipeline.Pipeline | None = None

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, fwd: ForwardIndex, cfg: RetrieverConfig, root=None, *,
               device=None) -> "MutableRetriever":
        """Build generation 0 from a fresh corpus: the base by the
        ordinary ``Retriever.build`` on ``device`` (sharded iff
        ``cfg.n_shards > 1``), stable ids ``0..n_docs-1``. With ``root``,
        the generation directory and ``CURRENT`` are committed at once."""
        device = resolve_device(device)
        base, host = _build_base(fwd, cfg, device)
        m = cls(cfg, base, base_fwd=fwd, base_ids=np.arange(fwd.n_docs, dtype=np.int64),
                root=root)
        if m.root is not None:
            m._write_generation(base, host, fwd, m.base_ids, m.generation)
            _atomic_write(m.root / CURRENT_FILE, GEN_DIR_FMT.format(m.generation))
        return m

    # -- id bookkeeping --------------------------------------------------
    @property
    def n_docs(self) -> int:
        """Id-space size (the merge sentinel), NOT the live count."""
        return self.next_id

    @property
    def n_live(self) -> int:
        return int((~self.base_dead).sum()) + sum(int((~s.dead).sum()) for s in self.segments)

    def live_ids(self) -> np.ndarray:
        """Sorted stable ids of every live document."""
        parts = [self.base_ids[~self.base_dead]] + [s.ids[~s.dead] for s in self.segments]
        return np.sort(np.concatenate(parts))

    def live_corpus(self) -> Tuple[ForwardIndex, np.ndarray]:
        """(live rows in stable-id order, their sorted stable ids) — the
        corpus an oracle ``Retriever.build`` sees: oracle position ``r``
        is stable id ``live_ids[r]``."""
        big = ForwardIndex.concat([self.base_fwd] + [s.fwd for s in self.segments])
        all_ids = np.concatenate([self.base_ids] + [s.ids for s in self.segments])
        all_dead = np.concatenate([self.base_dead] + [s.dead for s in self.segments])
        live_pos = np.flatnonzero(~all_dead)
        live = all_ids[live_pos]
        order = np.argsort(live, kind="stable")
        return big.select(live_pos[order]), live[order]

    def _find_live(self, doc_id: int):
        """→ ("seg", index, row) | ("base", None, row) | None — where the
        live copy of ``doc_id`` is (at most one across parts)."""
        for si in range(len(self.segments) - 1, -1, -1):
            s = self.segments[si]
            pos = np.flatnonzero((s.ids == doc_id) & ~s.dead)
            if pos.size:
                return ("seg", si, int(pos[0]))
        pos = np.flatnonzero((self.base_ids == doc_id) & ~self.base_dead)
        if pos.size:
            return ("base", None, int(pos[0]))
        return None

    # -- mutation --------------------------------------------------------
    def insert(self, docs, ids=None, *, _crash_before_commit: bool = False) -> np.ndarray:
        """Insert a batch of documents as ONE new delta segment.

        ``docs`` is a ``ForwardIndex`` or an iterable of ``(components,
        values)`` pairs; ``ids`` assigns explicit stable ids (fresh by
        default) — reusing an id needs its previous copy deleted first
        (or ``update``). Returns the assigned stable ids. Commit protocol:
        the segment artifact is written whole, then ``state.json`` flips
        atomically; a crash between leaves an orphan directory that open
        ignores and a retry reclaims."""
        with self._write_lock:
            return self._insert_locked(docs, ids, _crash_before_commit)

    def _insert_locked(self, docs, ids, _crash_before_commit: bool) -> np.ndarray:
        seg_fwd = (
            docs if isinstance(docs, ForwardIndex)
            else ForwardIndex.from_docs(docs, self.dim, self.value_format)
        )
        if seg_fwd.dim != self.dim:
            raise ValueError(f"segment dim {seg_fwd.dim} != index {self.dim}")
        if seg_fwd.value_format.name != self.value_format:
            raise ValueError(
                f"segment value_format {seg_fwd.value_format.name!r} != index "
                f"{self.value_format!r}"
            )
        n = seg_fwd.n_docs
        if n == 0:
            raise ValueError("cannot insert an empty segment")
        if ids is None:
            ids = np.arange(self.next_id, self.next_id + n, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64).reshape(-1)
            if len(ids) != n:
                raise ValueError(f"{n} docs but {len(ids)} ids")
            if len(np.unique(ids)) != n or (ids < 0).any():
                raise ValueError("ids must be unique and ≥ 0")
            for i in ids:
                if self._find_live(int(i)) is not None:
                    raise ValueError(
                        f"doc id {int(i)} is still live; delete it first (or use update)"
                    )
        cfg1 = self.cfg.replace(n_shards=1)
        host = self.impl.build_arrays(seg_fwd, cfg1)
        name = SEGMENT_DIR_FMT.format(len(self.segments))
        if self.root is not None:
            sdir = self._gen_dir() / name
            if sdir.exists():  # orphan of a crashed earlier attempt
                shutil.rmtree(sdir)
            api.write_artifact(
                sdir,
                api.manifest_dict(cfg1, host, n_docs=n, dim=self.dim,
                                  value_scale=self.value_scale,
                                  value_format=self.value_format),
                host, compress=False,
            )
            np.savez(sdir / STORE_FILE, **_store_dict(seg_fwd, ids))
        if _crash_before_commit:
            raise InjectedCrash(f"crash before committing {name}")
        arrays = _place(host, self.device)
        with self._state_lock:
            self.segments.append(
                DeltaSegment(ids=ids, fwd=seg_fwd, arrays=arrays, dead=np.zeros(n, bool))
            )
            self.next_id = max(self.next_id, int(ids.max()) + 1)
            self._commit_memory()
        self._write_state()
        self._release_retired()
        return ids

    def delete(self, ids) -> None:
        """Tombstone the live copy of every given stable id (KeyError if
        one is not live). Deletes touch only ``state.json``; the segment
        and base payloads stay immutable."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._write_lock:
            with self._state_lock:
                for i in ids:
                    hit = self._find_live(int(i))
                    if hit is None:
                        raise KeyError(f"doc id {int(i)} is not live")
                    kind, si, row = hit
                    if kind == "seg":
                        self.segments[si].dead[row] = True
                    else:
                        self.base_dead[row] = True
                self._commit_memory()
            self._write_state()

    def update(self, docs, ids) -> np.ndarray:
        """Update in place: tombstone the live copies, re-insert the new
        rows as a delta segment under the SAME stable ids."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._write_lock:
            self.delete(ids)
            return self.insert(docs, ids=ids)

    def _commit_memory(self) -> None:
        """In-memory commit of a mutation: epoch bump and part-list
        invalidation, under ``_state_lock`` (callers hold it), so a
        concurrent reader sees the old or the new state, never a mix."""
        self.epoch += 1
        self._handles = None

    # -- merge -----------------------------------------------------------
    def merge(self, *, crash_before_flip: bool = False, background: bool = False):
        """Fold every segment and tombstone into a fresh base and commit
        by the atomic generation flip: write ``generation_{g+1}/`` whole
        (base artifact, row store, ``state.json``), then repoint
        ``CURRENT``. A crash before the flip (``crash_before_flip``
        injects one) leaves the previous generation untouched and
        loadable; in-memory state changes only after the flip. Returns
        the new base.

        ``background=True`` runs the merge on a worker thread and returns
        a ``MergeHandle`` at once: queries keep serving generation N (the
        merge does not change the live corpus), other writers block on
        the write lock, and the commit swaps fields under ``_state_lock``
        (timed into ``blocked_swap_us``). A background merge also builds
        the new base's part wrapper and captures its bucket plans on the
        worker before the flip (module docstring), so the first query
        after it replays instead of capturing."""
        if not background:
            return self._merge_sync(crash_before_flip)
        index = None
        if self.device.type == "cuda":  # the caller's device: a new thread starts on 0
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()

        def run():
            if index is not None:
                torch.cuda.set_device(index)
            return self._merge_sync(crash_before_flip, prewarm=True)

        return MergeHandle(run)

    def _merge_sync(self, crash_before_flip: bool, *, prewarm: bool = False):
        with self._write_lock:
            t0 = time.perf_counter()
            merged, new_ids = self.live_corpus()
            if merged.n_docs == 0:
                raise ValueError("merge would produce an empty corpus")
            cfg = self.cfg
            if cfg.n_shards > merged.n_docs:
                # every shard must own ≥ 1 doc: a shrunken corpus takes
                # fewer shards rather than failing the merge
                cfg = cfg.replace(n_shards=max(1, merged.n_docs))
            new_base, host = _build_base(merged, cfg, self.device)
            next_gen = self.generation + 1
            if self.root is not None:
                gdir = self.root / GEN_DIR_FMT.format(next_gen)
                if gdir.exists():  # orphan of a crashed earlier merge
                    shutil.rmtree(gdir)
                self._write_generation(new_base, host, merged, new_ids, next_gen)
                if crash_before_flip:
                    raise InjectedCrash(
                        f"crash before flipping CURRENT to generation {next_gen}")
                _atomic_write(self.root / CURRENT_FILE, GEN_DIR_FMT.format(next_gen))
            elif crash_before_flip:
                raise InjectedCrash("crash before the in-memory generation flip")
            new_wrapper = None
            if prewarm and not isinstance(new_base, ShardedRetriever):
                # generation N+1's serving plans, made and captured here on
                # the worker before the flip
                new_wrapper = self._part_retriever(
                    cfg, new_base.arrays, new_base.n_docs, min(new_base.n_docs, cfg.k), "base")
                with CUDA_EXCLUSIVE:
                    for b in self.plans.buckets:
                        new_wrapper.plans.get(b).warm(self.dim, capture_error_mode="thread_local")
            # ---- memory commit, after the flip only: plain assignments
            # under the state lock, so a reader sees generation N or N+1
            # whole ----
            new_dead = np.zeros(len(new_ids), bool)
            with self._state_lock:
                # timed inside the lock: the only window a reader can be
                # blocked by the commit
                t_swap = time.perf_counter()
                self._retire_parts()
                if new_wrapper is not None:
                    self._wrappers["base"] = new_wrapper
                self.cfg = cfg
                self.base = new_base
                self.base_fwd = merged
                self.base_ids = new_ids
                self.base_dead = new_dead
                self.segments = []
                self.generation = next_gen
                self.epoch += 1
                self._handles = None
                self.blocked_swap_us += (time.perf_counter() - t_swap) * 1e6
            self.merge_wall_us += (time.perf_counter() - t0) * 1e6
        self._release_retired()
        return new_base

    def _retire(self, wrapper: Retriever) -> None:
        """Count a part wrapper's plan creations and queue it for release
        (``_release_retired``). Callers hold ``_state_lock``."""
        self._retired_compiles += wrapper.plans.compiles
        self._retired.append(wrapper)

    def _retire_parts(self) -> None:
        """Retire every part (the flip)."""
        for r in self._wrappers.values():
            self._retire(r)
        self._wrappers.clear()
        if isinstance(self.base, ShardedRetriever):
            self._retired_compiles += self.base.plans.compiles

    def _release_retired(self) -> None:
        """Release the retired part wrappers — their graphs and graph
        pools — once no dispatch holds a snapshot of the parts, under
        ``CUDA_EXCLUSIVE`` so that no capture runs beside the
        destruction, and after the device has finished their last
        replays (a freed pool block is reused at once)."""
        with self._state_lock:
            if self._inflight or not self._retired:
                return
            dropped, self._retired = self._retired, []
        with CUDA_EXCLUSIVE:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            del dropped

    # -- persistence -----------------------------------------------------
    def _gen_dir(self) -> pathlib.Path:
        return self.root / GEN_DIR_FMT.format(self.generation)

    def _write_generation(self, base, host, fwd: ForwardIndex, ids: np.ndarray,
                          generation: int) -> None:
        gdir = self.root / GEN_DIR_FMT.format(generation)
        gdir.mkdir(parents=True, exist_ok=True)
        if host is None:  # a sharded base keeps its shard arrays on the host
            base.save(gdir / "base", compress=False)
        else:  # written from the host arrays: no device read on a worker thread
            api.write_artifact(
                gdir / "base",
                api.manifest_dict(base.cfg, host, n_docs=base.n_docs, dim=base.dim,
                                  value_scale=base.value_scale,
                                  value_format=base.value_format),
                host, compress=False,
            )
        np.savez(gdir / STORE_FILE, **_store_dict(fwd, ids))
        self._write_state(gdir=gdir, generation=generation, segments=[], dead={"base": []},
                          epoch=self.epoch + (generation != self.generation))

    def _write_state(self, *, gdir: Optional[pathlib.Path] = None,
                     generation: Optional[int] = None,
                     segments: Optional[list] = None,
                     dead: Optional[dict] = None,
                     epoch: Optional[int] = None) -> None:
        if self.root is None:
            return
        if gdir is None:
            gdir = self._gen_dir()
        if segments is None:
            segments = [SEGMENT_DIR_FMT.format(i) for i in range(len(self.segments))]
            dead = {"base": np.flatnonzero(self.base_dead).tolist()}
            for i, s in enumerate(self.segments):
                dead[SEGMENT_DIR_FMT.format(i)] = np.flatnonzero(s.dead).tolist()
        state = {
            "format": _MUTABLE_FORMAT,
            "version": MUTABLE_VERSION,
            "generation": self.generation if generation is None else generation,
            "epoch": self.epoch if epoch is None else epoch,
            "next_id": self.next_id,
            "segments": segments,
            "dead": dead,
        }
        _atomic_write(gdir / STATE_FILE, json.dumps(state, indent=1, sort_keys=True))

    # -- fan-out ---------------------------------------------------------
    def _part_retriever(self, cfg: RetrieverConfig, arrays, n_local: int, k_part: int,
                        label: str) -> Retriever:
        return Retriever(cfg.replace(n_shards=1, k=k_part), arrays, n_docs=n_local,
                         dim=self.dim, value_scale=self.value_scale,
                         value_format=self.value_format, device=self.device,
                         shard=f"mut:{label}")

    def _wrapper(self, key, arrays, n_local: int, k_part: int, label: str) -> Retriever:
        """The part's serving wrapper at candidate budget ``k_part``,
        reused while the budget holds; a budget change (the part's
        tombstone count moved) retires the old wrapper."""
        cur = self._wrappers.get(key)
        if cur is not None and cur.cfg.k == k_part:
            return cur
        if cur is not None:
            self._retire(cur)
        r = self._part_retriever(self.cfg, arrays, n_local, k_part, label)
        self._wrappers[key] = r
        return r

    def _idmap(self, ids: np.ndarray, dead: np.ndarray) -> torch.Tensor:
        m = np.full(len(ids) + 1, -1, np.int32)
        m[:-1] = np.where(dead, -1, ids).astype(np.int32)
        return torch.from_numpy(m).to(self.device)

    def _parts(self) -> List[_Part]:
        """The current fan-out part list, built (and memoized) under
        ``_state_lock``: a reader gets a snapshot whose parts stay valid
        if a merge commits mid-dispatch (the merge does not change the
        live corpus, so in-flight queries against the old parts stay
        oracle-correct)."""
        with self._state_lock:
            if self._handles is not None:
                return self._handles
            k = self.cfg.k
            parts: List[_Part] = []
            n_base = len(self.base_ids)
            if isinstance(self.base, ShardedRetriever):
                # the sharded base masks its own tombstones in its shard
                # merge (uniform tombstone budgets) and returns its top-k
                # LIVE candidates: no budget extension here
                self.base.set_tombstones(np.flatnonzero(self.base_dead))
                parts.append(_Part(self.base.plans, self._idmap(self.base_ids, self.base_dead),
                                   n_base, "base"))
            else:
                k_b = min(n_base, k + int(self.base_dead.sum()))
                r = self._wrapper("base", self.base.arrays, n_base, k_b, "base")
                parts.append(_Part(r.plans, self._idmap(self.base_ids, self.base_dead),
                                   n_base, "base"))
            for i, s in enumerate(self.segments):
                k_s = min(s.n_docs, k + int(s.dead.sum()))
                r = self._wrapper(("seg", i), s.arrays, s.n_docs, k_s, f"seg{i}")
                parts.append(_Part(r.plans, self._idmap(s.ids, s.dead), s.n_docs, f"seg{i}"))
            self._handles = parts
            return parts

    def _part_compiles(self) -> int:
        with self._state_lock:
            n = self._retired_compiles + sum(r.plans.compiles for r in self._wrappers.values())
            if isinstance(self.base, ShardedRetriever):
                n += self.base.plans.compiles
            return n

    def _dispatch(self, Q: torch.Tensor):
        """One padded ``[bucket, dim]`` batch → the merged stable-id top-k
        over base + segments and a ``(label, launches, stages)`` record
        of each part plan it ran (the ``FacadePlan`` contract). Parts and
        the id-space sentinel are taken together, so a merge committing
        mid-dispatch cannot mix generations within one batch."""
        with self._state_lock:
            parts = self._parts()
            sentinel = self.next_id
            self._inflight += 1
        try:
            return self._fan_out(parts, Q.to(self.device), sentinel)
        finally:
            del parts  # the snapshot goes before the release below
            with self._state_lock:
                self._inflight -= 1
            self._release_retired()

    def _fan_out(self, parts: List[_Part], Q: torch.Tensor, sentinel: int):
        """Per-part search, id map to stable ids (dead rows and sentinels
        → -1 at -inf), dedupe merge keyed on stable id: ties go to the
        lower stable id, as the oracle's positional tie-break over its
        stable-id-ordered corpus."""
        bucket = int(Q.shape[0])
        flat_i, flat_s, ran = [], [], []
        for p in parts:
            plan = p.plans.get(p.plans.bucket_for(bucket))
            ids, scores = plan(Q)
            ran.append((p.label, plan.launches, plan.stages))
            valid = (ids >= 0) & (ids <= p.n_local)
            gids = torch.take(p.idmap, ids.clamp(0, p.n_local).long())
            gids = torch.where(valid, gids, torch.full_like(gids, -1))
            flat_i.append(gids)
            flat_s.append(scores.masked_fill(gids < 0, float("-inf")))
        flat_i = torch.cat(flat_i, dim=1)
        flat_s = torch.cat(flat_s, dim=1)
        if flat_i.shape[1] < self.cfg.k:
            pad = self.cfg.k - flat_i.shape[1]
            flat_i = torch.cat([flat_i, flat_i.new_full((bucket, pad), -1)], dim=1)
            flat_s = torch.cat([flat_s, flat_s.new_full((bucket, pad), float("-inf"))], dim=1)
        ids, scores = api.merge_topk(flat_i, flat_s, self.cfg.k, dedupe=True,
                                     n_docs_global=sentinel)
        return ids, scores, ran

    # -- serving (the Retriever surface) --------------------------------
    def make_plans(self, buckets) -> MutablePlanCache:
        return MutablePlanCache(self, buckets)

    @torch.inference_mode()
    def search(self, Q, k: int | None = None):
        """[nq, dim] queries → (stable ids i32 [nq, k], scores f32 [nq,
        k]) on the device; on the CPU byte-identical to the oracle over
        the live corpus under exhaustive engine budgets (oracle position
        ``r`` ↔ stable id ``live_ids()[r]``)."""
        if k is not None and k > self.cfg.k:
            raise ValueError(
                f"k={k} exceeds the static cfg.k={self.cfg.k}; rebuild with a larger cfg.k")
        Q = torch.as_tensor(Q, dtype=torch.float32)
        if Q.dim() != 2 or Q.shape[1] != self.dim:
            raise ValueError(f"queries must be [nq, {self.dim}], got {tuple(Q.shape)}")
        ids, scores = self.plans.search(Q)
        if k is None or k == self.cfg.k:
            return ids, scores
        return ids[:, :k], scores[:, :k]

    def pipeline(self, **kw) -> serve_pipeline.Pipeline:
        if kw:
            return serve_pipeline.Pipeline(self, **kw)
        if self._pipeline is None:
            self._pipeline = serve_pipeline.Pipeline(self)
        return self._pipeline

    def search_batch(self, Q):
        return self.pipeline().search_batch(Q)


def _build_base(fwd: ForwardIndex, cfg: RetrieverConfig, device: torch.device):
    """(base retriever on ``device``, its host arrays) — the arrays are
    None for a sharded base, whose shards stay on the host until
    admitted. The placement holds ``CUDA_EXCLUSIVE``."""
    if cfg.n_shards > 1:
        return ShardedRetriever.build(fwd, cfg, device=device), None
    host = api.get_engine(cfg.engine).build_arrays(fwd, cfg)
    base = Retriever(cfg, _place(host, device), n_docs=fwd.n_docs, dim=fwd.dim,
                     value_scale=float(fwd.value_format.scale),
                     value_format=fwd.value_format.name, device=device)
    return base, host


def open_mutable(root, *, device=None) -> MutableRetriever:
    """Open a mutable root at its committed generation on ``device``:
    ``CURRENT`` → ``state.json`` → base artifact + row store + every
    listed segment (+ tombstone masks). Orphan directories of crashed
    commits are ignored; a missing or partly written generation raises
    ``ArtifactError`` rather than serving partial state."""
    root = pathlib.Path(root)
    device = resolve_device(device)
    cur = root / CURRENT_FILE
    if not cur.is_file():
        raise ArtifactError(f"no {CURRENT_FILE} under {root}")
    gen_name = cur.read_text(encoding="utf-8").strip()
    gdir = root / gen_name
    sf = gdir / STATE_FILE
    if not sf.is_file():
        raise ArtifactError(
            f"{cur} points at {gen_name!r} but {sf} is missing — the committed "
            f"generation is gone; restore it or rebuild"
        )
    try:
        state = json.loads(sf.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        raise ArtifactError(f"corrupt state at {sf}: {e}") from None
    if state.get("format") != _MUTABLE_FORMAT:
        raise ArtifactError(
            f"{sf} is not a {_MUTABLE_FORMAT} state (format={state.get('format')!r})")
    if state.get("version") != MUTABLE_VERSION:
        raise ArtifactError(
            f"mutable state version {state.get('version')!r} at {sf} incompatible with "
            f"this build (expected {MUTABLE_VERSION})"
        )
    base = api.open_retriever(gdir / "base", device=device)
    base_fwd, base_ids = _load_store(gdir / STORE_FILE, base.dim, base.value_format)
    dead_map = state.get("dead", {})

    def _mask(name: str, n: int) -> np.ndarray:
        m = np.zeros(n, bool)
        idx = np.asarray(dead_map.get(name, []), np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ArtifactError(f"dead row index out of range for {name!r} at {sf}")
        m[idx] = True
        return m

    segments: List[DeltaSegment] = []
    for name in state.get("segments", []):
        seg_r = api.open_retriever(gdir / name, device=device)
        seg_fwd, seg_ids = _load_store(gdir / name / STORE_FILE, base.dim, base.value_format)
        if seg_r.n_docs != len(seg_ids):
            raise ArtifactError(
                f"segment {name!r} artifact holds {seg_r.n_docs} docs but its store holds "
                f"{len(seg_ids)}"
            )
        segments.append(DeltaSegment(ids=seg_ids, fwd=seg_fwd, arrays=seg_r.arrays,
                                     dead=_mask(name, len(seg_ids))))
    return MutableRetriever(
        base.cfg, base,
        base_fwd=base_fwd, base_ids=base_ids,
        base_dead=_mask("base", len(base_ids)),
        segments=segments,
        next_id=int(state["next_id"]),
        generation=int(state["generation"]),
        epoch=int(state["epoch"]),
        root=root,
    )
