"""Sharded artifact tree and out-of-core serving on one device — the
port of ``repro/serve/sharded.py`` (DESIGN.md §9, §11), its sequential
path.

* ``Retriever.build(fwd, cfg)`` with ``cfg.n_shards > 1`` partitions
  ``[0, n_docs)`` into contiguous doc ranges (``shard_ranges``: balanced,
  ragged last shard) and builds one self-contained sub-index per range
  with shard-local ids (every engine's ``build_shard``), returned as a
  ``ShardedRetriever`` whose shard arrays stay on the host;
* ``save`` writes one ordinary artifact directory per shard (stored
  uncompressed) plus a top-level shard manifest — the reference's
  format, so a tree saved by either package opens in the other;
* ``open_retriever`` on a tree memory-maps every shard's arrays
  (``mmap_npz``): opening costs the metadata, and no array byte is read
  until a search admits the shard;
* a search runs the shards one after another on the retriever's device
  and merges their top-k with the sentinel-safe ``api.merge_topk``
  (dedupe iff the engine asks). At most ``max_resident`` shards are
  resident — a per-shard ``Retriever`` with its device arrays and its
  own plan cache, plan keys ``"<s>/<S>"``; admitting one more evicts the
  least recently used shard with its arrays, graphs and graph pool.
  Re-admission recaptures, and ``plans.compiles`` keeps counting the
  evicted shards' plans.

Admission on the card: the shard's arrays (numpy or ``np.memmap``) are
copied once into pinned host memory (the page-in), then to the device
with ``non_blocking`` copies on the retriever's own copy stream, whose
completion the copying thread waits for; the serving thread then marks
the tensors used on its own stream (``record_stream``), so the caching
allocator holds their blocks until that stream's work on them is done.
The search plan of the batch's bucket is captured (one CUDA graph) on
the serving thread when the shard first serves that bucket.

Prefetch (DESIGN.md §11): while shard ``s`` is admitted and scored, the
rotation stages shard ``(s + 1) % S`` on one worker thread shared by the
process — page-in and host→device copy, no capture — so the next
admission finds its arrays on the device (``prefetch_hits``) instead of
copying on the critical path (``prefetch_misses``). The worker takes
``pipeline.CUDA_EXCLUSIVE`` around its CUDA calls (pinned allocation,
device allocation and copy, the wait for the copy), which every capture
holds, because a capture in the default mode forbids those calls on
every thread. A staging failure re-raises on the serving thread when
the staged shard is consumed or retired; nothing is rebuilt in its
place.

The mesh fan-out (``use_mesh``): where a process group of at least
``n_shards`` ranks is initialised (one process per device; every rank
builds or opens the same tree and runs the same searches), rank ``s``
of ``dist.sharding.index_mesh`` keeps only shard ``s`` resident, runs
its plan on the padded batch, and the ranks all-gather their ``[nq,
k_local]`` results and merge them (``api.ShardedSearch.merge_local``),
so every rank returns the global top-k. Tombstones ride in the shard's
id map (a dead slot maps to the out-of-corpus sentinel ``n_docs``) and
``k_local`` is the uniform ``tombstone_budget``; a shard whose own
budget is smaller sentinel-pads up to it, so the mesh answers the
sequential rotation's bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import struct
import threading
import time
import zipfile
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..core import layout
from ..core import values as value_codecs
from ..core.forward_index import ForwardIndex
from ..dist.sharding import axis_index, index_mesh, tombstone_budget
from ..kernels import modes
from . import api
from . import pipeline as serve_pipeline
from .api import ArtifactError, Retriever, RetrieverConfig

__all__ = [
    "SHARD_DIR_FMT",
    "shard_ranges",
    "tombstone_budget",
    "mmap_npz",
    "Shard",
    "ShardedPlanCache",
    "ShardedRetriever",
]

#: on-disk name of shard ``s`` inside a sharded artifact tree
SHARD_DIR_FMT = "shard_{:04d}"

# one staging worker shared by every ShardedRetriever in the process,
# made on first use (tests build hundreds of retrievers)
_PREFETCH_POOL: Optional[ThreadPoolExecutor] = None
_PREFETCH_POOL_LOCK = threading.Lock()


def _prefetch_pool() -> ThreadPoolExecutor:
    global _PREFETCH_POOL
    with _PREFETCH_POOL_LOCK:
        if _PREFETCH_POOL is None:
            _PREFETCH_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="shard-prefetch")
        return _PREFETCH_POOL


def shard_ranges(n_docs: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous doc ranges tiling ``[0, n_docs)``, balanced within one
    doc (the ``n_docs % n_shards`` leading shards get one more, so the
    last shard is the ragged one). Every shard owns at least one
    document: an empty shard is rejected here, not at query time."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be ≥ 1, got {n_shards}")
    if n_shards > n_docs:
        raise ValueError(
            f"n_shards={n_shards} exceeds n_docs={n_docs}: every shard must own at least "
            f"one document — lower n_shards or grow the collection"
        )
    base, rem = divmod(n_docs, n_shards)
    bounds = np.cumsum([0] + [base + (1 if s < rem else 0) for s in range(n_shards)])
    return [(int(bounds[s]), int(bounds[s + 1])) for s in range(n_shards)]


def mmap_npz(path) -> Dict[str, np.ndarray]:
    """Memory-map every member of an uncompressed ``.npz`` in place.

    ``np.load(..., mmap_mode="r")`` ignores ``mmap_mode`` for ``.npz``
    archives, so this reads the zip structure itself: ``np.savez``
    members are stored raw, the ``.npy`` bytes at a fixed offset (local
    file header of 30 bytes + file name + extra field, then the npy
    header, then the data). Each member becomes an ``np.memmap`` at that
    offset. Zero-length members are ordinary arrays (an empty range
    cannot be mapped). Compressed members, truncated archives and
    malformed npy headers raise ``ArtifactError``."""
    path = pathlib.Path(path)
    try:
        zf = zipfile.ZipFile(path)
    except FileNotFoundError:
        raise ArtifactError(f"missing shard payload {path}") from None
    except (zipfile.BadZipFile, OSError) as e:
        raise ArtifactError(
            f"corrupt npz at {path} ({e}): the payload is unreadable — likely a truncated or "
            f"partial write; rebuild the shard"
        ) from None
    out: Dict[str, np.ndarray] = {}
    file_size = path.stat().st_size
    with zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ArtifactError(
                    f"npz member {info.filename!r} in {path} is compressed (type "
                    f"{info.compress_type}); sharded artifacts must be written with "
                    f"``compress=False`` (np.savez, not savez_compressed) to be "
                    f"memory-mappable — re-save the artifact"
                )
            f.seek(info.header_offset)
            hdr = f.read(30)
            if len(hdr) < 30 or hdr[:4] != b"PK\x03\x04":
                raise ArtifactError(
                    f"truncated npz at {path}: local header of member {info.filename!r} is "
                    f"incomplete; rebuild the shard"
                )
            fn_len, extra_len = struct.unpack("<HH", hdr[26:30])
            f.seek(info.header_offset + 30 + fn_len + extra_len)
            try:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
                else:
                    raise ValueError(f"unsupported npy format version {version}")
            except (ValueError, OSError) as e:
                raise ArtifactError(
                    f"corrupt npy member {info.filename!r} in {path}: {e}"
                ) from None
            data_off = f.tell()
            nbytes = int(dtype.itemsize * np.prod(shape, dtype=np.int64))
            if data_off + nbytes > file_size:
                raise ArtifactError(
                    f"truncated npz at {path}: member {info.filename!r} needs {nbytes} bytes "
                    f"at offset {data_off} but the file holds {file_size} — partial write or "
                    f"corruption; rebuild the shard"
                )
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if nbytes == 0:
                out[name] = np.zeros(shape, dtype=dtype)
            else:
                out[name] = np.memmap(path, dtype=dtype, mode="r", offset=data_off,
                                      shape=shape, order="F" if fortran else "C")
    return out


@dataclasses.dataclass
class Shard:
    """One shard of the tree: its global doc range and its host arrays —
    numpy after ``build``, ``np.memmap`` views after ``open``."""

    doc_lo: int
    doc_hi: int
    arrays: Mapping[str, np.ndarray]

    @property
    def n_docs(self) -> int:
        return self.doc_hi - self.doc_lo

    def disk_bytes(self) -> int:
        return sum(int(np.asarray(a).nbytes) for a in self.arrays.values())


def _nbytes(arrays: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in arrays.values())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class ShardedPlanCache:
    """The plan surface of a ``ShardedRetriever``: the ``buckets`` /
    ``bucket_for`` / ``get`` / ``created`` / ``search`` / ``compiles``
    contract of ``pipeline.PlanCache``, so the scheduler runs over shards
    unchanged. Each bucket's plan is a ``pipeline.FacadePlan`` keyed
    ``"*/<S>"`` that pads the batch and runs the shard rotation, in which
    every shard runs its own plan. ``compiles`` sums the resident shards'
    plan creations and everything the evicted shards had created."""

    def __init__(self, retriever: "ShardedRetriever", buckets: Optional[Sequence[int]] = None):
        cfg = retriever.cfg
        self.retriever = retriever
        self.buckets = serve_pipeline.plan_buckets(cfg.batch_size, buckets)
        self.k = cfg.k
        self.device = retriever.device
        self._plans: Dict[int, serve_pipeline.FacadePlan] = {}
        self._lock = threading.Lock()

    # the monolithic cache's covering-bucket policy
    bucket_for = serve_pipeline.PlanCache.bucket_for

    @property
    def compiles(self) -> int:
        r = self.retriever
        with r._admit_lock:
            return r._evicted_compiles + sum(sr.plans.compiles for sr in r._resident.values())

    def get(self, bucket: int) -> serve_pipeline.FacadePlan:
        with self._lock:
            plan = self._plans.get(bucket)
            if plan is None:
                cfg = self.retriever.cfg
                key = serve_pipeline.PlanKey(
                    cfg.engine, cfg.codec, cfg.backend, modes.check_backend(cfg.backend),
                    cfg.k, bucket, shard=f"*/{cfg.n_shards}", vq=cfg.vq,
                )
                plan = serve_pipeline.FacadePlan(key, self.retriever._dispatch_shards)
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


class ShardedRetriever:
    """Serving handle over a sharded index: the ``search`` / ``pipeline``
    / ``search_batch`` / ``save`` surface of ``Retriever``, every search
    running the shards in turn on ``device`` and merging with
    ``api.merge_topk``.

    Construct with ``Retriever.build(fwd, cfg)`` at ``n_shards > 1`` or
    ``open_retriever(path)`` on a saved tree. ``max_resident`` bounds the
    shards resident at once (default: all; 1 is strict out-of-core
    round-robin); ``prefetch`` stages the next shard on the worker;
    ``use_mesh`` keeps the reference's three values: None serves over
    the mesh when a process group of at least ``n_shards`` ranks is
    initialised, else sequentially (so a plain single process serves as
    the rotation); False always sequentially; True over the mesh, and
    raises ``ValueError`` where there is no such group. A rank past
    ``n_shards`` holds no shard: its mesh search raises."""

    def __init__(
        self,
        cfg: RetrieverConfig,
        shards: Sequence[Shard],
        *,
        dim: int,
        value_scale: float,
        value_format: str,
        max_resident: int | None = None,
        device=None,
    ):
        if cfg.n_shards != len(shards):
            raise ValueError(f"cfg.n_shards={cfg.n_shards} but {len(shards)} shards given")
        self.impl = api.get_engine(cfg.engine)
        layout.get_layout(cfg.codec)
        value_codecs.check_vq(cfg.vq)
        modes.check_backend(cfg.backend)
        self.impl.params(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # named: the staging worker is another thread, whose current
            # device starts at 0 (a rank of a mesh serves on its own card)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.shards = list(shards)
        self.n_docs = self.shards[-1].doc_hi
        self.dim = int(dim)
        self.value_scale = float(value_scale)
        self.value_format = value_format
        self.max_resident = cfg.n_shards if max_resident is None else max(1, int(max_resident))
        self.use_mesh: bool | None = None
        self._index_mesh = None  # the DeviceMesh, made once (collectively)
        #: (ShardedSearch, this rank's shard, its id map on the device),
        #: rebuilt when the tombstone set changes
        self._mesh_state: Optional[tuple] = None
        self._resident: "OrderedDict[int, Retriever]" = OrderedDict()
        self._evicted_compiles = 0
        self.evictions = 0
        self.peak_resident_bytes = 0
        #: live tombstones: sorted global doc ids masked to -inf in the merge
        self._tombstones = np.zeros(0, np.int64)
        self._tomb_mask: Optional[torch.Tensor] = None  # bool [n_docs + 1] when non-empty
        self._shard_tombs = [0] * cfg.n_shards
        # per-shard candidate budget and sub-config, recomputed only when
        # the tombstone set changes
        self._shard_k = [min(sh.n_docs, cfg.k) for sh in self.shards]
        self._shard_cfg = [cfg.replace(n_shards=1, k=b) for b in self._shard_k]
        self.prefetch = True
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self._staged: Optional[Tuple[int, "Future[Retriever]"]] = None
        # guards _resident, _staged and the counters: scheduler threads and
        # direct callers race the staging worker's hand-off
        self._admit_lock = threading.RLock()
        #: seconds of admission work, summed: per shard build (staged or on
        #: the critical path) the page-in (pinned allocation and host
        #: arrays → pinned memory) and the host→device copy; the captures
        #: of per-shard plans; and ``admit``, what admissions cost the
        #: serving thread (a build, or the wait for a staged one, and the
        #: eviction)
        self.admission_s = {"page_in": 0.0, "h2d": 0.0, "capture": 0.0, "admit": 0.0}
        #: shard builds (page-in + copy), staged or on the critical path
        self.builds = 0
        self._stats_lock = threading.Lock()  # never held while another lock is taken
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self.plans = ShardedPlanCache(self)
        self._pipeline: serve_pipeline.Pipeline | None = None

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, fwd: ForwardIndex, cfg: RetrieverConfig, device=None) -> "ShardedRetriever":
        """Partition ``[0, n_docs)`` into ``cfg.n_shards`` contiguous
        ranges and build one self-contained sub-index per range
        (shard-local ids) with the engine's ``build_shard``."""
        device = resolve_device(device)
        impl = api.get_engine(cfg.engine)
        layout.get_layout(cfg.codec)
        impl.params(cfg)
        shards = [Shard(lo, hi, impl.build_shard(fwd, cfg, lo, hi))
                  for lo, hi in shard_ranges(fwd.n_docs, cfg.n_shards)]
        return cls(cfg, shards, dim=fwd.dim, value_scale=float(fwd.value_format.scale),
                   value_format=fwd.value_format.name, device=device)

    # -- tombstones -------------------------------------------------------
    def set_tombstones(self, ids) -> None:
        """Install the live tombstone set: global doc ids whose candidates
        the merge masks to -inf. Every shard's candidate budget grows by
        the total tombstone count (``tombstone_budget``, uniform across
        shards as in the reference). Resident and staged shards whose
        budget changed are retired — their plans are stale —
        with their plan creations counted; re-admission recaptures."""
        ids = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
        if ids.size and (int(ids[0]) < 0 or int(ids[-1]) >= self.n_docs):
            raise ValueError(f"tombstone ids outside [0, {self.n_docs}): [{ids[0]}, {ids[-1]}]")
        bounds = [sh.doc_lo for sh in self.shards] + [self.n_docs]
        new_tombs = [int(c) for c in np.diff(np.searchsorted(ids, bounds))]
        new_k = [tombstone_budget(self.cfg.k, sh.n_docs, int(ids.size)) for sh in self.shards]
        with self._admit_lock:
            for s in list(self._resident):
                if new_k[s] != self._shard_k[s]:
                    old = self._resident.pop(s)
                    self._evicted_compiles += old.plans.compiles
                    self.evictions += 1
            st = self._staged
            if st is not None and new_k[st[0]] != self._shard_k[st[0]]:
                self._staged = None  # the staged build carries the old budget
                self._evicted_compiles += st[1].result().plans.compiles
            self._shard_tombs = new_tombs
            self._shard_k = new_k
            self._shard_cfg = [self.cfg.replace(n_shards=1, k=b) for b in new_k]
            self._tombstones = ids
            self._mesh_state = None  # the id map and k_local follow the set
            if ids.size:
                # one slot past the corpus: the sentinel id n_docs reads False
                mask = torch.zeros(self.n_docs + 1, dtype=torch.bool)
                mask[torch.from_numpy(ids)] = True
                self._tomb_mask = mask.to(self.device)
            else:
                self._tomb_mask = None

    # -- residency --------------------------------------------------------
    def _place(self, arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A shard's host arrays → tensors on the device, each byte read
        from the host once. On the card: page-in into pinned memory, then
        ``non_blocking`` copies on the copy stream, waited for before the
        return. Safe off the serving thread (see the module docstring)."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            out = {k: api._to_tensor(a).to(self.device) for k, a in arrays.items()}
            self._add_seconds(builds=1, page_in=time.perf_counter() - t0)
            return out
        with serve_pipeline.CUDA_EXCLUSIVE:
            pinned = {k: torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
                      for k, a in arrays.items()}
        for k, a in arrays.items():
            if a.size:
                np.copyto(pinned[k].numpy(), a)  # the page-in of a memory-mapped shard
        t1 = time.perf_counter()
        with serve_pipeline.CUDA_EXCLUSIVE:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                out = {k: p.to(self.device, non_blocking=True) for k, p in pinned.items()}
                done = torch.cuda.Event()
                done.record()
            done.synchronize()
            del pinned, done  # their release calls CUDA too: here, not beside a capture
        self._add_seconds(builds=1, page_in=t1 - t0, h2d=time.perf_counter() - t1)
        return out

    def _add_seconds(self, builds: int = 0, **parts: float) -> None:
        with self._stats_lock:
            self.builds += builds
            for k, v in parts.items():
                self.admission_s[k] += v

    def _build_shard(self, s: int) -> Retriever:
        """Shard ``s`` as a sub-``Retriever`` with its arrays on the
        device. A pure build — no LRU change — so the staging worker can
        run it. A shard smaller than its budget serves its whole doc
        range as the candidate list (budgets in ``_shard_cfg``)."""
        sh = self.shards[s]
        return Retriever(self._shard_cfg[s], self._place(sh.arrays), n_docs=sh.n_docs,
                         dim=self.dim, value_scale=self.value_scale,
                         value_format=self.value_format, device=self.device,
                         shard=f"{s}/{self.cfg.n_shards}")

    def _stage(self, s: int) -> None:
        """Queue shard ``s`` on the staging worker (page-in and copy)
        while the caller scores the current shard. One staged shard at a
        time; a resident or already-staged shard is a no-op, and a staged
        build of another shard is retired with its plan creations
        counted."""
        with self._admit_lock:
            if s in self._resident:
                return
            st = self._staged
            if st is not None:
                if st[0] == s:
                    return
                self._staged = None
                self._evicted_compiles += st[1].result().plans.compiles

            def task() -> Retriever:
                # thread-local, so the worker enters them itself
                on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else \
                    contextlib.nullcontext()
                with torch.inference_mode(), on_card:
                    return self._build_shard(s)

            self._staged = (s, _prefetch_pool().submit(task))

    def _consume_staged(self, s: int) -> Optional[Retriever]:
        """Take shard ``s`` out of the staging buffer if it is there,
        waiting for a build in flight and re-raising its exception. A
        staged build whose budget went stale is discarded, its plan
        creations counted. Callers hold ``_admit_lock``."""
        st = self._staged
        if st is None or st[0] != s:
            return None
        self._staged = None
        r = st[1].result()
        if r.cfg.k != self._shard_k[s]:
            self._evicted_compiles += r.plans.compiles
            return None
        return r

    def _staged_bytes(self) -> int:
        st = self._staged
        if st is None or not st[1].done() or st[1].exception() is not None:
            return 0
        return _nbytes(st[1].result().arrays)

    def _shard_retriever(self, s: int) -> Retriever:
        """Shard ``s``'s sub-``Retriever``, admitted to the LRU: from
        residency, else from the staging buffer (``prefetch_hits``), else
        built on the critical path (``prefetch_misses`` when prefetch is
        on). Admission beyond ``max_resident`` evicts the least recently
        used shard. ``peak_resident_bytes`` is sampled before the staging
        buffer is consumed, so a completed staged build beside the
        resident shards counts (DESIGN.md §11)."""
        with self._admit_lock:
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes() + self._staged_bytes())
            r = self._resident.get(s)
            if r is not None:
                self._resident.move_to_end(s)
                return r
            t0 = time.perf_counter()
            r = self._consume_staged(s)
            if r is not None:
                self.prefetch_hits += 1
            else:
                if self.prefetch and self.cfg.n_shards > 1:
                    self.prefetch_misses += 1
                r = self._build_shard(s)
            if self.device.type == "cuda":
                # allocated on the copy stream, read on this thread's stream
                stream = torch.cuda.current_stream(self.device)
                for t in r.arrays.values():
                    t.record_stream(stream)
            self._resident[s] = r
            while len(self._resident) > self.max_resident:
                _, old = self._resident.popitem(last=False)
                self._evicted_compiles += old.plans.compiles
                self.evictions += 1
                del old  # its arrays, graphs and graph pool go here
            self.peak_resident_bytes = max(self.peak_resident_bytes,
                                           self.resident_bytes() + self._staged_bytes())
            self._add_seconds(admit=time.perf_counter() - t0)
            return r

    def resident_bytes(self) -> int:
        """Device bytes of the resident shards' arrays — what
        ``max_resident`` bounds (their graph pools: ``pool_bytes``)."""
        return sum(_nbytes(r.arrays) for r in self._resident.values())

    def pool_bytes(self) -> int:
        """Graph memory reserved by the resident shards' captured plans."""
        with self._admit_lock:
            return sum(p.pool_bytes for r in self._resident.values()
                       for p in r.plans.created().values())

    def disk_bytes(self) -> int:
        """Array payload across shards, as stored."""
        return sum(sh.disk_bytes() for sh in self.shards)

    # -- the shard rotation -----------------------------------------------
    def _global_ids(self, s: int, ids: torch.Tensor) -> torch.Tensor:
        """Shard-local → global doc ids, sentinel-safe: an offset add for
        ids inside ``[0, n_local)`` only; padding and out-of-range ids go
        to the out-of-corpus sentinel ``n_docs``."""
        sh = self.shards[s]
        valid = (ids >= 0) & (ids < sh.n_docs)
        return torch.where(valid, ids + sh.doc_lo, torch.full_like(ids, self.n_docs))

    def _dispatch_shards(self, Q: torch.Tensor):
        """One padded ``[bucket, dim]`` batch → the merged global top-k
        and a record of each per-shard plan it ran (the ``FacadePlan``
        contract). The rotation stages shard ``s + 1`` (wrapping: the wrap
        primes the next batch's first shard) while shard ``s`` is
        admitted and scored. Nothing of a shard is held past its turn, so
        an eviction frees the evicted shard's device memory at once."""
        state = self._mesh()
        if state is not None:
            return self._dispatch_mesh(Q, *state)
        S = self.cfg.n_shards
        Q = Q.to(self.device)
        do_prefetch = self.prefetch and S > 1
        bucket = int(Q.shape[0])
        flat_i, flat_s, ran = [], [], []
        for s in range(S):
            r = self._shard_retriever(s)
            if do_prefetch:
                self._stage((s + 1) % S)
            plan = r.plans.get(r.plans.bucket_for(bucket))
            t0 = time.perf_counter()
            if plan.warm(self.dim):
                self._add_seconds(capture=time.perf_counter() - t0)
            ids, scores = plan(Q)
            ran.append((f"{s}/{S}", plan.launches, plan.stages))
            del r, plan
            gids = self._global_ids(s, ids)
            if self._tomb_mask is not None:
                # dead global ids go to the sentinel at -inf, like padding
                dead = self._tomb_mask[gids.long()]
                gids = gids.masked_fill(dead, self.n_docs)
                scores = scores.masked_fill(dead, float("-inf"))
            flat_i.append(gids)
            flat_s.append(scores)
        flat_i = torch.cat(flat_i, dim=1)
        flat_s = torch.cat(flat_s, dim=1)
        if flat_i.shape[1] < self.cfg.k:  # k > n_docs: sentinel-pad
            pad = self.cfg.k - flat_i.shape[1]
            flat_i = torch.cat([flat_i, flat_i.new_full((bucket, pad), self.n_docs)], dim=1)
            flat_s = torch.cat([flat_s, flat_s.new_full((bucket, pad), float("-inf"))], dim=1)
        ids, scores = api.merge_topk(flat_i, flat_s, self.cfg.k, dedupe=self.impl.dedupe_merge,
                                     n_docs_global=self.n_docs)
        return ids, scores, ran

    # -- the mesh fan-out ---------------------------------------------------
    def _mesh(self) -> Optional[tuple]:
        """The mesh path's state, built at first use and again after a
        tombstone change — or None where the rotation serves (``use_mesh``
        False, one shard, or None without a large enough process group)."""
        if self.use_mesh is False or self.cfg.n_shards == 1:
            return None
        if self._mesh_state is not None:
            return self._mesh_state
        S = self.cfg.n_shards
        if self._index_mesh is None:
            self._index_mesh = index_mesh(S)
        mesh = self._index_mesh
        if mesh is None:
            if self.use_mesh:
                have = dist.get_world_size() if dist.is_initialized() else 0
                raise ValueError(f"use_mesh=True but the process group has {have} rank(s) "
                                 f"for {S} shards (none is initialised where 0)")
            return None
        s = axis_index(mesh, "model")
        sh = self.shards[s]
        n_local = max(x.n_docs for x in self.shards)
        idmap = np.full(sh.n_docs + 1, self.n_docs, dtype=np.int32)
        idmap[: sh.n_docs] = np.arange(sh.doc_lo, sh.doc_hi, dtype=np.int32)
        dead = self._tombstones[(self._tombstones >= sh.doc_lo) & (self._tombstones < sh.doc_hi)]
        idmap[dead - sh.doc_lo] = self.n_docs
        search = api.make_sharded_search(
            mesh, self.cfg, n_local, self.n_docs, self.value_scale, index_axis="model",
            query_axes=(), k_local=tombstone_budget(self.cfg.k, n_local,
                                                    int(self._tombstones.size)),
            device=self.device)
        self._mesh_state = (search, s, torch.from_numpy(idmap).to(self.device))
        return self._mesh_state

    def _dispatch_mesh(self, Q: torch.Tensor, search, s: int, idmap: torch.Tensor):
        """One padded batch on this rank's shard ``s``: its plan (the
        sequential rotation's, at the shard's own budget), then the
        all-gather and merge over the mesh → the ``FacadePlan`` triple."""
        Q = Q.to(self.device)
        r = self._shard_retriever(s)
        plan = r.plans.get(r.plans.bucket_for(int(Q.shape[0])))
        t0 = time.perf_counter()
        if plan.warm(self.dim):
            self._add_seconds(capture=time.perf_counter() - t0)
        ids, scores = plan(Q)
        ran = [(f"{s}/{self.cfg.n_shards}", plan.launches, plan.stages)]
        del r, plan
        ids, scores = search.merge_local(ids, scores, idmap)
        return ids, scores, ran

    # -- serving (the Retriever surface) ----------------------------------
    def make_plans(self, buckets) -> ShardedPlanCache:
        return ShardedPlanCache(self, buckets)

    @torch.inference_mode()
    def search(self, Q, k: int | None = None):
        """[nq, dim] queries → global (ids i32 [nq, k], scores f32 [nq, k])
        on the retriever's device; under exhaustive engine budgets
        byte-identical to the unsharded index on the CPU."""
        if k is not None and k > self.cfg.k:
            raise ValueError(f"k={k} exceeds the static cfg.k={self.cfg.k}; rebuild with a "
                             f"larger cfg.k")
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

    # -- artifact lifecycle -----------------------------------------------
    def save(self, path, *, compress: bool = False) -> pathlib.Path:
        """Write the sharded tree::

            path/manifest.json             top-level shard manifest
            path/shard_0000/manifest.json  ordinary artifact manifest
            path/shard_0000/arrays.npz     stored raw → memory-mappable
            path/shard_0001/…

        Each shard directory is an ordinary artifact; the top level
        carries the per-shard doc ranges and array specs."""
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        entries = []
        for s, sh in enumerate(self.shards):
            host = {k: np.asarray(v) for k, v in sh.arrays.items()}
            sub = api.manifest_dict(
                self.cfg, host, n_docs=sh.n_docs, dim=self.dim, value_scale=self.value_scale,
                value_format=self.value_format,
                extra={"shard": s, "doc_lo": sh.doc_lo, "doc_hi": sh.doc_hi},
            )
            sdir = SHARD_DIR_FMT.format(s)
            api.write_artifact(path / sdir, sub, host, compress=compress)
            entries.append({"dir": sdir, "doc_lo": sh.doc_lo, "doc_hi": sh.doc_hi,
                            "arrays": sub["arrays"]})
        top = api.manifest_dict(self.cfg, {}, n_docs=self.n_docs, dim=self.dim,
                                value_scale=self.value_scale, value_format=self.value_format)
        del top["arrays"]
        top["format"] = api._SHARDED_FORMAT
        top["shards"] = entries
        with open(path / api._MANIFEST_FILE, "w", encoding="utf-8") as f:
            json.dump(top, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def open(cls, path, manifest: Mapping | None = None, *, device=None) -> "ShardedRetriever":
        """Open a sharded tree with every shard's arrays memory-mapped.

        Raises ``ArtifactError`` on a shard-count mismatch between the
        top-level and per-shard manifests, overlapping or gapped doc
        ranges, engine / codec / value-format / version skew, and
        truncated, missing or compressed shard payloads."""
        path = pathlib.Path(path)
        device = resolve_device(device)
        if manifest is None:
            manifest = api.load_manifest(path)
        top_mf = path / api._MANIFEST_FILE
        if manifest.get("format") != api._SHARDED_FORMAT:
            raise ArtifactError(f"{top_mf} is not a {api._SHARDED_FORMAT} tree "
                                f"(format={manifest.get('format')!r})")
        api.check_manifest_names(manifest, top_mf)
        n_shards = int(manifest.get("n_shards", 0))
        entries = manifest.get("shards")
        if not isinstance(entries, list) or not entries:
            raise ArtifactError(f"sharded manifest {top_mf} lists no shards")
        if len(entries) != n_shards:
            raise ArtifactError(
                f"shard-count mismatch at {top_mf}: n_shards={n_shards} but {len(entries)} "
                f"shard entries listed — the tree is inconsistent; rebuild it or restore the "
                f"missing shards"
            )
        n_docs = int(manifest["n_docs"])
        cfg = api.cfg_from_manifest(manifest)
        shards, expect_lo = [], 0
        for s, e in enumerate(entries):
            lo, hi = int(e["doc_lo"]), int(e["doc_hi"])
            if lo != expect_lo or hi <= lo:
                raise ArtifactError(
                    f"shard {s} at {top_mf} covers docs [{lo}, {hi}) but the previous shard "
                    f"ended at {expect_lo}: ranges must tile [0, {n_docs}) contiguously — no "
                    f"gaps, no overlaps; rebuild the tree"
                )
            expect_lo = hi
            sdir = path / e["dir"]
            sub = api.load_manifest(sdir)
            sub_mf = sdir / api._MANIFEST_FILE
            if sub.get("format") != api._MANIFEST_FORMAT:
                raise ArtifactError(f"{sub_mf} is not a shard artifact "
                                    f"(format={sub.get('format')!r})")
            api.check_manifest_names(sub, sub_mf)
            for key in ("engine", "codec", "value_format"):
                if sub.get(key) != manifest.get(key):
                    raise ArtifactError(
                        f"shard {s} {key}={sub.get(key)!r} disagrees with the top-level "
                        f"manifest's {manifest.get(key)!r} — mixed-build skew; rebuild the "
                        f"tree consistently"
                    )
            if int(sub.get("n_shards", 1)) != n_shards:
                raise ArtifactError(
                    f"shard-count mismatch: {sub_mf} says n_shards={sub.get('n_shards')}, "
                    f"top-level says {n_shards} — the shard belongs to a different tree; "
                    f"rebuild"
                )
            if (int(sub.get("doc_lo", lo)) != lo or int(sub.get("doc_hi", hi)) != hi
                    or int(sub["n_docs"]) != hi - lo):
                raise ArtifactError(
                    f"shard {s} doc range disagrees between {top_mf} ([{lo}, {hi})) and "
                    f"{sub_mf} ([{sub.get('doc_lo')}, {sub.get('doc_hi')}), "
                    f"n_docs={sub.get('n_docs')}); rebuild the tree"
                )
            arrays = mmap_npz(sdir / api._ARRAYS_FILE)
            api.check_array_spec(sub["arrays"], arrays, sdir / api._ARRAYS_FILE)
            shards.append(Shard(lo, hi, arrays))
        if expect_lo != n_docs:
            raise ArtifactError(
                f"shard ranges at {top_mf} end at doc {expect_lo} but the corpus has "
                f"{n_docs} docs — a tail shard is missing; rebuild the tree"
            )
        return cls(cfg, shards, dim=int(manifest["dim"]),
                   value_scale=float(manifest["value_scale"]),
                   value_format=manifest["value_format"], device=device)
