"""The LM family on the card: ``chip_smoke.py``'s phase 14 alone, and
qwen3-8b at full width across cards: ``long_500k``'s decode step, and
``train_4k`` with its weights placed.

    python tools/torch_lm_timing.py                    # phase 14 on one card
    python tools/torch_lm_timing.py --worlds nccl:4    # both across four cards
    python tools/torch_lm_timing.py --worlds nccl:4 --cells placed   # train_4k only

Phase 14 (``chip_smoke.lm_rank``, one NCCL rank): see ``chip_smoke.py``'s
module docstring; it prints what the smoke prints for it.

``--worlds nccl:N`` spawns N NCCL ranks, one a card, on a ``(1, N)`` mesh:
``get_arch("qwen3-8b").build_cell("long_500k", mesh)`` with its batch of 1,
the whole bf16 weights on every card (16.4 GB, drawn from one seed, so
every card holds the same bits) and the 524,288-slot cache (77.3 GB in
all) split over the N cards by ``kv_cache_spec`` (its sequence over every
axis), filled with random bf16 keys and values, valid up to
``VALID``. Each rank decodes ``STEPS`` tokens (a warm-up first);
flash decoding reduces one max and two sums a layer over the N cards.
Checks: every rank's logits block finite, the new tokens written by the
rank whose slice holds their positions (within a window of each slice
around them, nothing else changed), and flash
decoding across the cards on one layer's 524,288 keys against the masked
reference on rank 0 (the layer's slices gathered there; relative L2 ≤
1e-2, bf16). Prints the step's ms (host clock + synchronise, median),
its bound (weights + the rank's cache slice over 3.35 TB/s) and each
rank's ``max_memory_allocated``, beside the card's name and power limit.

``--cells placed`` (with ``--worlds nccl:4``): qwen3-8b's ``train_4k``
with ``weights="placed"`` on a ``(2, 2)`` mesh (FSDP over ``data``,
tensor- and vocab-parallel over ``model``; bf16 weights, AdamW's f32
state) at a global batch of ``PLACED_ROWS`` sequences of 4,096 tokens
(2 a data rank, so ``gcd(8, 2)`` = 2 microbatches of one), ``STEPS``
timed steps, and the cut check at ``PLACED_CHECK`` (``tools/
torch_placed_cards.py``: the resident state against ``argument_bytes``,
``max_memory_allocated`` against the dry run's peak of the (2, 2) mesh,
loss and gradients against one process).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

OUT_DIR = ROOT / "build" / "torch_lm_timing"
HBM_BYTES_PER_S = 3.35e12
#: decode steps timed after a warm-up; the cache's valid length before them
STEPS = 5
VALID = 500_000
#: train_4k placed on four cards: the global batch (sequences of 4,096) and
#: the cut check (f32): layers, rows, tokens (its one-process logits are
#: rows × tokens × 151,936 f32)
PLACED_ROWS = 4
PLACED_CHECK = dict(layers=2, rows=4, seq=512)


def long_rank(rank: int, world: int, d: str, steps: int, valid: int) -> None:
    """One of ``world`` NCCL ranks: ``long_500k`` for qwen3-8b (see the
    module docstring) → ``<d>/rank<r>.json``."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import flash_decode_shardmap
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh((1, world), ("data", "model"))
    arch = get_arch("qwen3-8b")
    cfg = arch.cfg
    cell = arch.build_cell("long_500k", mesh)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    _, cache_sh, _, _ = cell.in_shardings
    struct = cell.input_structs[1]["k"]
    local = cache_sh["k"].shard_shape(struct.shape)
    g = torch.Generator(device=dev).manual_seed(100 + rank)
    cache = {k: torch.empty(local, dtype=cfg.dtype, device=dev) for k in ("k", "v")}
    for t in cache.values():  # a layer at a time: an f32 draw of the whole slice is 39 GB
        for layer in t:
            layer.copy_(torch.randn(layer.shape, generator=g, device=dev))
    S_local, seq = local[2], ("data", "model")
    start = shd.axis_index(mesh, seq) * S_local
    toks = torch.randint(0, cfg.vocab, (1, steps + 1), generator=torch.Generator(device=dev)
                         .manual_seed(7), device=dev)
    lengths = torch.full((1,), valid, dtype=torch.int32, device=dev)
    # the window of this slice around the positions the steps write
    w0 = min(max(valid - 2 - start, 0), S_local)
    w1 = min(max(valid + steps + 3 - start, 0), S_local)
    window = cache["k"][:, :, w0:w1].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, finite = [], True
    for j in range(steps + 1):  # the first is a warm-up
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = cell.fn(params, cache, toks[:, j:j + 1], lengths)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        finite &= bool(torch.isfinite(logits).all())
        lengths = lengths + 1
    changed = (cache["k"][:, :, w0:w1] != window).flatten(3).any(-1).any(0).any(0)
    written = [start + w0 + int(i) for i in torch.nonzero(changed)[:, 0]]
    del window
    # flash decoding across the cards on one layer's keys against the reference on rank 0
    q = torch.randn((1, 1, cfg.n_heads, cfg.head_dim), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev).to(cfg.dtype)
    vl = torch.full((1,), valid, dtype=torch.int32, device=dev)
    k0, v0 = cache["k"][0], cache["v"][0]
    flash = flash_decode_shardmap(mesh, batch_axes=(), seq_axes=seq)
    got = flash(q, k0, v0, vl)
    parts = {}
    for name, t in (("k", k0), ("v", v0)):
        gathered = [torch.empty_like(t) for _ in range(world)] if rank == 0 else None
        dist.gather(t.contiguous(), gathered, dst=0)
        parts[name] = gathered
    rec = dict(rank=rank, world=world, step_ms=times[1:], step_ms_median=statistics.median(
        times[1:]), finite=finite, slice=[start, start + S_local], written=written,
        cache_bytes_local=sum(t.numel() * t.element_size() for t in cache.values()),
        param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        logits_block=list(logits.shape), n_keys=struct.shape[2])
    if rank == 0:
        kf, vf = torch.cat(parts["k"], 1), torch.cat(parts["v"], 1)
        want = tf._decode_attention_ref(q, kf, vf, vl)
        rec["flash_rel"] = float((got.float() - want.float()).norm() / want.float().norm())
    (pathlib.Path(d) / f"rank{rank}.json").write_text(json.dumps(rec))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default=None,
                    help="nccl:N runs long_500k over N cards; default: phase 14 on one card")
    ap.add_argument("--cells", default="long,placed",
                    help="with --worlds: long (long_500k over N cards), placed (train_4k placed "
                         "on a (2, 2) mesh, N = 4) or both")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lm_timing: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.launch.mesh import spawn_ranks

    card = chip_smoke.card_line()
    if args.worlds is None:
        chip_smoke.lm_phase_finish(chip_smoke.lm_phase_start(), card)
        return 0
    backend, n = args.worlds.split(":")
    n = int(n)
    if backend != "nccl" or torch.cuda.device_count() < n:
        raise SystemExit(f"--worlds {args.worlds}: needs nccl and {n} cards "
                         f"({torch.cuda.device_count()} here)")
    cells = args.cells.split(",")
    ok = True
    if "placed" in cells:
        ok &= placed(n, card)
    if "long" in cells:
        ok &= long_cards(n, card)
    return 0 if ok else 1


def placed(n: int, card: str) -> bool:
    """qwen3-8b ``train_4k`` placed on a (2, 2) mesh (module docstring)."""
    import chip_smoke
    import torch_placed_cards as pc
    from repro_torch.launch.dryrun import cell_memory
    from repro_torch.launch.mesh import MeshShape, spawn_ranks

    if n != 4:
        raise SystemExit("--cells placed runs on a (2, 2) mesh: --worlds nccl:4")
    t0 = time.perf_counter()
    dry = cell_memory("qwen3-8b", "train_4k", MeshShape((2, 2), ("data", "model")), PLACED_ROWS)
    print(f"dry run (2, 2), qwen3-8b train_4k at {PLACED_ROWS} rows: traced in "
          f"{time.perf_counter() - t0:.1f}s on the host")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    spawn_s = spawn_ranks(pc.placed_rank, n, str(OUT_DIR), "qwen3-8b", "train_4k", PLACED_ROWS,
                          4096, STEPS, PLACED_CHECK, dry, backend="nccl",
                          init_file=OUT_DIR / "init", timeout_s=1200)
    recs = [json.loads((OUT_DIR / f"rank{r}.json").read_text()) for r in range(n)]
    ok = pc.report(recs, card, chip_smoke.MEM_FACTOR)
    print(f"qwen3-8b train_4k placed on four cards: spawn {spawn_s:.1f}s; "
          f"{'ok' if ok else 'FAILED'} ({card})")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return ok


def long_cards(n: int, card: str) -> bool:
    """``long_500k`` over ``n`` cards (module docstring)."""
    from repro_torch.launch.mesh import spawn_ranks

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    OUT_DIR.mkdir(parents=True)
    spawn_s = spawn_ranks(long_rank, n, str(OUT_DIR), STEPS, VALID, backend="nccl",
                          init_file=OUT_DIR / "init", timeout_s=1200)
    recs = [json.loads((OUT_DIR / f"rank{r}.json").read_text()) for r in range(n)]
    positions = sorted(p for r in recs for p in r["written"])
    ok = (all(r["finite"] for r in recs) and recs[0]["flash_rel"] <= 1e-2
          and positions == list(range(VALID, VALID + STEPS + 1)))
    for r in recs:
        print(f"rank {r['rank']}: slice {r['slice']}, a long_500k decode step "
              f"{r['step_ms_median']:.2f} ms (median of {STEPS}: "
              f"{[round(t, 2) for t in r['step_ms']]}), bound "
              f"{1e3 * (r['param_bytes'] + r['cache_bytes_local']) / HBM_BYTES_PER_S:.2f} ms "
              f"(weights + its cache slice over 3.35 TB/s), max_memory_allocated "
              f"{r['max_memory_allocated'] / 2**30:.2f} GiB, wrote positions {r['written']} "
              f"({card})")
    print(f"flash decoding across {n} cards on one layer's {recs[0]['n_keys']:,} keys vs the "
          f"masked reference on rank 0: relative L2 {recs[0]['flash_rel']:.2e} (rtol 1e-2); "
          f"spawn {spawn_s:.1f}s; {'ok' if ok else 'FAILED'} ({card})")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
