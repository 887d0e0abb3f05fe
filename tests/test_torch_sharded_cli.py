"""The sharded serving CLI (``python -m repro_torch.launch.serve
--n-shards S``) on the CPU against the reference's CLI: with ``--n-shards
3 --max-resident 1``, every engine with and without ``--no-prefetch``,
saved and reopened as a tree (``--save-index`` / ``--load-index``) and
through ``--pipeline``, and its recall equal to the reference CLI's on
the same collection."""

import re
import sys

import jax.numpy as jnp  # noqa: F401  (the reference runs on jax's CPU backend)
import pytest

from repro.launch import serve as ref_cli
from repro_torch.launch import serve as serve_cli
from torch_cases import one_intra_op_thread  # noqa: F401  (autouse)


def _recalls(out: str) -> list[str]:
    return re.findall(r"recall@10=([0-9.]+)", out)


@pytest.mark.parametrize("engine", ["seismic", "hnsw", "flat"])
def test_cli_sharded_serving(engine, tmp_path, capsys, monkeypatch):
    """``--n-shards 3 --max-resident 1`` with and without ``--no-prefetch``,
    saved and reopened as a tree, and through ``--pipeline``: the same
    recall each way, equal to the reference CLI's."""
    argv = ["--device", "cpu", "--engine", engine, "--n-docs", "300", "--n-queries", "4",
            "--n-shards", "3", "--max-resident", "1", "--beam", "32", "--iters", "24"]
    serve_cli.main(argv + ["--save-index", str(tmp_path)])
    serve_cli.main(argv + ["--load-index", str(tmp_path), "--no-prefetch"])
    serve_cli.main(argv + ["--pipeline", "--requests", "16"])
    out = capsys.readouterr().out
    assert "host index built" not in out  # a sharded build makes no shared host index
    lines = [ln for ln in out.splitlines() if "recall@10=" in ln]
    assert len(lines) == 2 and all("shards=3 max_resident=1" in ln for ln in lines)
    assert "prefetch=5h/1m evictions=5" in lines[0] and "saved→" in lines[0]
    assert "prefetch=0h/0m evictions=5" in lines[1] and "roundtrip=ids-identical" in lines[1]
    assert "backend=cuda" in lines[1]  # the tree serves the backend it was saved with
    assert (tmp_path / f"{engine}-dotvbyte" / "shard_0002" / "arrays.npz").is_file()
    pipe = [ln for ln in out.splitlines() if "pipeline parity OK" in ln]
    assert len(pipe) == 1 and "(16 requests, CPU)" in pipe[0] and "shards=3" in pipe[0]
    recall = set(_recalls(out))
    assert len(recall) == 1
    monkeypatch.setattr(sys, "argv", ["serve", "--engine", engine, "--n-docs", "300",
                                      "--n-queries", "4", "--n-shards", "3",
                                      "--max-resident", "1", "--beam", "32", "--iters", "24"])
    ref_cli.main()
    assert set(_recalls(capsys.readouterr().out)) == recall
