"""What the harness drives: one adapter per ``kind`` of mix, each calling
the program (``repro_torch``) through its public entries only.

* ``retriever`` — ``serve.api.Retriever.build`` over a ``ForwardIndex``
  made straight from the benchmark's CSR, then ``Retriever.search`` (the
  plan cache: on the card one CUDA graph a bucket) with the mix's
  engine, codec, value codec, backend, ``k`` and engine parameters;
  answers are ``(ids, scores)`` ``[nq, k]``.
* ``block_scan`` — ``core.layout.pack_blocks`` placed on the device, then
  the codec's batched full scan ``kernels.ops.score_<codec>_batch``;
  answers are every document's score ``[nq, n_docs]``.

A new kind of mix is a new adapter here; a new mix of an existing kind
is a data file. ``repro_torch`` is imported inside the adapters, never
when this module is imported.
"""

from __future__ import annotations

import torch

__all__ = ["DRIVERS", "make_driver", "forward_index"]


def forward_index(host: dict, dim: int, value_format: str):
    """The program's ``ForwardIndex`` over the benchmark's host CSR."""
    from repro_torch.core.forward_index import VALUE_FORMATS, ForwardIndex

    return ForwardIndex(components=host["components"], values=host["values"],
                        offsets=host["offsets"], dim=dim,
                        value_format=VALUE_FORMATS[value_format])


class RetrieverDriver:
    answers = "topk"

    def __init__(self, mix: dict, device):
        self.mix, self.device = mix, torch.device(device)
        self.retriever = None

    def build(self, host: dict, dim: int, value_format: str) -> None:
        from repro_torch.serve.api import Retriever, RetrieverConfig

        m = self.mix
        cfg = RetrieverConfig(engine=m["engine"], codec=m["codec"], backend=m["backend"],
                              k=m["k"], batch_size=m["batch"], params=dict(m["params"]),
                              vq=m["vq"])
        fwd = forward_index(host, dim, value_format)
        self.retriever = Retriever.build(fwd, cfg, device=self.device)

    def placed(self) -> dict:
        return dict(self.retriever.arrays)

    def __call__(self, Q: torch.Tensor):
        return self.retriever.search(Q)

    def release(self) -> None:
        self.retriever = None


class BlockScanDriver:
    answers = "scores"

    def __init__(self, mix: dict, device):
        self.mix, self.device = mix, torch.device(device)
        self.packed = self.scan = None

    def build(self, host: dict, dim: int, value_format: str) -> None:
        from repro_torch.core.layout import pack_blocks
        from repro_torch.kernels import ops

        m = self.mix
        fwd = forward_index(host, dim, value_format)
        self.packed = pack_blocks(fwd, codec=m["codec"], block_size=m["block_size"]).to(self.device)
        self.scan = ops.block_scorers(m["codec"])[1]

    def placed(self) -> dict:
        return self.packed.as_dict()

    def __call__(self, Q: torch.Tensor):
        return self.scan(Q, self.packed)

    def release(self) -> None:
        self.packed = self.scan = None


DRIVERS = {"retriever": RetrieverDriver, "block_scan": BlockScanDriver}


def make_driver(mix: dict, device):
    try:
        cls = DRIVERS[mix["kind"]]
    except KeyError:
        raise ValueError(f"no driver for a mix of kind {mix.get('kind')!r}; have "
                         f"{sorted(DRIVERS)}") from None
    return cls(mix, device)
