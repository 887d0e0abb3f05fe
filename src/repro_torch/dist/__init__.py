"""The distributed layer on ``torch.distributed`` — the port of
``repro/dist``'s serving and data-parallel halves.

jax's ``shard_map`` is one SPMD program over a ``Mesh``; here every rank
(one process per device) runs the same Python over a
``torch.distributed.device_mesh.DeviceMesh``, holds only its own slice
of what jax shards, and calls the collective of a mesh axis where jax
calls ``all_gather`` or ``pmean`` over it:

* ``sharding``    — the serving mesh (``index_mesh``), the data axes,
  the tombstone budget, the axis helpers every mesh path shares
  (``axis_index``, ``axis_size``, ``axes_group``, ``all_gather``) and
  the placements the configs' cells carry (``P``, ``to_shardings``,
  ``replicate``, ``shard_shape``, ``shard_block``) and the families'
  rules (``lm_param_specs``, ``kv_cache_spec``, ``gnn_batch_spec``,
  ``recsys_param_specs``, ``recsys_batch_spec``);
* ``compression`` — the int8 error-feedback gradient mean of the
  compressed data-parallel step;
* ``collectives`` — sequence-sharded flash decoding
  (``flash_decode_shardmap``);
* ``placed``      — the collectives of the placed programs as autograd
  functions (the LM's tensor-, vocab-, expert- and FSDP-parallel step,
  RecSys's row-split lookups) and what the optimizer needs of a placed
  tree (``TreeShards``).

GAT's edge-sharded layer (``models.gnn.gat_loss_edge_sharded``) runs on
``placed``'s ``gather_axes`` (one all-gather of node rows a layer, its
backward a reduce-scatter) and ``replicated``.
"""

from . import collectives, compression, placed, sharding

__all__ = ["sharding", "compression", "collectives", "placed"]
