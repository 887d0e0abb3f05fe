"""The distributed layer on ``torch.distributed`` — the port of
``repro/dist``'s serving and data-parallel halves.

jax's ``shard_map`` is one SPMD program over a ``Mesh``; here every rank
(one process per device) runs the same Python over a
``torch.distributed.device_mesh.DeviceMesh``, holds only its own slice
of what jax shards, and calls the collective of a mesh axis where jax
calls ``all_gather`` or ``pmean`` over it:

* ``sharding``    — the serving mesh (``index_mesh``), the data axes,
  the tombstone budget, and the axis helpers every mesh path shares
  (``axis_index``, ``axis_size``, ``axes_group``, ``all_gather``);
* ``compression`` — the int8 error-feedback gradient mean of the
  compressed data-parallel step.

The LM, GNN and recsys placement rules and the flash-decode collective
of the reference are the auxiliary workloads (ROADMAP A11).
"""

from . import compression, sharding

__all__ = ["sharding", "compression"]
