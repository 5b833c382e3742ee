"""Distributed pieces of the port: the collectives over a
``torch.distributed`` process group (:mod:`repro_torch.distributed.
collectives`: island migration, the int8-compressed gradient mean with
error feedback over n replicas, and the differentiable all-reduce and
all-to-all of the data- and expert-parallel paths); the floorline
hillclimb over step variants (:mod:`~repro_torch.distributed.autoshard`);
and the sharding specs as data (:mod:`~repro_torch.distributed.sharding`).

The JAX package's ``distributed/compat.py`` has no counterpart on purpose:
it shims JAX's own API across versions (``shard_map``'s ``check_vma``,
``make_mesh``, ``axis_size``), which PyTorch has no use for."""
