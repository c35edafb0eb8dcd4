"""Multi-device sharding: the ``(data, model)`` device mesh, batch and
row sharding, the sharded coupling and self-field, and the sharded
explicit inverse (see :mod:`.sharding`)."""

from .sharding import (
    batch_sharding,
    factorization_mesh,
    make_mesh,
    replicated_sharding,
    self_field_diagonal,
    set_factorization_mesh,
    shard_sweep_inputs,
    sharded_biot_savart,
    sharded_film_data,
    sharded_self_field,
    sharded_spd_inverse,
)
