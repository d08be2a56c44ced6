"""The mesh layer over ``torch.distributed`` (the port of
``findtextcenternet_tpu/parallel``): :mod:`.mesh` for the layout and the
sharding rules, :mod:`.collectives` for the collectives, and
:mod:`.distributed` for process-group start-up."""
from .mesh import (  # noqa: F401
    Mesh,
    leaf_sharding,
    make_mesh,
    param_pspec,
    replicate,
    shard_batch,
    shard_params,
    state_shardings,
    tree_pspecs,
)
