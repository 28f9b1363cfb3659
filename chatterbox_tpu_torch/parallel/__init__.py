from .mesh import AXES, MeshAxes, Rank, backend_for, launch, make_mesh, mesh_shape
from .sharding import (
    check_tp,
    dp_group,
    param_split_dims,
    shard_batch,
    shard_params,
    t3_param_specs,
    tp_group,
    unshard_params,
)
from .tp import copy_to_tp, reduce_from_tp

__all__ = [
    "AXES",
    "MeshAxes",
    "Rank",
    "backend_for",
    "check_tp",
    "copy_to_tp",
    "dp_group",
    "launch",
    "make_mesh",
    "mesh_shape",
    "param_split_dims",
    "reduce_from_tp",
    "shard_batch",
    "shard_params",
    "t3_param_specs",
    "tp_group",
    "unshard_params",
]
