"""Production mesh construction -- the port of ``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module touches no
process group.  When a ``torch.distributed`` process group is up, the
meshes are ``init_device_mesh`` meshes on ``device_type`` ("cuda", or
"cpu" when asked) and :func:`make_ctx` reads their data, model and world
groups; otherwise they are shape-only (:class:`~repro_torch.models
.sharding.MeshSpec`), for the placement rules and the dry run, which
traces one rank's program on meta tensors.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.core.parallel import start_local_group
from repro_torch.models.sharding import MeshSpec, ShardCtx, shape_ctx

__all__ = ["make_mesh", "make_production_mesh", "make_ctx",
           "make_test_mesh", "local_ctx"]


def make_mesh(shape, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the process group when one is
    up (its world size must be the mesh's size), else a shape-only
    :class:`MeshSpec`."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if not (dist.is_available() and dist.is_initialized()):
        return MeshSpec(shape, axis_names)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_ctx(mesh) -> ShardCtx:
    """ShardCtx with every non-"model" axis treated as data-parallel."""
    if isinstance(mesh, MeshSpec):
        return shape_ctx(mesh.shape, mesh.axis_names)
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.size(i) for i in range(len(names)))
    dp = tuple(a for a in names if a != "model")
    data = (mesh.get_group(dp[0]) if len(dp) == 1
            else mesh[dp]._flatten().get_group())
    world = (dist.group.WORLD if mesh.size() == dist.get_world_size()
             else mesh._flatten().get_group())
    return ShardCtx(shape=shape, axis_names=names, dp_axes=dp,
                    model_axis="model", mesh=mesh, data_group=data,
                    model_group=mesh.get_group("model"), world_group=world)


def make_test_mesh(n_data: int = 2, n_model: int = 4,
                   device_type: str = "cuda"):
    """Small mesh for multi-process tests (gloo ranks on the CPU with
    ``device_type="cpu"``)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)


@contextlib.contextmanager
def local_ctx(device: torch.device):
    """A (1, 1) ("data", "model") ctx on ``device``'s type over a
    one-rank process group (NCCL on a card, gloo on the CPU) started here
    at ``tcp://localhost`` on a free port and destroyed on exit; over the
    caller's group when one is up (it must have one rank)."""
    started = start_local_group(device)
    try:
        yield make_ctx(make_mesh((1, 1), ("data", "model"), device.type))
    finally:
        if started:
            dist.destroy_process_group()
