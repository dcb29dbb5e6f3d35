"""The ('data', 'model') device mesh (the JAX package's parallel/mesh.py).

The JAX package shards one SPMD program over a ``jax.sharding.Mesh``:
recordings and windows along ``data`` (DP), the dense head along ``model``
(TP). The port runs one process per device, joined by torch.distributed
(parallel/distributed.py), and the mesh is a ``DeviceMesh`` of those ranks
with the same axis names: rank r sits at data index r // model_parallel and
model index r % model_parallel. The ranks of one ``data`` group share a
model index and hold different rows of the batch; the ranks of one
``model`` group share a data index, and so the same rows, and hold
different slices of the head.

The JAX ``data_sharding``, ``model_sharding`` and ``replicated`` name how a
global array lies over the devices. A process-per-device program has no
global array: each rank's tensors are its own rows or its own slice, so
they have no counterpart here; the TP plan is parallel/train.py's
``HEAD_PLAN``.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")


def make_mesh(n_devices=None, model_parallel=1, device_type=None) -> DeviceMesh:
    """('data', 'model') mesh of shape (n // model_parallel, model_parallel)
    over the ranks of the default process group (``distributed.initialize``
    first). `n_devices`: None means every rank; one process drives one
    device, so any other count than the world's is refused. `device_type`:
    None means ``cuda``; pass ``cpu`` for CPU ranks."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks (one process a "
                         f"device); this world has {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type or "cuda", ranks, mesh_dim_names=AXES)


def data_index(mesh) -> int:
    """This rank's index along 'data': which rows of a global batch it feeds."""
    return mesh.get_local_rank("data")


def model_index(mesh) -> int:
    """This rank's index along 'model': which slice of the head it holds."""
    return mesh.get_local_rank("model")


def data_group(mesh):
    """The ranks that share this rank's model index: the group over which
    gradients, BatchNorm sums and results are reduced or gathered; None
    when it has one rank or there is no mesh."""
    return mesh.get_group("data") if mesh is not None and mesh.size(0) > 1 else None


def model_group(mesh):
    """The ranks that share this rank's data index: the group over which
    the head's partial logits are summed; None when it has one rank or
    there is no mesh."""
    return mesh.get_group("model") if mesh is not None and mesh.size(1) > 1 else None


def rank_device(mesh) -> torch.device:
    """The device this rank drives: the current CUDA device (set by
    ``distributed.initialize``) on a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
