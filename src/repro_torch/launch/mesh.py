"""Production meshes as ``torch.distributed`` device meshes (twin of
``repro.launch.mesh``): the reference's axis names and shapes over
``init_device_mesh``. Functions, not module constants: importing this
module touches no process group.

A mesh spans the ranks of the default process group, one device each:
``prod(shape)`` ranks, CUDA devices over NCCL unless the caller asks for
``device="cpu"`` (gloo). Nothing here discovers a cluster: the caller
starts the ranks and calls ``torch.distributed.init_process_group`` with
an address, a world size and a rank, except for the one-rank local mesh,
which starts its own group on ``tcp://127.0.0.1`` when none exists.
The axes are plain mesh dimensions that ``distributed.sharding`` lays
tensors out over, so ``shard_act`` works on every mesh made here.
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist

from repro_torch import device as _device


def backend_for(device: torch.device) -> str:
    """The process-group backend of a device type: NCCL for CUDA, gloo
    for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_local_group(device=None) -> None:
    """A default process group of one rank on this process (NCCL on the
    card, gloo on the CPU), at a free port of 127.0.0.1; nothing when a
    group exists already."""
    if dist.is_initialized():
        return
    dev = _device.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)


def _mesh(shape: tuple, axes: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device.resolve(device)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {dict(zip(axes, shape))}, have "
            f"{world or 'no process group'}: start {n} ranks and call "
            f"torch.distributed.init_process_group(backend, init_method, "
            f"world_size={n}, rank=...) in each first")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: 16 x 16 = 256 devices per pod ("data",
    "model"), or 2 pods = 512 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(*, multi_pod: bool = False, device=None):
    """A small mesh with the same axis names (8 ranks): (2, 2, 2) or
    (4, 2)."""
    shape = (2, 2, 2) if multi_pod else (4, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(device=None):
    """A one-device mesh ("data", "model") = (1, 1), on a one-rank group
    of its own when no group exists."""
    init_local_group(device)
    return _mesh((1, 1), ("data", "model"), device)
