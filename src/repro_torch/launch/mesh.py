"""Meshes over the world's ranks, and the world itself.

A copy of ``repro.launch.mesh`` on ``torch.distributed``: the port runs one
process a device, so a mesh is a ``DeviceMesh`` over the ranks of the
default process group, and its shape must multiply to the world size.
:func:`start_world` starts that group (from the ``torchrun`` environment,
or as a world of 1); the scenario fleet's ``fleet_mesh`` starts its world
through it too.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Tuple

import torch

from repro_torch.device import resolve_device


def world_size() -> int:
    """The default group's size, else ``WORLD_SIZE`` (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def start_world(dev: torch.device):
    """The default process group of a mesh: from the ``torchrun``
    environment when there is one, else a world of 1 over a FileStore in
    a temporary directory. On the card each rank takes ``cuda:LOCAL_RANK``
    and NCCL, on the CPU gloo. The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    import torch.distributed as dist
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    d = tempfile.mkdtemp(prefix="mesh_world.")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    dist.init_process_group(backend,
                            store=dist.FileStore(os.path.join(d, "store"), 1),
                            rank=0, world_size=1, **kw)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device, what: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    world = world_size()
    if n != world:
        raise ValueError(f"{what} {dict(zip(names, shape))} needs {n} "
                         f"rank(s), this world has {world} (one process a "
                         f"device: launch with torchrun --nproc-per-node {n})")
    if not dist.is_initialized():
        start_world(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices) mesh.

    Axes: 'pod' = inter-pod data parallelism, 'data' = intra-pod data/FSDP,
    'model' = tensor/expert parallelism. Raises in a world of another size.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device, "the production mesh")


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, device=None):
    """A small ``('pod',) 'data', 'model'`` mesh over this world's ranks;
    ``device`` as :func:`repro_torch.device.resolve_device` takes it (the
    card unless "cpu" is passed: NCCL on the card, gloo on the CPU). Without
    a default process group one is started (:func:`start_world`)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device,
                     "the host mesh")
    return _mesh((data, model), ("data", "model"), device, "the host mesh")
