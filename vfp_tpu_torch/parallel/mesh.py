"""Device mesh construction (port of ``vfp_tpu/parallel/mesh.py``).

The workload's parallel axes: frames within a segment ("data") and watermark
variants per segment ("variant", the copies axis of the HLS workflow).  The
ranks of the ``torch.distributed`` process group play the part of the JAX
package's devices: one process per device, the mesh laid over the ranks in
order, row-major, as ``jax.sharding.Mesh`` lays it over ``jax.devices()``.
Segments themselves need no collective (``farm.py``).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device_type: str, rank: int) -> torch.device:
    """The device of rank ``rank`` on its host: ``cuda:{LOCAL_RANK}`` (torchrun's
    variable), else ``cuda:{rank % device_count()}``; the CPU for ``cpu``."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None
                        else rank % torch.cuda.device_count())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in ``mesh`` (the current CUDA device, or the CPU)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: int | None = None, variant: int = 1, device="cuda") -> DeviceMesh:
    """('data', 'variant') mesh over the ranks of the process group; ``data``
    defaults to world size / variant.

    ``device`` sets the mesh's device type and the backend it needs: NCCL
    for ``cuda`` (each rank on ``local_device``, made current before the
    mesh), gloo for ``cpu``; a process group of another backend raises.
    With no process group this function initialises one of world size 1
    on a free localhost port (``tcp://127.0.0.1:<port>``) with that
    backend; a multi-rank run initialises its group first (torchrun's
    ``env://``, or ``init_process_group`` with an address)."""
    device_type = torch.device(device).type
    if device_type not in BACKENDS:
        raise ValueError(f"mesh devices are cuda or cpu, not {device_type}")
    backend = BACKENDS[device_type]
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = n // variant
    if data * variant != n:
        raise ValueError(f"mesh {data}x{variant} != {n} devices")
    if dist.is_initialized() and backend not in dist.get_backend():
        raise ValueError(f"a {device_type} mesh needs a {backend} process group, not "
                         f"{dist.get_backend()}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda", rank))
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    return init_device_mesh(device_type, (data, variant), mesh_dim_names=("data", "variant"))
