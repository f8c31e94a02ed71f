"""Sharded mark/detect steps over a ('data', 'variant') mesh (port of
``vfp_tpu/parallel/sharded.py``).

The frame batch shards over 'data', the watermark-variant axis over
'variant' (each rank embeds its own payload planes into its frames).
Detection sums per-frame payload votes with an ``all_reduce`` over 'data';
nothing else communicates, because every frame carries the whole payload.

The JAX steps take global arrays and let ``shard_map`` place them; here each
rank is a process, so a step takes this rank's shards (``shard_batch``,
``shard_variants``, ``shard_axis``) and returns its local block, and the
gathers assemble global results where a caller wants them.  The codec on
each rank is the single-device codec, so every kernel runs unchanged on its
shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import mesh_device


def shard_axis(mesh: DeviceMesh, x, axis: int, mesh_dim: str = "data") -> torch.Tensor:
    """This rank's part of ``x`` (a host array or tensor) cut into equal
    parts along ``axis`` over ``mesh_dim``, contiguous, on the rank's
    device.  Raises ``ValueError`` when the axis does not divide."""
    x = torch.as_tensor(x)
    parts = mesh.size(mesh.mesh_dim_names.index(mesh_dim))
    if x.shape[axis] % parts:
        raise ValueError(f"axis {axis} of {x.shape[axis]} does not split over {parts} "
                         f"'{mesh_dim}' ranks")
    n = x.shape[axis] // parts
    part = x.narrow(axis, mesh.get_local_rank(mesh_dim) * n, n)
    # a slice off the leading axis is strided: made contiguous here, on purpose,
    # rather than by a kernel wrapper's hidden copy
    return part.contiguous().to(mesh_device(mesh))


def shard_batch(mesh: DeviceMesh, frames) -> torch.Tensor:
    """This rank's 'data' shard of a host batch [B, ...] on its device."""
    return shard_axis(mesh, frames, 0, "data")


def shard_variants(mesh: DeviceMesh, wms) -> torch.Tensor:
    """This rank's 'variant' shard of the watermarks [V, capacity], float32."""
    return shard_axis(mesh, wms, 0, "variant").to(torch.float32)


def gather_axis(mesh: DeviceMesh, local: torch.Tensor, axis: int,
                mesh_dim: str = "data") -> torch.Tensor:
    """Inverse of :func:`shard_axis`: every rank's part along ``mesh_dim``,
    concatenated along ``axis`` in mesh order, on every rank."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size(mesh.mesh_dim_names.index(mesh_dim)))]
    dist.all_gather(parts, local, group=mesh.get_group(mesh_dim))
    return torch.cat(parts, dim=axis)


def gather_marked(mesh: DeviceMesh, block: torch.Tensor) -> torch.Tensor:
    """Local marked blocks [V/variant, B/data, H, W, 3] -> the global [V, B,
    H, W, 3] on every rank (``out_specs=P("variant", "data")``)."""
    return gather_axis(mesh, gather_axis(mesh, block, 1, "data"), 0, "variant")


def sharded_mark_step(mesh: DeviceMesh, codec):
    """(frames [B/data, H, W, 3] u8, wms [V/variant, capacity] f32), this
    rank's shards -> its block [V/variant, B/data, H, W, 3] u8: one
    ``codec.mark_frames`` per local variant, zero collectives."""

    @torch.inference_mode()
    def step(frames: torch.Tensor, wms: torch.Tensor) -> torch.Tensor:
        return torch.stack([codec.mark_frames(frames, wm) for wm in wms])

    return step


def sharded_detect_step(mesh: DeviceMesh, codec, degenerator, candidates: int):
    """(frames [B/data, H, W, 3] u8, payloads [C, P]) -> vote counts [C]
    int32, the same on every rank.

    Decodes the frame shard, despreads it to per-frame payloads, compares
    each with all ``candidates`` payloads at once and sums the votes over
    'data' with an ``all_reduce``: one decode for all candidates."""
    group = mesh.get_group("data")

    @torch.inference_mode()
    def step(frames: torch.Tensor, cand) -> torch.Tensor:
        cand = torch.as_tensor(cand, device=frames.device).to(torch.int32)
        if cand.shape[0] != candidates:
            raise ValueError(f"{cand.shape[0]} candidate payloads, the step takes {candidates}")
        bits = codec.extract_frames(frames)  # [b, capacity]
        payloads = degenerator.degenerate_batch(bits).to(torch.int32)  # [b, P]
        match = (payloads[:, None, :] == cand[None, :, :]).all(dim=-1)
        votes = match.sum(dim=0, dtype=torch.int32)  # [C]
        dist.all_reduce(votes, op=dist.ReduceOp.SUM, group=group)
        return votes

    return step


def sharded_mark_spatial(mesh: DeviceMesh, codec, width: int):
    """(frames [B, H, W/data, 3] u8, wm2d [nbh, nbw/data]), this rank's width
    slice (``shard_axis(mesh, frames, 2)``) and its watermark block columns
    (``shard_axis(mesh, wm2d, 1)``) -> its marked slice; ``gather_axis(mesh,
    out, 2)`` gives the whole frames.  For frames too large for one device.

    The codec's 8x8-pixel block structure is local, so slicing W at 8-aligned
    boundaries needs no halo exchange.  Requires W % (8 * data) == 0."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    if width % (8 * n):
        raise ValueError(f"W={width} must be a multiple of {8 * n} for spatial sharding")

    @torch.inference_mode()
    def step(frames: torch.Tensor, wm2d: torch.Tensor) -> torch.Tensor:
        return codec.mark_frames(frames, wm2d.reshape(-1))

    return step
