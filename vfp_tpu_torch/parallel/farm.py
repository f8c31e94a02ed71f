"""Segment farm: HLS marking across processes and hosts (port of
``vfp_tpu/parallel/farm.py``).

Segments are embarrassingly parallel (every frame carries the whole payload;
outputs are per-segment files and mergeable JSON manifests), so the scaling
model is a work queue, not collectives:

* one host: ``mark_segments_parallel`` spawns worker processes, each taking
  a contiguous slice of the segments (each keeps the one-decode-for-all-
  copies property).  Workers run on the cards by default: worker r on
  ``local_device("cuda", r)``, so a host's cards share the work (one card
  is shared by all, each process with its own context).
* many hosts: ``mark_segments_distributed``, rank sharding over a
  ``torch.distributed`` gloo group and a shared filesystem.  Each process
  marks its contiguous slice on its card, writes a per-rank manifest shard,
  and rank 0 merges after a barrier.  (Running one ``cli hls-mark --resume``
  per host works too: per-segment outputs are idempotent.)

Segments are whatever ``fingerprint.segmenter.segment_video`` writes:
``.mp4`` by ffmpeg where the binary is on PATH, else ``.rawv`` or MJPEG
``.avi`` with their audio sidecars; variants and their sidecar copies are
the serial ``mark_segments``' files.  Spawned workers inherit PATH and
resolve ``io.ffmpeg.have_ffmpeg()`` themselves, so a farm writes the
variants a serial run on the same host writes (``.mp4`` under ffmpeg).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

from .mesh import local_device


def _slice(n_items: int, n_workers: int, rank: int):
    per = -(-n_items // n_workers)
    return rank * per, min((rank + 1) * per, n_items)


def worker_placement(device, rank: int) -> torch.device:
    """The device of farm worker ``rank``: ``device`` itself, unless it is
    ``cuda`` with no index, which puts the worker on its own card
    (``local_device("cuda", rank)``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return local_device("cuda", rank)
    return device


def _worker(args):
    """One worker's slice through ``mark_segments``; its launch counts of
    this slice ride back with the result (a worker process may run two)."""
    segments, marked_dir, copies, key, batch_size, quality, first_number, device = args
    from .. import kernels
    from ..fingerprint.marker import mark_segments

    kernels.reset_launch_counts()
    stats: dict = {}
    marked, payloads, copies_info = mark_segments(
        segments, marked_dir, copies=copies, key=key, batch_size=batch_size,
        quality=quality, resume=True, first_segment_number=first_number, stats=stats,
        device=device,
    )
    return (
        [(m.file, m.segment_number, m.copy_index, m.payload) for m in marked],
        payloads,
        copies_info["segments"],
        stats,
        kernels.launch_counts(),
    )


def mark_segments_parallel(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    workers: int = 2,
    batch_size: int = 16,
    quality: int = 95,
    worker_device="cuda",
    stats: dict | None = None,
):
    """Fan the segment x copies work queue over ``workers`` processes.

    Returns (marked, segment_payloads, segment_copies) with the same shapes
    as ``fingerprint.marker.mark_segments``.  Workers are spawned (a fork
    after CUDA initialisation fails) and mark on ``worker_device``, the cards
    unless the caller asks for the CPU: ``cuda`` without an index puts worker
    r on ``local_device("cuda", r)`` (``cuda:{r % device_count()}``), as the
    distributed farm places its ranks.  For a CUDA farm this process builds
    and loads the kernel library first, so no two workers compile it.  When
    ``stats`` is a dict it gets ``wall_seconds``, ``launches`` (the workers'
    kernel launch counts, summed) and ``workers`` (each worker's
    ``mark_segments`` stats)."""
    from ..fingerprint.marker import MarkedSegment

    t0 = time.perf_counter()
    if torch.device(worker_device).type == "cuda":
        from ..kernels import _build

        _build.library()
    segments = [str(s) for s in segments]
    marked_dir = Path(marked_dir)
    marked_dir.mkdir(parents=True, exist_ok=True)
    tasks = []
    for rank in range(workers):
        lo, hi = _slice(len(segments), workers, rank)
        if lo >= hi:
            continue
        tasks.append((segments[lo:hi], str(marked_dir), copies, key, batch_size, quality, lo,
                      str(worker_placement(worker_device, rank))))
    marked: list = []
    payloads: dict = {}
    seg_entries: dict = {}
    launches: Counter = Counter()
    worker_stats = []
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(tasks), mp_context=ctx) as pool:
        for m_list, p, entries, w_stats, counts in pool.map(_worker, tasks):
            marked.extend(MarkedSegment(*m) for m in m_list)
            payloads.update(p)
            seg_entries.update(entries)
            worker_stats.append(w_stats)
            launches.update(counts)
    marked.sort(key=lambda m: (m.segment_number, m.copy_index))
    segment_copies = {
        "segments": seg_entries,
        "total_segments": len(segments),
        "copies_per_segment": copies,
        "total_marked_segments": len(marked),
    }
    if stats is not None:
        stats["wall_seconds"] = round(time.perf_counter() - t0, 3)
        stats["launches"] = {k: v for k, v in launches.items() if v}
        stats["workers"] = worker_stats
    return marked, payloads, segment_copies


def merge_manifest_shards(shard_dir, world: int | None = None) -> tuple[list, dict, dict]:
    """Merge per-rank manifest shards (``manifest_rank*.json``) into the
    (marked, segment_payloads, segment_copies) triple of mark_segments.

    ``world`` bounds the ranks considered: a resume with a smaller world size
    leaves stale higher-rank shards from the previous run on disk, and merging
    those would double-count segments."""
    from ..fingerprint.marker import MarkedSegment

    marked: list = []
    payloads: dict = {}
    seg_entries: dict = {}
    total_segments = 0
    copies = 1
    for f in sorted(Path(shard_dir).glob("manifest_rank*.json")):
        try:
            rank = int(f.stem.removeprefix("manifest_rank"))
        except ValueError:
            continue
        if world is not None and rank >= world:
            continue
        shard = json.loads(f.read_text())
        marked.extend(MarkedSegment(*m) for m in shard["marked"])
        payloads.update(shard["payloads"])
        seg_entries.update(shard["segments"])
        total_segments += shard["n_segments"]
        copies = shard["copies"]
    marked.sort(key=lambda m: (m.segment_number, m.copy_index))
    segment_copies = {
        "segments": seg_entries,
        "total_segments": total_segments,
        "copies_per_segment": copies,
        "total_marked_segments": len(marked),
    }
    return marked, payloads, segment_copies


def _init_group(coordinator_address, num_processes, process_id) -> bool:
    """Join the farm's gloo group unless one exists; True when this call made it.

    A coordinator (``host:port``, rank 0's) or ``num_processes > 1`` asks for
    a group: ``tcp://`` at the coordinator, or ``env://`` (MASTER_ADDR and
    MASTER_PORT) without one.  With neither, torchrun's variables (WORLD_SIZE
    > 1) ask for ``env://``; else the run is one process and makes no group."""
    if dist.is_initialized():
        return False
    explicit = bool(coordinator_address) or (num_processes or 1) > 1
    if not explicit and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = "env://"
    dist.init_process_group("gloo", init_method=init_method, **kwargs)
    return True


def mark_segments_distributed(
    segments,
    marked_dir,
    copies: int = 1,
    key: int = 0,
    batch_size: int = 16,
    quality: int = 95,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    stats: dict | None = None,
):
    """Multi-host segment farm over a ``torch.distributed`` gloo group and a
    shared filesystem.

    Every process calls this with the same arguments (``marked_dir`` on a
    filesystem all hosts see).  Process ``i`` of ``N`` marks segments
    [ceil(S/N)*i, ceil(S/N)*(i+1)), the same contiguous ``_slice`` as the
    process farm, on its own card (``local_device``), writes
    ``manifest_rank{i}.json``, and after a barrier rank 0 merges the shards
    and returns the full (marked, payloads, segment_copies) triple; other
    ranks return their own shard's triple.  The group is gloo because its
    only collective is that barrier over files (``_init_group`` says when
    one is made; a group this call made is destroyed before it returns).
    A single process (no coordinator, ``num_processes`` 1, no torchrun
    variables) makes no group.  ``stats`` gets this rank's
    ``mark_segments`` stats, its ``rank`` and ``world``, and ``launches``
    (the kernel launches of its marking)."""
    created = _init_group(coordinator_address, num_processes, process_id)
    try:
        rank = dist.get_rank() if dist.is_initialized() else 0
        world = dist.get_world_size() if dist.is_initialized() else 1
        device = worker_placement(device, rank)
        segments = [str(s) for s in segments]
        marked_dir = Path(marked_dir)
        marked_dir.mkdir(parents=True, exist_ok=True)
        lo, hi = _slice(len(segments), world, rank)

        from .. import kernels
        from ..fingerprint.marker import mark_segments

        mark_stats: dict = {}
        before = kernels.launch_counts()
        marked, payloads, copies_info = mark_segments(
            segments[lo:hi], marked_dir, copies=copies, key=key, batch_size=batch_size,
            quality=quality, resume=True, first_segment_number=lo, stats=mark_stats,
            device=device,
        )
        shard = {
            "marked": [[m.file, m.segment_number, m.copy_index, m.payload] for m in marked],
            "payloads": payloads,
            "segments": copies_info["segments"],
            "n_segments": hi - lo,
            "copies": copies,
        }
        (marked_dir / f"manifest_rank{rank}.json").write_text(json.dumps(shard))
        if stats is not None:
            after = kernels.launch_counts()
            stats.update(mark_stats, rank=rank, world=world,
                         launches={k: v - before[k] for k, v in after.items() if v != before[k]})
        if world > 1:  # every shard is on disk before the merge reads them
            dist.barrier()
        if rank == 0:
            return merge_manifest_shards(marked_dir, world=world)
        return marked, payloads, copies_info
    finally:
        if created:
            dist.destroy_process_group()
