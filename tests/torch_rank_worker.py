"""Rank process of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_farm.py).

Launched as ``python torch_rank_worker.py '<json config>'`` once per rank by
``run_ranks``; imports torch, numpy and vfp_tpu_torch only, never jax.  Each
rank runs on one CPU thread, joins a gloo group at a localhost address (or
lets ``mark_segments_distributed`` join it) and runs the config's jobs in
order; what a job returns goes to ``<out_dir>/rank<r>.json`` and, for
arrays, rank 0's ``<out_dir>/<job name>.npy``.

Jobs (``kind``):
  mesh     each rank's mesh coordinate and the errors of bad meshes
  mark     sharded_mark_step of a codec on a (data, variant) mesh, gathered
  detect   sharded_detect_step votes, on every rank
  spatial  sharded_mark_spatial at data = world, gathered along W, and the
           error of a misaligned width
  farm     mark_segments_distributed with a coordinator address
  cli      ``cli`` argv with ``--process-id <rank>`` appended; its stdout
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _codec(name):
    from vfp_tpu_torch.wm import DctQim, DtcwtKey, DwtDctSvd

    return {"dwtDctSvd": DwtDctSvd, "dtcwtKey": DtcwtKey, "dct": DctQim}[name]()


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def run_job(job, rank):
    import numpy as np

    from vfp_tpu_torch.parallel import make_mesh, sharded_detect_step, sharded_mark_step
    from vfp_tpu_torch.parallel import sharded as sh

    kind = job["kind"]
    if kind == "mesh":
        mesh = make_mesh(2, 2, device="cpu")
        return {"coordinate": mesh.get_coordinate(),
                "default_data": make_mesh(variant=2, device="cpu").size(0),
                "size_error": _error(lambda: make_mesh(3, 1, device="cpu")),
                "backend_error": _error(lambda: make_mesh(4, 1, device="cuda"))}, None
    if kind == "farm":
        from vfp_tpu_torch.parallel.farm import mark_segments_distributed

        marked, payloads, copies = mark_segments_distributed(
            job["segments"], job["marked_dir"], copies=job["copies"], batch_size=8,
            coordinator_address=job["coordinator"], num_processes=job["world"],
            process_id=rank, device="cpu")
        return {"marked": [[m.file, m.segment_number, m.copy_index, m.payload] for m in marked],
                "payloads": payloads, "copies": copies}, None
    if kind == "cli":
        import contextlib
        import io

        from vfp_tpu_torch.cli import main as cli

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli([*job["argv"], "--process-id", str(rank)])
        return {"stdout": out.getvalue()}, None
    mesh = make_mesh(*job["mesh"], device="cpu")
    frames = np.load(job["frames"])
    if kind == "mark":
        step = sharded_mark_step(mesh, _codec(job["codec"]))
        block = step(sh.shard_batch(mesh, frames), sh.shard_variants(mesh, np.load(job["wms"])))
        return {"block": list(block.shape)}, sh.gather_marked(mesh, block).numpy()
    if kind == "detect":
        from vfp_tpu_torch.wm import DeShuffler

        cands = np.load(job["cands"])
        deg = DeShuffler(key=0, threshold="fixed").set_shape((cands.shape[1],))
        step = sharded_detect_step(mesh, _codec("dwtDctSvd"), deg, len(cands))
        votes = step(sh.shard_batch(mesh, frames), cands)
        return {"votes": votes.tolist(), "dtype": str(votes.dtype)}, None
    if kind == "spatial":
        codec = _codec("dwtDctSvd")
        step = sh.sharded_mark_spatial(mesh, codec, frames.shape[2])
        local = step(sh.shard_axis(mesh, frames, 2), sh.shard_axis(mesh, np.load(job["wm2d"]), 1))
        out = sh.gather_axis(mesh, local, 2)
        return ({"local": list(local.shape), "misaligned_error":
                 _error(lambda: sh.sharded_mark_spatial(mesh, codec, 100))}, out.numpy())
    raise ValueError(f"unknown job {kind}")


def main():
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, out_dir = cfg["rank"], Path(cfg["out_dir"])
    if cfg.get("port") is not None:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                                world_size=cfg["world"], rank=rank)
    results = {}
    for job in cfg["jobs"]:
        res, arr = run_job(job, rank)
        results[job["name"]] = res
        if arr is not None and rank == 0:
            np.save(out_dir / f"{job['name']}.npy", arr)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "vfp_tpu"))
    assert not bad, bad
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(world, jobs, out_dir, port=None, timeout=120):
    """Run ``jobs`` in ``world`` rank processes; returns each rank's results.

    ``port``: the gloo group's localhost port (None: the jobs join a group
    themselves).  The ranks are killed after ``timeout`` seconds, so a hang
    fails one test instead of the run."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, json.dumps({"rank": r, "world": world, "port": port,
                                               "out_dir": str(out_dir), "jobs": jobs})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err.decode()[-3000:]}"
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


if __name__ == "__main__":
    main()
