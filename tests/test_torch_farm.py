"""vfp_tpu_torch.parallel's segment farm and ``hls-mark --workers/--distributed``
against the port's serial ``mark_segments`` and vfp_tpu's, on the CPU.

tests/test_parallel.py's sizes: a 24-frame 96x64 .rawv at 6 fps cut into
four 1 s segments, 2 copies, batch 8.  Workers and ranks run on the CPU
(``worker_device="cpu"``, ``device="cpu"``) on one thread each; the
2-process farm runs as ``torch_rank_worker.py`` ranks at a localhost
coordinator, killed after 120 s.  The JAX marker runs on the port's .rawv
segments with ``out_ext=".rawv"`` and its full-frame path (VFP_LOWLINK=0).
Stated tolerance: payloads, manifests and playlists exactly equal; every
marked file byte-equal to the serial run's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vfp_tpu.fingerprint import marker as jmarker
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.fingerprint import mark_segments, segment_video
from vfp_tpu_torch.io import RawVideoWriter
from vfp_tpu_torch.parallel import (mark_segments_distributed, mark_segments_parallel,
                                    merge_manifest_shards)
from vfp_tpu_torch.parallel.mesh import free_port

from torch_parity import natural_frames
from torch_rank_worker import run_ranks

torch.set_num_threads(1)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers read OMP_NUM_THREADS; no torchrun variables here."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("VFP_LOWLINK", "0")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    d = tmp_path_factory.mktemp("farm")
    src = d / "src.rawv"
    with RawVideoWriter(src, 96, 64, fps=6) as w:
        w.write_batch(natural_frames(np.random.RandomState(1234), 24, 64, 96))
    segs = [str(s) for s in segment_video(src, d / "segs", 1.0)]
    assert len(segs) == 4
    return src, segs


@pytest.fixture(scope="module")
def serial(source, tmp_path_factory):
    out = tmp_path_factory.mktemp("serial")
    return mark_segments(source[1], out, copies=2, batch_size=8, **CPU)


def _same_files(a, b):
    assert [(m.segment_number, m.copy_index) for m in a] == \
        [(m.segment_number, m.copy_index) for m in b]
    for x, y in zip(a, b):
        assert Path(x.file).read_bytes() == Path(y.file).read_bytes(), (x.file, y.file)


def test_parallel_farm_matches_serial_and_jax(source, serial, tmp_path):
    m1, p1, c1 = serial
    stats = {}
    m2, p2, c2 = mark_segments_parallel(source[1], tmp_path / "farm", copies=2, workers=2,
                                        batch_size=8, worker_device="cpu", stats=stats)
    _, pj, cj = jmarker.mark_segments(source[1], tmp_path / "jax", copies=2, batch_size=8,
                                      out_ext=".rawv")
    assert p2 == p1 == pj
    assert c2 == c1
    assert c2["total_marked_segments"] == cj["total_marked_segments"] == 8
    _same_files(m1, m2)
    assert len(stats["workers"]) == 2 and stats["launches"] == {}  # the CPU runs no kernel
    assert stats["wall_seconds"] > 0


def test_distributed_world1_makes_no_group(source, serial, tmp_path):
    import torch.distributed as dist

    m1, p1, c1 = serial
    stats = {}
    m2, p2, c2 = mark_segments_distributed(source[1], tmp_path / "dist", copies=2,
                                           batch_size=8, stats=stats, **CPU)
    assert not dist.is_initialized()
    assert (stats["rank"], stats["world"], stats["launches"]) == (0, 1, {})
    assert p2 == p1 and c2 == c1
    _same_files(m1, m2)
    shard = json.loads((tmp_path / "dist" / "manifest_rank0.json").read_text())
    assert shard["n_segments"] == 4
    m3, p3, c3 = merge_manifest_shards(tmp_path / "dist")
    assert p3 == p2 and c3 == c2


def test_distributed_two_processes_at_a_coordinator(source, serial, tmp_path):
    m1, p1, c1 = serial
    job = {"name": "farm", "kind": "farm", "segments": source[1],
           "marked_dir": str(tmp_path / "dist"), "copies": 2, "world": 2,
           "coordinator": f"127.0.0.1:{free_port()}"}
    results = run_ranks(2, [job], tmp_path / "out")
    merged = results[0]["farm"]
    assert merged["payloads"] == p1 and merged["copies"] == c1
    assert [(m[1], m[2]) for m in merged["marked"]] == \
        [(m.segment_number, m.copy_index) for m in m1]
    assert len(results[1]["farm"]["marked"]) == 4  # rank 1 returns its own shard
    for r in range(2):
        shard = json.loads((tmp_path / "dist" / f"manifest_rank{r}.json").read_text())
        assert shard["n_segments"] == 2
    for m, (f, *_rest) in zip(m1, merged["marked"]):
        assert Path(m.file).read_bytes() == Path(f).read_bytes()


def test_merge_ignores_stale_higher_rank_shards(tmp_path):
    shard = {
        "marked": [["f0.rawv", 0, 0, [0, 1]]],
        "payloads": {"0_0": [0, 1]},
        "segments": {"0": [{"file": "f0.rawv", "payload": [0, 1], "copy_index": 0}]},
        "n_segments": 1,
        "copies": 1,
    }
    (tmp_path / "manifest_rank0.json").write_text(json.dumps(shard))
    stale = dict(shard, n_segments=3, marked=[["f9.rawv", 9, 0, [1, 0]]],
                 payloads={"9_0": [1, 0]})
    (tmp_path / "manifest_rank1.json").write_text(json.dumps(stale))
    (tmp_path / "manifest_rankX.json").write_text("not a shard")
    _, p_all, c_all = merge_manifest_shards(tmp_path)  # unbounded: sees both
    assert c_all["total_segments"] == 4 and "9_0" in p_all
    m, p, c = merge_manifest_shards(tmp_path, world=1)
    assert c["total_segments"] == 1
    assert "9_0" not in p and len(m) == 1


def test_a_coordinator_needs_the_world_and_the_rank(source, tmp_path):
    with pytest.raises(ValueError, match="num_processes and process_id"):
        mark_segments_distributed(source[1], tmp_path, coordinator_address="127.0.0.1:1",
                                  **CPU)


def _outputs(base: Path) -> dict:
    files = ["segment_payloads.json", "segment_copies.json", "segment_mapping.json"]
    out = {f: (base / f).read_text() for f in files}
    out.update({p.name: p.read_text() for p in sorted((base / "hls").glob("*.m3u8"))})
    return out


def test_cli_workers_and_distributed_write_what_the_serial_cli_writes(source, tmp_path, capsys):
    src = str(source[0])
    flags = ["--copies", "2", "--segment-duration", "1", "--batch-size", "8", "--device", "cpu"]
    port_cli(["hls-mark", src, str(tmp_path / "serial"), *flags])
    port_cli(["hls-mark", src, str(tmp_path / "workers"), *flags, "--workers", "2"])
    port_cli(["hls-mark", src, str(tmp_path / "dist"), *flags, "--distributed"])
    text = capsys.readouterr().out
    assert text.count("All segments were watermarked successfully!") == 3
    assert text.count("'launches': {}") == 2 and "'rank': 0, 'world': 1" in text
    want = _outputs(tmp_path / "serial")
    assert len(want) > 3
    assert _outputs(tmp_path / "workers") == want
    assert _outputs(tmp_path / "dist") == want
    for name in ("workers", "dist"):
        for f in sorted((tmp_path / "serial" / "marked_segments").glob("*.rawv")):
            assert (tmp_path / name / "marked_segments" / f.name).read_bytes() == f.read_bytes()


def test_cli_distributed_two_ranks(source, tmp_path):
    """Two ranks of ``hls-mark --distributed`` segment into one shared output
    dir; rank 1 prints its shard line and stops, rank 0 merges, verifies and
    writes what the serial CLI writes."""
    src = str(source[0])
    flags = ["--copies", "2", "--segment-duration", "1", "--batch-size", "8", "--device", "cpu"]
    port_cli(["hls-mark", src, str(tmp_path / "serial"), *flags])
    argv = ["hls-mark", src, str(tmp_path / "dist"), *flags, "--distributed", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "2"]
    results = run_ranks(2, [{"name": "cli", "kind": "cli", "argv": argv}], tmp_path / "out")
    rank0, rank1 = (r["cli"]["stdout"] for r in results)
    assert "All segments were watermarked successfully!" in rank0
    assert "rank 1: shard done (4 marked segments); rank 0 owns the merge" in rank1
    assert "All segments" not in rank1 and "'rank': 1, 'world': 2" in rank1
    assert _outputs(tmp_path / "dist") == _outputs(tmp_path / "serial")
    assert sorted(p.name for p in (tmp_path / "dist" / "segments").iterdir()) == \
        sorted(p.name for p in (tmp_path / "serial" / "segments").iterdir())
    for f in sorted((tmp_path / "serial" / "marked_segments").glob("*.rawv")):
        assert (tmp_path / "dist" / "marked_segments" / f.name).read_bytes() == f.read_bytes()
