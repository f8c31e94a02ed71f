"""The harness's CPU tests: the harness, the reference and the program on
sys.path, and cells cut to a tiny size on the CPU."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"frame_height": 64, "frame_width": 96, "batch_size": 4}
TINY_TRAFFIC = {"pool_frames": 8, "segment_frames": 6, "check_frames": 4, "warm_batches": 2,
                "warm_segments": 1}


def tiny(cell):
    """The cell at 64x96, B=4, with pools, segments and samples cut to fit."""
    cell = copy.deepcopy(cell)
    cell.config.update(TINY)
    cell.traffic.update({k: v for k, v in TINY_TRAFFIC.items()
                         if k in cell.traffic or k.startswith("warm")})
    return cell


# cells whose files stay beside the benchmark, which no BENCHMARK.json entry
# names (PERF.md): the kind of driver each has
LEAK = "flagship_1080p30.leak_detect"
FILE_CELLS = {"flagship_1080p30.hls_variants": "mark", "flagship_1080p30.title_mark": "mark",
              LEAK: "detect"}
PER_LAYER = {"batch_call_ms": "ms", "copy_engine_ms": "ms", "codec_roofline": "%",
             "device_idle_share": "%"}


def load(name):
    """A cell of BENCHMARK.json, or one of FILE_CELLS built from its own files."""
    from harness import spec

    if name not in FILE_CELLS:
        return spec.load_cell(name)
    kind = FILE_CELLS[name]
    config, traffic = name.split(".")
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    e2e = [{"name": f"{kind}_frames_per_s", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}]
    per_layer = [{"name": f"{base}.{kind}", "unit": unit} for base, unit in PER_LAYER.items()]
    if tr["driver"] == "segments":
        per_layer.append({"name": "segment_p95_ms", "unit": "ms"})
    return spec.Cell(name, config, traffic, cfg, tr, e2e, per_layer)


@pytest.fixture
def load_tiny():
    return lambda name: tiny(load(name))
