"""Dry runs of every cell on the CPU at a tiny size, through the program's
plain paths: the drivers, the sinks, the check and the result's shape."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH, FILE_CELLS, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS + sorted(FILE_CELLS))
def test_cell_dry_run(load_tiny, name, traced):
    from harness import runner

    cell = load_tiny(name)
    res = runner.execute(cell, 2**31 + 77, 0.3, traced, "cpu", time.perf_counter_ns())
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        if cell.traffic["driver"] == "segments":
            assert "segment_p95_ms" in res["metrics"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in res["metrics"]
    json.dumps(res)


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    from harness import spec

    for name in CELLS:
        cell = spec.load_cell(name)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, name
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in names, (name, m["name"])
            spec.metric_reader(m["name"])


def test_seed_fixes_the_inputs(load_tiny):
    from harness.drivers import DRIVERS, Ctx
    from harness.spans import Spans

    def pool(seed):
        cell = load_tiny("flagship_1080p30.title_mark")
        d = DRIVERS["embedder"](Ctx(cell, seed, "cpu", Spans(False)))
        d.prepare()
        return d.pool

    assert (pool(2**33 + 5) == pool(2**33 + 5)).all()
    assert (pool(2**33 + 5) != pool(2**33 + 6)).any()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
