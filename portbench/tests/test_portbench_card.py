"""On the card: one short run of every cell through run.py, correct and
with a result line; and the run refusing a checkout without the program.
Skips where torch sees no CUDA device (decided inside each test)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT
from test_portbench_cells import CELLS


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cwd, name, trace=0, seconds=2):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                           str(2**31 + 11), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    _need_card()
    r = _run(ROOT, name)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.cuda
def test_a_checkout_of_the_benchmark_alone_refuses(tmp_path):
    _need_card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, CELLS[-1])
    assert r.returncode != 0 and r.stdout.strip() == ""
