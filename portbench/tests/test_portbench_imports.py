"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program under test."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vfp_tpu"}
PROGRAM = "vfp_tpu_torch"


def _imports(path: Path):
    """Top-level names of every module a file imports (relative imports
    resolve inside portbench/)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _files(sub=""):
    return sorted(Path(BENCH, sub).rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    bad = {str(p): sorted(set(_imports(p)) & FORBIDDEN) for p in _files()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in _files("reference"):
        names = set(_imports(p))
        assert PROGRAM not in names and not (names & FORBIDDEN), p
        assert "harness" not in names, p


def test_a_fresh_interpreter_loads_no_jax_through_a_run():
    code = f"""
import sys, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]
from conftest import LEAK, load, tiny
from harness import runner
for name in ("flagship_1080p30.hls_variants", LEAK, "dtcwtKey_1080p30.title_mark"):
    runner.execute(tiny(load(name)), 5, 0.2, False, "cpu", time.perf_counter_ns(),
                   log=lambda m: None)
import control, reference.flagship, reference.dtcwt_key
print("forbidden:" + ",".join(runner.forbidden_modules()))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "forbidden:"


def test_forbidden_modules_compares_whole_top_level_names():
    from harness import runner

    sys.modules.setdefault("vfp_tpu_torch_lookalike_for_test", sys)
    try:
        assert "vfp_tpu_torch_lookalike_for_test" not in runner.forbidden_modules()
    finally:
        sys.modules.pop("vfp_tpu_torch_lookalike_for_test", None)
