#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vfp_tpu_torch`` on one CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result as one JSON object; the check's numbers, each beside its limit, are
also the last lines of standard error.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiler
run.  Exits 2 without a CUDA card and 3 if JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter_ns()  # before any heavy import: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, ROOT]
    _caches()
    split = {}
    import torch

    split["import_torch_s"] = (time.perf_counter_ns() - T0) / 1e9
    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    chips = next(w for w in json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
                 ["workloads"] if w["name"] == args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import vfp_tpu_torch  # noqa: F401  the program under test, from the checkout

    from reference import strict_fp32

    strict_fp32()
    split["import_s"] = (time.perf_counter_ns() - T0) / 1e9  # torch, the harness, the program
    result = runner.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, split)
    found = runner.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"setup_split_s": split}))
    print(f"card: {_power_line()}", file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
