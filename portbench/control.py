#!/usr/bin/env python3
"""The precision control of a cell: the plain reference computed in
bfloat16, put in the program's place, judged by the cell's own check.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--device cuda]

For each seed it makes the cell's inputs, draws the sample a run would
keep, and prints one JSON line with the check's numbers, their limits and
whether the control failed them.  A control that passes every number
cannot tell the configuration's float32 from bfloat16; the benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control(cell, seed: int, device) -> dict:
    import torch

    from harness.drivers import DRIVERS, Ctx
    from harness.spans import Spans

    ctx = Ctx(cell, seed, device, Spans(enabled=False))
    driver = DRIVERS[cell.traffic["driver"]](ctx)
    driver.prepare()
    driver.control_sample()
    with torch.no_grad():
        numbers = driver.check(control=True)
    limits = {k: v for k, v in cell.config["check"][driver.kind].items() if k in numbers}
    return {"workload": cell.name, "seed": seed, "device": str(device),
            "numbers": numbers, "limits": limits,
            "failed": sorted(k for k in limits if numbers[k] > limits[k])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from harness import spec
    from reference import strict_fp32

    strict_fp32()
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
