"""The readings that the limits of ``correct`` are set from, at a cell's
own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--kinds sound reference_tf32 program_tf32 half_batch frozen]

For each seed, the program's first steps (``sound``, or planted with a
fault: ``half_batch``, ``frozen``; or its own lower-precision path,
``program_tf32``, where the cell names one) and the reference in TF32 put
in the program's place (``reference_tf32``, the control), each held to the
reference's FP32 steps.  One JSON line a (seed, kind) on standard output,
with the numbers compared; the cell's limits are not read.  Runs on the
card; with ``--device cpu`` and ``--batch`` at a size a test holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

KINDS = ("sound", "reference_tf32", "program_tf32", "half_batch", "frozen")


def readings_for(cell_name: str, seed: int, kinds, device="cuda",
                 batch=None):
    """{kind: numbers} of one seed."""
    out = {}
    want_prog = [k for k in kinds if k != "reference_tf32"]
    base = harness.Cell(cell_name, seed, device=device, batch=batch)
    steps = int(base.wl["reference_steps"])
    first = base.first_steps(3)
    base.free()
    against = harness.reference_run(base, steps)
    for kind in want_prog:
        if kind == "sound":
            run = harness.program_run(base, first, steps)
        else:
            plan = (harness.Plan(control=kind) if kind == "program_tf32"
                    else harness.Plan(fault=kind))
            cell = harness.Cell(cell_name, seed, device=device, batch=batch,
                                plan=plan)
            run = harness.program_run(cell, cell.first_steps(3), steps)
            cell.free()
        out[kind] = harness.readings(run, against)
    if "reference_tf32" in kinds:
        out["reference_tf32"] = harness.readings(
            harness.reference_run(base, steps, tf32=True), against)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=["sound"], choices=KINDS)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=None)
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings_for(args.workload, seed, args.kinds, args.device,
                           args.batch)
        for kind, numbers in got.items():
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "kind": kind, **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
