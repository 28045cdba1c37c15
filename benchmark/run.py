"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(also ``python3 -m benchmark.run ...`` from the checkout's root).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared with its limit; the same checks
are the last lines of standard error.  Exit status 2 without a CUDA card
(or fewer than the cell asks for), without the program, or on a bad
argument; 3 if JAX or the JAX package was loaded; 1 on any other failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "benchmark" / "_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return p.parse_args(argv)


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    bench_file = ROOT / "BENCHMARK.json"
    cell_file = ROOT / "benchmark" / "workloads" / f"{args.workload}.json"
    if not bench_file.is_file() or not cell_file.is_file():
        err(f"no cell {args.workload!r} (BENCHMARK.json, {cell_file})")
        return 2
    bench = json.loads(bench_file.read_text())
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        err(f"BENCHMARK.json names no cell {args.workload!r}")
        return 2
    chips = int(entry[0]["chips"])
    from benchmark.harness import process_start_s

    err(f"set-up: started {process_start_s():.2f} s ago")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"the cell needs {chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}, "
            f"cards: {torch.cuda.device_count()}")
        return 2
    try:
        import deepfbsdejsolvers_torch  # noqa: F401  the program under test
    except ImportError as exc:
        err(f"the program is not in this checkout: {exc}")
        return 2
    from benchmark import harness

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench, chips, log=err)
    found = harness.forbidden_modules()
    if found:
        err(f"JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for name, c in out["checks"].items():
        err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
