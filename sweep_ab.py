"""A/B of the compensator sweep's kernels B3 and B4 on one CUDA card.

    python3 sweep_ab.py [--against DIR]

Builds B3 (``csrc/sweep_fwd.cu``) and B4 (``csrc/sweep_bwd.cu``) of this
checkout and, with ``--against``, of another version's ``csrc`` directory
(its C entries must take the same arguments), and runs each build through
the port's own wrappers (``ops/sweep.py`` ``b3_forward``, ``b4_backward``),
swapping only the loaded library.  Each build is held against
``sweep_plain`` by ``chip_smoke.check_sweep`` on the quadrature at 2^14 + 37
paths and on 5000 Monte-Carlo nodes at 2^12 + 37 paths; then all are timed
by ``chip_smoke.kernel_ms`` at the parity path's shapes (B = 2^17, H = 21,
the 49-node quadrature and 5000 Monte-Carlo nodes) in turns, first in order
and then in reverse (A, B, B, A).  Prints each build's ptxas report and
static SASS instruction counts (``cuobjdump -sass``), whether its B3 output
equals the first build's bit for bit, its two times per shape, and the
card's name and power limit.  Exits non-zero without a card or when a check
fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

NAMES = ("sweep_fwd", "sweep_bwd")


def build(csrc: Path) -> dict:
    """{name: loaded library} of B3 and B4 built from ``csrc``."""
    from deepfbsdejsolvers_torch.ops import _build

    _build.build(NAMES, csrc)
    return {n: ctypes.CDLL(str(_build.library_path(n, csrc))) for n in NAMES}


@contextlib.contextmanager
def using(libs: dict):
    """The port's wrappers launch the kernels of ``libs`` inside."""
    from deepfbsdejsolvers_torch.ops import _build

    saved = {n: _build._LOADED.get(n) for n in libs}
    _build._LOADED.update(libs)
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _build._LOADED.pop(n, None)
            else:
                _build._LOADED[n] = lib


def sass_counts(lib: Path) -> dict:
    """{kernel: {opcode class: static count}} from ``cuobjdump -sass``."""
    from deepfbsdejsolvers_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    classes = {"FFMA": "fp32", "FADD": "fp32", "FMUL": "fp32", "MUFU": "mufu",
               "LDS": "lds", "STS": "sts", "SHFL": "shfl", "BAR": "bar",
               "LDG": "ldg", "STG": "stg", "LDL": "local", "STL": "local"}
    counts, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = {"all": 0}
        elif name and line.startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0] == "{":
                words = words[1:]
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            op = words[0].split(".")[0]
            c = counts[name]
            c["all"] += 1
            if op in classes:
                c[classes[op]] = c.get(classes[op], 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another version's csrc directory")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as C
    from deepfbsdejsolvers_torch.ops import _build
    from deepfbsdejsolvers_torch.ops import sweep as S

    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {"this": _build.CSRC}
    if opts.against:
        dirs = {"against": Path(opts.against).resolve(), **dirs}
    built = {label: build(csrc) for label, csrc in dirs.items()}
    order = list(built)
    for label, csrc in dirs.items():
        for n in NAMES:
            lib = _build.library_path(n, csrc)
            for line in _build.ptxas_log(lib).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"{label} {n}: {line.strip()}")
            for kernel, c in sass_counts(lib).items():
                print(f"{label} sass {kernel[:48]}: {c}")

    outs = {}
    for tag, (node_set, batch) in enumerate((("quadrature", C.CHECK_BATCH),
                                             ("mc", 2**12 + 37))):
        args, g = C.sweep_inputs(C.HIDDEN, node_set, batch, tag)
        for label in order:
            print(f"{label} {node_set} B={batch}:")
            with using(built[label]):
                C.check_sweep(args, g)
                outs[label, node_set] = S.b3_forward(*args)
    for label in order:
        same = [torch.equal(outs[label, k], outs[order[0], k])
                for k in ("quadrature", "mc")]
        print(f"{label}: B3 output bit-identical to {order[0]}'s: {same}")

    for node_set in ("quadrature", "mc"):
        args, g = C.sweep_inputs(C.HIDDEN, node_set, C.TRAIN_BATCH, 10)
        reps = 20 if node_set == "quadrature" else 3
        times = {label: {"B3": [], "B4": []} for label in order}
        for label in order + order[::-1]:
            with using(built[label]):
                times[label]["B3"].append(C.kernel_ms(
                    lambda: S.b3_forward(*args), reps))
                times[label]["B4"].append(C.kernel_ms(
                    lambda: S.b4_backward(*args, g), reps))
        for label in order:
            t = times[label]
            print(f"{node_set} M={args[1].shape[0]} B={C.TRAIN_BATCH} "
                  f"H={C.HIDDEN} {label}: B3 {t['B3'][0]:.4f} / "
                  f"{t['B3'][1]:.4f} ms, B4 {t['B4'][0]:.4f} / "
                  f"{t['B4'][1]:.4f} ms")
        del args, g
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
