"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/<name>-<digest>.so``
(``-gencode arch=compute_90a,code=sm_90a``, full-precision f32: no fast-math
flags) on first use; the digest covers the source, the shared headers and
the flags, so an edited source builds anew and an unchanged one is reused.
The sources have a plain C interface (no PyTorch headers), so a build takes
seconds.  Nothing here runs at import: the module imports on a machine
without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

from deepfbsdejsolvers_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("rollout_fwd", "rollout_bwd", "rollout_wide_fwd",
                  "rollout_wide_bwd", "sweep_fwd", "sweep_bwd",
                  "sweep_wide_fwd", "sweep_wide_bwd", "icdf_jumps")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``<csrc>/<name>.cu`` builds to, keyed by its inputs' digest."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cuh")) + [csrc / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNEL_SOURCES,
          csrc: Path = CSRC) -> List[str]:
    """Compile every source of ``names`` under ``csrc`` (this package's by
    default; another version's sources for an A/B) that is not built yet,
    all nvcc processes at once, and return the names compiled; raises with
    nvcc's output if any fails.  ptxas' register and shared-memory report
    for each kernel is kept beside its library (``ptxas_log``)."""
    todo = [n for n in names if not library_path(n, csrc).is_file()]
    if not todo:
        return []
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name, csrc)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", tmp,
               str(csrc / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        ptxas_log(out).write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n"
                            f"{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return todo


def ptxas_log(library: Path) -> Path:
    """nvcc's output (ptxas' report) of the build of ``library``."""
    return library.with_suffix(".ptxas.txt")


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first use; the
    seconds of that first use and the nvcc builds it ran go to the set-up
    counter "setup.kernels" (``utils/profiling.py``)."""
    lib = _LOADED.get(name)
    if lib is None:
        t0 = time.perf_counter()
        built = build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
        profiling.setup_add("setup.kernels", time.perf_counter() - t0,
                            builds=len(built), libraries=1)
    return lib
