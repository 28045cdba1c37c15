"""A/B of the port's CUDA kernels B1–B4, of the wide sweep pair or of the
wide rollout pair, on one CUDA card.

    python3 kernel_ab.py [--against DIR [DIR ...]] [--batch B [B ...]]
                         [--wide | --wide-rollout]

Builds the four kernels (``csrc/rollout_fwd.cu``, ``rollout_bwd.cu``,
``sweep_fwd.cu``, ``sweep_bwd.cu``) of this checkout and, with
``--against``, of another version's ``csrc`` directory, and runs each build
through the port's wrappers, swapping only the loaded library: B3/B4
through this checkout's ``ops/sweep.py`` (the other version's C entries
must take the same arguments), B1/B2 through each version's own
``ops/rollout.py`` (``DIR/../ops/rollout.py``, loaded beside this one),
whose ``b1_forward``/``b2_backward`` take the same arguments while B2's C
entry and partial buffer may differ.

Each build is held against its plain version by ``chip_smoke.py``'s checks:
B1/B2 by ``check_kernels`` on ``rollout_inputs`` at H = 21, N = 50 and
2^14 + 37 paths; B3/B4 by ``check_sweep`` on the quadrature at 2^14 + 37
paths and on 5000 Monte-Carlo nodes at 2^12 + 37.  Then all are timed by
``chip_smoke.kernel_ms`` at the main paths' shapes (B = 2^17, or each
``--batch`` for B1/B2; B1/B2 at N = 50, P = 8, H = 21 and 8; B3/B4 at H = 21
on the 49-node quadrature and 5000 Monte-Carlo nodes) in turns: one untimed
turn in order while the card's clocks rise from idle, then in order and in
reverse (A, B, B, A).

B1's and B2's head-TF32 instances (``head_precision="default"``) go
through the same at H = 21 and 8 (``TF32_NARROW``): ``check_kernels``,
whose forward check runs step by step on B1's own trajectory
(``tf32_step_errors``), whether B1 TF's outputs equal the first build's
and B2 TF's on the first build's B1 TF residuals, and their times in the
same turns as the FP32 instances'.

Prints each build's ptxas report; its SASS (``cuobjdump -sass``) counts per
kernel, whole and per loop: every backward branch closes a loop, printed
with its nesting depth and the counts of its body without its inner
loops, so that each body can be multiplied by its trip count; whether each
kernel's counts, whole and per loop, equal the first build's (kernels paired
by name, width and instance); B1's registers, and B1's and B2's shared
memory and blocks per SM, in both instances at H = 21 and 8, where the build
has the info entries (``rollout_fwd_info``, ``rollout_bwd_info`` and their
``_tf32`` forms); whether B1's and B2's outputs and B3's output equal the
first build's bit for bit; the two times of each kernel; and the card's
name and power limit.

Exits 0 when every build passed every check, 2 without a card, and 1 when
a check failed: this checkout's failure ends the run; another build's is
printed and recorded, and its times are still taken.  The script leaves
through ``os._exit`` once its output is flushed.  An earlier version
exited with SIGSEGV (-11) after printing everything when two builds'
libraries were loaded, so its code said nothing of its checks: the crash
came in the teardown at exit, of the interpreter and of the libraries
(each links its own static CUDA runtime).  It has not reproduced since,
with two to four builds loaded, with a backtrace handler preloaded or
without, nor with that earlier version, so its cause is not known; nothing
the script needs happens in that teardown.

With ``--wide`` it takes the wide sweep pair B3w/B4w instead
(``csrc/sweep_wide_fwd.cu``, ``sweep_wide_bwd.cu``), each build through its
own version's ``ops/sweep.py`` (``DIR/../ops/sweep.py``, whose tiling and
partial buffer may differ): ``check_sweep`` at hidden 20, 64, 100 and 128
on the 49-node quadrature at 2^14 + 37 paths and at ``chip_smoke.py``'s
``F64_CHECK`` (H = 128, 5000 Monte-Carlo nodes, 2^12 + 37 paths), where each
gradient leaf's distance from a float64 evaluation is printed for B4w and
for the plain version; the kernels timed in turns at B = 2^17 at each
hidden width on the 49 nodes on J and at 128 on the 96 nodes on X·J, with
their FP32 bound and tensor-core bound; and a training step of each of
``WIDE_PARITY``'s paths (the parity path at hidden 64 and 128) in turns.

With ``--wide-rollout`` it takes the wide rollout pair B1w/B2w instead
(``csrc/rollout_wide_fwd.cu``, ``rollout_wide_bwd.cu``), each build through
its own version's ``ops/rollout.py`` (whose tiling and B2w block count may
differ): ``check_kernels`` at hidden 20, 64, 100 and 128 at N = 50 on
2^14 + 37 paths (B1w's forward and loss, B2w's gradients two ways, each
leaf and as a whole, B2w bit for bit on rerun), and whether B1w's and
B2w's outputs equal the first build's bit for bit; ``chip_smoke.py``'s
``ROLLOUT_F64_CHECK`` (H = 128, N = 50, 2^12 + 37 paths), the loss's and
each gradient leaf's distance from a float64 evaluation for each build's
kernels and for the plain version; the kernels timed in turns at N = 50,
B = 2^17 at each hidden width, with their FP32 bound and tensor-core
bound; and a training step of the fused speed path at hidden 64 and 128
in turns.  Its ptxas and SASS report covers the wide sweep pair of each
build too (their sources share a header with the wide rollout's), and it
prints each build's shared memory and blocks per SM of B1w and B2w.  The
head-TF32 instances (``head_precision="default"``) go through the same:
``check_kernels`` at hidden 20, 64 and 128 (``TF32_WIDTHS``), whether
their outputs equal the first build's (B2w's on the first build's B1w
residuals), their times at HP 32, 64 and 128 in turns beside the FP32
instances' with the tensor-core bound, their shared memory and blocks per
SM where the build reports them, and the fused speed step with TF32 heads
at hidden 64 and 128 in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

NAMES = ("rollout_fwd", "rollout_bwd", "sweep_fwd", "sweep_bwd")
WIDE_NAMES = ("sweep_wide_fwd", "sweep_wide_bwd")
WIDE_ROLLOUT_NAMES = ("rollout_wide_fwd", "rollout_wide_bwd")
# the wide pair's timed shapes at B = 2^17: (hidden, form), the 49 nodes on
# J ("j") or the 96 nodes on X·J ("x_prop")
WIDE_TIMES = ((20, "j"), (64, "j"), (100, "j"), (128, "j"), (128, "x_prop"))
# the wide rollout's head-TF32 instances: checked at these hidden widths,
# timed at these (HP 32, 64, 128)
TF32_WIDTHS = (20, 64, 128)
TF32_TIMED = (32, 64, 128)
# B1's and B2's head-TF32 instances: checked at these hidden widths, timed
# at the first
TF32_NARROW = (21, 8)
# SASS classes: MUFU is the accurate tanhf's and expf's special-function
# unit, LOP3 and IADD3 the integer halves of a TF32 rounding or split
CLASSES = {"FFMA": "fp32", "FADD": "fp32", "FMUL": "fp32", "MUFU": "mufu",
           "HMMA": "hmma", "LDS": "lds", "STS": "sts", "SHFL": "shfl",
           "BAR": "bar", "LDG": "ldg", "STG": "stg", "LDL": "local",
           "STL": "local", "LOP3": "lop3", "IADD3": "iadd3", "F2F": "cvt",
           "I2F": "cvt", "F2I": "cvt"}


def build(csrc: Path, names=NAMES) -> dict:
    """{name: loaded library} of the kernels ``names`` built from
    ``csrc``."""
    from deepfbsdejsolvers_torch.ops import _build

    _build.build(names, csrc)
    return {n: ctypes.CDLL(str(_build.library_path(n, csrc))) for n in names}


def ops_module(csrc: Path, name: str):
    """The ``ops/<name>.py`` beside ``csrc``, loaded as a module of its own
    (this checkout's is the package's)."""
    from deepfbsdejsolvers_torch.ops import _build

    if csrc == _build.CSRC:
        return importlib.import_module(f"deepfbsdejsolvers_torch.ops.{name}")
    path = csrc.parent / "ops" / f"{name}.py"
    # a module name of its own for each version: chip_smoke.kernel_module
    # finds an operator's wrappers by its class's module
    tag = re.sub(r"\W", "_", str(csrc.parent.parent))
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}{tag}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


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


def sass(lib: Path) -> dict:
    """{kernel: [(address, opcode, branch target or None)]} from
    ``cuobjdump -sass``."""
    from deepfbsdejsolvers_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            kernels[name] = []
            continue
        m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if not (name and m):
            continue
        words = m.group(2).replace("{", " ").split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words:
            continue
        op = words[0].split(".")[0]
        target = re.search(r"BRA\S*\s.*?0x([0-9a-f]+)", m.group(2))
        kernels[name].append((int(m.group(1), 16), op,
                              int(target.group(1), 16) if target else None))
    return kernels


def counts(instrs) -> dict:
    c = {"all": len(instrs)}
    for _, op, _ in instrs:
        if op in CLASSES:
            c[CLASSES[op]] = c.get(CLASSES[op], 0) + 1
    return c


def loops(instrs):
    """[(depth, start, end, counts of the body without inner loops)] of the
    loops closed by backward branches, outermost first."""
    spans = sorted({(t, a) for a, op, t in instrs
                    if op == "BRA" and t is not None and t <= a},
                   key=lambda s: (s[0], -s[1]))
    out = []
    for start, end in spans:
        depth = sum(1 for s, e in spans if s <= start and end <= e) - 1
        inner = [(s, e) for s, e in spans if start <= s and e <= end
                 and (s, e) != (start, end)]
        body = [i for i in instrs if start <= i[0] <= end and not any(
            s <= i[0] <= e for s, e in inner)]
        out.append((depth, start, end, counts(body)))
    return out


def sass_key(mangled: str) -> str:
    """A kernel's name and its first two template arguments (its width and
    instance), by which its SASS is paired across builds, so that a
    variant's further template argument (say, paths a thread) does not
    split a pair."""
    from chip_smoke import kernel_name

    return re.sub(r"^(\w+<[^,>]+,[^,>]+),[^>]*>", r"\1>",
                  kernel_name(mangled))


def print_build(label: str, csrc: Path, names=NAMES) -> dict:
    """Print a build's ptxas report and SASS counts; returns {(library,
    ``sass_key``): (whole counts, [loop bodies' counts])}."""
    from chip_smoke import ptxas_lines
    from deepfbsdejsolvers_torch.ops import _build

    out = {}
    for n in names:
        lib = _build.library_path(n, csrc)
        for fn, line in ptxas_lines(_build.ptxas_log(lib).read_text()):
            print(f"{label} {n} {fn}: {line}")
        for kernel, instrs in sass(lib).items():
            print(f"{label} sass {kernel[:48]}: {counts(instrs)}")
            body = []
            for depth, start, end, c in loops(instrs):
                print(f"{label}   {'  ' * depth}loop {start:#x}-{end:#x} "
                      f"(depth {depth}) body {c}")
                body.append((depth, c))
            out[n, sass_key(kernel)] = (counts(instrs), body)
    return out


def compare_sass(reports: dict) -> None:
    """Whether each kernel's SASS counts, whole and per loop, equal the
    first build's."""
    first = next(iter(reports))
    for label, rep in reports.items():
        for key, (whole, body) in rep.items():
            other = reports[first].get(key)
            print(f"{label} sass {key[0]} {key[1]}: whole counts equal to "
                  f"{first}'s: {other is not None and other[0] == whole}; "
                  f"loop counts: {other is not None and other[1] == body}")


def wide_ab(C, dirs: dict) -> None:
    """``--wide``: the wide sweep pair of each build through its own
    ``ops/sweep.py``: checks, float64 distances, kernel times and the wide
    parity paths' steps, in turns."""
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    built = {label: build(csrc, WIDE_NAMES) for label, csrc in dirs.items()}
    pairs = {}
    for label, csrc in dirs.items():
        mod = ops_module(csrc, "sweep")
        pairs[label] = (mod.b3_wide_forward, mod.b4_wide_backward)
        print_build(label, csrc, WIDE_NAMES)
    order = list(built)
    for label in order:
        with using(built[label]):
            for name in WIDE_NAMES:
                for hp in (32, 64, 128):
                    smem, blocks = C.occupancy(name, hp)
                    print(f"{label} {name}<{hp}>: {smem} bytes of shared "
                          f"memory per block, {blocks} blocks per SM")

    # checks at each width, and float64 at F64_CHECK
    for h in C.WIDE_WIDTHS:
        case = C.WIDE_SWEEP_CHECKS[0]
        args, g = C.sweep_inputs(h, case[0], case[3], 100 + 10 * h)
        for label in order:
            print(f"{label} H={h} quadrature B={case[3]}:")
            with using(built[label]):
                checked(label, C.check_sweep, args, g, pairs[label])
        del args, g
    h, case = C.F64_CHECK
    args, g = C.sweep_inputs(h, case[0], case[3],
                             100 + 10 * h + C.WIDE_SWEEP_CHECKS.index(case),
                             case[1])
    for label in order:
        print(f"{label} H={h} {case[1]} MC nodes B={case[3]}:")
        with using(built[label]):
            checked(label, C.check_sweep, args, g, pairs[label])
            C.f64_distances(args, g, kernels=pairs[label])
    del args, g

    # kernel times, in turns
    for h, form in WIDE_TIMES:
        args, g = C.sweep_inputs(h, "quadrature", C.TRAIN_BATCH, 13,
                                 form=form)
        m = args[1].shape[0]
        times = {label: {"B3w": [], "B4w": []} for label in order}
        for label in order + order + order[::-1]:
            fwd, bwd = pairs[label]
            with using(built[label]):
                times[label]["B3w"].append(C.kernel_ms(lambda: fwd(*args),
                                                       10))
                times[label]["B4w"].append(C.kernel_ms(
                    lambda: bwd(*args, g), 10))
        for label in order:
            t = {k: v[1:] for k, v in times[label].items()}
            print(f"wide H={h} M={m} B={C.TRAIN_BATCH} {label}: " + ", ".join(
                f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items()))
        for k in ("B3", "B4"):
            b_ms, _ = C.bound(k, m, C.TRAIN_BATCH, h, 0)
            print(f"wide H={h} M={m} {k}w: FP32 bound {b_ms:.4f} ms, "
                  f"tensor-core bound "
                  f"{C.tc_floor(k, m, C.TRAIN_BATCH, h)[0]:.4f} ms")
        del args, g

    # the wide parity paths' training steps, in turns
    for path, which, h, _ in C.WIDE_PARITY:
        model = make_merton_default() if which == "merton" else (
            make_vg_default())
        solver = PricingSolver(model, "global", hidden=(h, h),
                               sweep_impl="pallas", device="cuda")
        params = solver.init_params(make_generator("cpu", C.SEED, 0))
        for t in param_leaves(params):
            t.requires_grad_(True)
        step = make_step(solver.build_loss(C.TRAIN_BATCH),
                         make_adam(params, 4e-4), params)
        gen = make_generator("cuda", C.SEED, 80 + h)
        times = {label: [] for label in order}
        for label in order + order + order[::-1]:
            with using(built[label]):
                times[label].append(C.cuda_ms(lambda: step(gen), reps=3,
                                              warmup=1))
        for label in order:
            t = times[label][1:]
            print(f"{path} step at batch {C.TRAIN_BATCH} {label}: "
                  f"{t[0]:.3f} / {t[1]:.3f} ms")
        del solver, params, step


@contextlib.contextmanager
def rollout_of(mod, libs: dict):
    """The port's rollout wrappers launch the kernels of ``libs`` with the
    B2w block count of ``mod`` (another version's ``ops/rollout.py``)
    inside, so the package's solvers train on that build as its own
    wrappers would launch it."""
    from deepfbsdejsolvers_torch.ops import rollout as R

    saved, blocks = R.b2_wide_blocks, mod.b2_wide_blocks
    if mod is not R:
        takes_tf32 = "tf32" in inspect.signature(blocks).parameters
        R.b2_wide_blocks = lambda batch, h, tf32=False: (
            blocks(batch, h, tf32) if takes_tf32 else blocks(batch, h))
    try:
        with using(libs):
            yield
    finally:
        if mod is not R:
            R.b2_wide_blocks = saved


def b2_on(op, inputs, res):
    """B2 of ``op``'s width on the residuals ``res`` = (x_N, y_N, xs, ys)
    of a B1 run, with unit cotangents, as ``chip_smoke.kernel_calls``
    launches it."""
    import chip_smoke as C

    R = C.kernel_module(op)
    gam, y0, tabs, dw, j = inputs
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, b1, w2, b2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    cot = torch.ones_like(res[2][0])
    return C.rollout_pair(op)[1](op.spec, weights, ktabs, dw, j, res[2],
                                 res[3], cot, cot)


def tf32_across(C, mods: dict, built: dict, model, kw, h: int,
                what: str) -> None:
    """The head-TF32 instances of each build at hidden ``h`` (N = 50 on
    2^14 + 37 paths) through its own ``ops/rollout.py``: ``check_kernels``,
    and whether B1's outputs equal the first build's bit for bit and B2's
    on the first build's B1 residuals (``what`` names the pair)."""
    order = list(built)
    m, inputs = C.rollout_case(model, kw, h, C.N_STEPS, C.CHECK_BATCH)
    outs, res = {}, None
    for label in order:
        op = mods[label].FusedRolloutOp(m, h, n_pieces=C.PIECES,
                                        head_precision="default")
        print(f"{label} head TF32 H={h} N={C.N_STEPS} B={C.CHECK_BATCH}:")
        with rollout_of(mods[label], built[label]):
            checked(label, C.check_kernels, op, m, inputs)
            fwd, _ = C.kernel_calls(op, inputs)
            outs[label] = fwd()
            res = res or outs[label]
            outs[label] = (*outs[label], b2_on(op, inputs, res))
    b1, b2 = what.split("/")
    for label in order:
        same = [torch.equal(a, b) for a, b in
                zip(outs[label], outs[order[0]])]
        print(f"{label} head TF32 H={h}: {b1} outputs (x_N, y_N, xs, ys) "
              f"bit-identical to {order[0]}'s: {all(same[:4])}; {b2}'s "
              f"output on the same residuals: {same[4]}")


def wide_rollout_ab(C, dirs: dict) -> None:
    """``--wide-rollout``: the wide rollout pair of each build through its
    own ``ops/rollout.py``: checks, float64 distances, kernel times and the
    wide fused speed steps, in turns."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    names = WIDE_ROLLOUT_NAMES + WIDE_NAMES
    built = {label: build(csrc, names) for label, csrc in dirs.items()}
    mods = {label: ops_module(csrc, "rollout") for label, csrc in dirs.items()}
    for label, csrc in dirs.items():
        print_build(label, csrc, names)
    order = list(built)
    for label in order:
        with using(built[label]):
            for name in WIDE_ROLLOUT_NAMES:
                for entry in (name, f"{name}_tf32"):
                    if not hasattr(built[label][name], f"{entry}_info"):
                        continue
                    for hp in (32, 64, 128):
                        smem, blocks = C.occupancy(name, hp, entry=entry)
                        print(f"{label} {entry}<{hp}>: {smem} bytes of "
                              f"shared memory per block, {blocks} blocks "
                              f"per SM")
    model, kw = C.speed_config()
    ops = lambda m, h, mode="highest": {label: mods[label].FusedRolloutOp(
        m, h, n_pieces=C.PIECES, head_precision=mode) for label in order}

    # checks at each width, B1w's outputs across builds, and float64 at
    # ROLLOUT_F64_CHECK
    for h in C.WIDE_WIDTHS:
        m, inputs = C.rollout_case(model, kw, h, C.N_STEPS, C.CHECK_BATCH)
        outs = {}
        for label, op in ops(m, h).items():
            print(f"{label} H={h} N={C.N_STEPS} B={C.CHECK_BATCH}:")
            with rollout_of(mods[label], built[label]):
                checked(label, C.check_kernels, op, m, inputs)
                fwd, bwd = C.kernel_calls(op, inputs)
                outs[label] = (*fwd(), bwd())
        for label in order:
            same = [torch.equal(a, b) for a, b in
                    zip(outs[label], outs[order[0]])]
            print(f"{label} H={h}: B1w outputs (x_N, y_N, xs, ys) "
                  f"bit-identical to {order[0]}'s: {all(same[:4])}; B2w's "
                  f"output: {same[4]}")
        del inputs, outs
    h, n, batch = C.ROLLOUT_F64_CHECK
    m, inputs = C.rollout_case(model, kw, h, n, batch)
    for label, op in ops(m, h).items():
        print(f"{label} H={h} N={n} B={batch} against float64:")
        with rollout_of(mods[label], built[label]):
            checked(label, C.rollout_f64_distances, op, m, inputs)
    del inputs

    # the head-TF32 instances: checks, and their outputs across builds
    # (B2w's on the first build's B1w residuals)
    for h in TF32_WIDTHS:
        tf32_across(C, mods, built, model, kw, h, "B1w/B2w")

    # kernel times, in turns
    for h in C.WIDE_WIDTHS:
        m, inputs = C.rollout_case(model, kw, h, C.N_STEPS, C.TRAIN_BATCH)
        calls = {}
        for label, op in ops(m, h).items():
            with rollout_of(mods[label], built[label]):
                calls[label] = C.kernel_calls(op, inputs)
        times = {label: {"B1w": [], "B2w": []} for label in order}
        for label in order + order + order[::-1]:
            fwd, bwd = calls[label]
            with rollout_of(mods[label], built[label]):
                times[label]["B1w"].append(C.kernel_ms(fwd, 20))
                times[label]["B2w"].append(C.kernel_ms(bwd, 20))
        for label in order:
            t = {k: v[1:] for k, v in times[label].items()}
            print(f"wide rollout H={h} N={C.N_STEPS} B={C.TRAIN_BATCH} "
                  f"{label}: " + ", ".join(
                      f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items()))
        for k in ("B1", "B2"):
            b_ms, _ = C.bound(k, C.N_STEPS, C.TRAIN_BATCH, h, C.PIECES)
            print(f"wide rollout H={h} {k}w: FP32 bound {b_ms:.4f} ms, "
                  f"tensor-core bound "
                  f"{C.tc_floor(k, C.N_STEPS, C.TRAIN_BATCH, h)[0]:.4f} ms")
        del inputs, calls

    # the head-TF32 instances' times beside the FP32 instances', in turns
    for h in TF32_TIMED:
        m, inputs = C.rollout_case(model, kw, h, C.N_STEPS, C.TRAIN_BATCH)
        calls = {}
        for mode in ("highest", "default"):
            for label, op in ops(m, h, mode).items():
                with rollout_of(mods[label], built[label]):
                    calls[label, mode] = C.kernel_calls(op, inputs)
        turns = list(calls)
        times = {key: {"B1w": [], "B2w": []} for key in turns}
        for key in turns + turns + turns[::-1]:
            fwd, bwd = calls[key]
            with rollout_of(mods[key[0]], built[key[0]]):
                times[key]["B1w"].append(C.kernel_ms(fwd, 20))
                times[key]["B2w"].append(C.kernel_ms(bwd, 20))
        for (label, mode), t in times.items():
            t = {k: v[1:] for k, v in t.items()}
            print(f"wide rollout {mode} H={h} N={C.N_STEPS} "
                  f"B={C.TRAIN_BATCH} {label}: " + ", ".join(
                      f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in t.items()))
        for k in ("B1", "B2"):
            print(f"wide rollout H={h} {k}w: tensor-core bound "
                  f"{C.tc_floor(k, C.N_STEPS, C.TRAIN_BATCH, h)[0]:.4f} ms")
        del inputs, calls

    # the wide fused speed steps, FP32 and with TF32 heads, in turns
    for h, mode in [(h, mode) for mode in ("highest", "default")
                    for h in C.WIDE_TRAIN_WIDTHS]:
        solver = PricingSolver(model, "global", hidden=(h, h),
                               fused_head_precision=mode, **kw)
        params = solver.init_params(make_generator("cpu", C.SEED, 0))
        for t in param_leaves(params):
            t.requires_grad_(True)
        step = make_step(solver.build_loss(C.TRAIN_BATCH),
                         make_adam(params, 4e-4), params)
        gen = make_generator("cuda", C.SEED, 60 + h)
        times = {label: [] for label in order}
        for label in order + order + order[::-1]:
            with rollout_of(mods[label], built[label]):
                times[label].append(C.cuda_ms(lambda: step(gen), reps=5))
        for label in order:
            t = times[label][1:]
            print(f"speed step at hidden ({h}, {h}), head {mode}, batch "
                  f"{C.TRAIN_BATCH} {label}: {t[0]:.3f} / {t[1]:.3f} ms")
        del solver, params, step


def version_label(path: str, i: int) -> str:
    """The name of the directory that holds another version's
    ``deepfbsdejsolvers_torch`` (``_archive/pr13/...`` → ``pr13``), else
    ``against<i>``."""
    parts = Path(path).resolve().parts
    if "deepfbsdejsolvers_torch" in parts[1:]:
        return parts[parts.index("deepfbsdejsolvers_torch") - 1]
    return f"against{i}"


# the builds that failed a check, by label: the exit code is non-zero if any
FAILED = []


def checked(label: str, fn, *args):
    """``fn(*args)`` (a ``chip_smoke.py`` check, which exits on a failure);
    another build's failure is printed and recorded and its times are still
    taken, this checkout's ends the run."""
    try:
        return fn(*args)
    except SystemExit:
        if label == "this":
            raise
        print(f"{label}: FAILED the check above; its times are still taken")
        FAILED.append(label)
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", nargs="+", default=[],
                    help="other versions' csrc directories (all but "
                         "--wide take several)")
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="paths at which B1/B2 are timed (default 2^17)")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--wide", action="store_true",
                       help="A/B the wide sweep pair B3w/B4w instead of "
                            "B1–B4")
    which.add_argument("--wide-rollout", action="store_true",
                       help="A/B the wide rollout pair B1w/B2w instead of "
                            "B1–B4")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import chip_smoke as C
    from deepfbsdejsolvers_torch.ops import _build
    from deepfbsdejsolvers_torch.ops import sweep as S

    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {"this": _build.CSRC}
    if len(opts.against) > 1 and opts.wide:
        print("kernel_ab: --wide takes one --against", file=sys.stderr)
        return 2
    if opts.against:
        dirs = {**{version_label(d, i): Path(d).resolve()
                   for i, d in enumerate(opts.against)}, **dirs}
    if opts.wide or opts.wide_rollout:
        (wide_ab if opts.wide else wide_rollout_ab)(C, dirs)
        print_smi()
        return verdict()
    built = {label: build(csrc) for label, csrc in dirs.items()}
    mods = {label: ops_module(csrc, "rollout") for label, csrc in dirs.items()}
    order = list(built)
    compare_sass({label: print_build(label, csrc)
                  for label, csrc in dirs.items()})
    for label in order:
        with using(built[label]):
            for entry in ("rollout_fwd", "rollout_fwd_tf32"):
                if not hasattr(built[label]["rollout_fwd"], f"{entry}_info"):
                    continue
                for h in TF32_NARROW:
                    smem, blocks = C.occupancy("rollout_fwd", h, entry=entry)
                    regs = ptxas_registers(dirs[label], h,
                                           entry.endswith("tf32"))
                    print(f"{label} {entry}<{h}>: {regs} registers, {smem} "
                          f"bytes of static shared memory per block, "
                          f"{blocks} blocks per SM")
            for entry in ("rollout_bwd", "rollout_bwd_tf32"):
                if not hasattr(built[label]["rollout_bwd"], f"{entry}_info"):
                    continue
                for h in TF32_NARROW:
                    smem, blocks = C.occupancy("rollout_bwd", h, C.PIECES,
                                               entry=entry)
                    print(f"{label} {entry}<{h}>: {smem} bytes of shared "
                          f"memory per block, {blocks} blocks per SM")

    # B1/B2: checks, and B1's outputs bit for bit across builds
    model, kw = C.speed_config()
    m, inputs = C.rollout_case(model, kw, C.HIDDEN, C.N_STEPS, C.CHECK_BATCH)
    b1_outs, b2_outs = {}, {}
    for label in order:
        op = mods[label].FusedRolloutOp(m, C.HIDDEN, n_pieces=C.PIECES)
        print(f"{label} rollout N={C.N_STEPS} B={C.CHECK_BATCH}:")
        with using(built[label]):
            checked(label, C.check_kernels, op, m, inputs)
            fwd, bwd = C.kernel_calls(op, inputs)
            b1_outs[label], b2_outs[label] = fwd(), bwd()
    for label in order:
        same = all(torch.equal(a, b) for a, b in
                   zip(b1_outs[label], b1_outs[order[0]]))
        same2 = torch.equal(b2_outs[label], b2_outs[order[0]])
        print(f"{label}: B1 outputs (x_N, y_N, xs, ys) bit-identical to "
              f"{order[0]}'s: {same}; B2's output: {same2}")
    del inputs, b1_outs, b2_outs
    for h in TF32_NARROW:
        tf32_across(C, mods, built, model, kw, h, "B1/B2")

    # B3/B4: checks, and B3's output bit for bit across builds
    outs = {}
    for tag, (node_set, batch) in enumerate((("quadrature", C.CHECK_BATCH),
                                             ("mc", 2**12 + 37))):
        args, g = C.sweep_inputs(C.HIDDEN, node_set, batch, tag)
        for label in order:
            print(f"{label} {node_set} B={batch}:")
            with using(built[label]):
                checked(label, C.check_sweep, args, g)
                outs[label, node_set] = S.b3_forward(*args)
    for label in order:
        same = [torch.equal(outs[label, k], outs[order[0], k])
                for k in ("quadrature", "mc")]
        print(f"{label}: B3 output bit-identical to {order[0]}'s: {same}")

    # times of both instances at both widths, in turns
    for h, batch in [(h, b) for h in TF32_NARROW
                     for b in opts.batch or (C.TRAIN_BATCH,)]:
        m, inputs = C.rollout_case(model, kw, h, C.N_STEPS, batch)
        calls = {}
        for mode in ("highest", "default"):
            for label in order:
                with using(built[label]):
                    calls[label, mode] = C.kernel_calls(
                        mods[label].FusedRolloutOp(m, h, n_pieces=C.PIECES,
                                                   head_precision=mode),
                        inputs)
        turns = list(calls)
        times = {key: {"B1": [], "B2": []} for key in turns}
        for key in turns + turns + turns[::-1]:
            with using(built[key[0]]):
                fwd, bwd = calls[key]
                times[key]["B1"].append(C.kernel_ms(fwd, 20))
                times[key]["B2"].append(C.kernel_ms(bwd, 20))
        for (label, mode), t in times.items():
            t = {k: v[1:] for k, v in t.items()}
            print(f"rollout {mode} N={C.N_STEPS} B={batch} H={h} "
                  f"P={C.PIECES} {label}: B1 {t['B1'][0]:.4f} / "
                  f"{t['B1'][1]:.4f} ms, B2 {t['B2'][0]:.4f} / "
                  f"{t['B2'][1]:.4f} ms")
        del inputs, calls
    for node_set in ("quadrature", "mc"):
        args, g = C.sweep_inputs(C.HIDDEN, node_set, C.TRAIN_BATCH, 10)
        reps = 20 if node_set == "quadrature" else 3
        times = {label: {"B3": [], "B4": []} for label in order}
        for label in order + order + order[::-1]:
            with using(built[label]):
                times[label]["B3"].append(C.kernel_ms(
                    lambda: S.b3_forward(*args), reps))
                times[label]["B4"].append(C.kernel_ms(
                    lambda: S.b4_backward(*args, g), reps))
        for label in order:
            t = {k: v[1:] for k, v in times[label].items()}
            print(f"{node_set} M={args[1].shape[0]} B={C.TRAIN_BATCH} "
                  f"H={C.HIDDEN} {label}: B3 {t['B3'][0]:.4f} / "
                  f"{t['B3'][1]:.4f} ms, B4 {t['B4'][0]:.4f} / "
                  f"{t['B4'][1]:.4f} ms")
        del args, g
    print_smi()
    return verdict()


def verdict() -> int:
    """0 when every build passed every check, else 1 (this checkout's
    failure has ended the run already)."""
    if FAILED:
        print(f"kernel_ab: checks failed for {sorted(set(FAILED))}")
    return 1 if FAILED else 0


def ptxas_registers(csrc: Path, h: int, tf32: bool) -> str:
    """B1's registers at hidden ``h`` in an instance, from ``csrc``'s
    build's ptxas report."""
    from chip_smoke import ptxas_lines
    from deepfbsdejsolvers_torch.ops import _build

    log = _build.ptxas_log(_build.library_path("rollout_fwd", csrc))
    want = f"fwd_kernel<{h},{'true' if tf32 else 'false'}"
    for fn, line in ptxas_lines(log.read_text()):
        m = re.search(r"Used (\d+) registers", line)
        if m and fn.startswith(want):
            return m.group(1)
    return "?"


def print_smi() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")


if __name__ == "__main__":
    code = main()
    # leave without the interpreter's and the libraries' teardown, so that
    # the exit code is the checks' alone (module docstring)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
