"""Smoke run of the PyTorch port on one CUDA card: build, check, train.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the CUDA kernels from ``deepfbsdejsolvers_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version at full width
   (hidden 21, N = 50, the real hoisted tables of the Merton speed
   configuration) on a ragged batch of 2^14 + 37 paths: B1's (x_N, y_N),
   B2's gradients through ``FusedRollout``, and B2 run twice bit for bit;
   then the same at hidden 8, N = 7, 1000 paths;
3. train Merton global deep-BSDE through ``SolverGlobalFBSDE`` with
   ``fused_rollout=True`` at batch 2^17 for 2 outer epochs of 10 Adam steps,
   with the kernels' launch counters set to 0 just before and read just
   after; then time a training step and each kernel against its plain
   version at that batch, with CUDA events after a warm-up.

The line before the last holds the card's name and power limit
(nvidia-smi), the one before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

SEED = 0
N_STEPS, HIDDEN, PIECES = 50, 21, 8
CHECK_BATCH = 2**14 + 37
TRAIN_BATCH = 2**17
FWD_ABS_TOL, LOSS_REL_TOL, GRAD_REL_TOL = 1e-4, 1e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def speed_config():
    """The Merton speed configuration through the fused rollout (the JAX
    package's ``bench.py --fused``): (model, solver keyword arguments)."""
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec

    model = make_merton_default(jump_sampler="icdf", price_mode="chebyshev")
    return model, dict(
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise", fused_rollout=True,
        device="cuda")


def cuda_ms(fn, reps: int, warmup: int = 2, setup=None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, each between
    two CUDA events; ``setup()`` runs untimed before each."""
    for _ in range(warmup):
        fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def work(kernel: str, n: int, batch: int, h: int, p: int):
    """(FLOPs, bytes) the kernel's function needs on these shapes, counted
    from the code per path and step; each tanh counts as one operation.
    B1: the head 2H² + 10H, 2H tanh, three degree-7 Clenshaw evaluations of
    24 FLOPs, ~40 FLOPs of piece lookup, BSDE and walk update; dW and J read,
    xs and ys written.  B2: the head recomputed (2H² + 10H, 2H tanh), its
    backward (2H² + 4H, which also gives dΓ/dx as Σ_h W1[x, h]·dp1[h]), the
    parameter sums (2H² + 12H), three Clenshaw evaluations with derivative
    (48 each), the table sums (3·8·2) and ~50 FLOPs of recurrence; xs, ys,
    dW and J read."""
    ps = n * batch
    table_bytes = 3 * n * p * 8 * 4
    if kernel == "B1":
        flops = ps * (2 * h * h + 12 * h + 3 * 24 + 40)
        nbytes = 16 * ps + 8 * batch + table_bytes
    else:
        flops = ps * (6 * h * h + 28 * h + 3 * 48 + 48 + 50)
        nbytes = 16 * ps + 8 * batch + 2 * table_bytes
    return flops, nbytes


def bound(kernel, n, batch, h, p):
    flops, nbytes = work(kernel, n, batch, h, p)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")


def rollout_inputs(solver, params, batch, gen):
    """Detached leaves of one rollout at ``batch``: the Γ head's tensors, y0,
    and the hoisted tables of a fresh noise draw."""
    dw, j = solver._prenoise(gen, batch)
    with torch.no_grad():
        tables = solver._hoist_tables(params, (dw, j))
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    gam = {"W": [leaf(w) for w in params["gam"]["W"]],
           "b": [leaf(b) for b in params["gam"]["b"]]}
    tabs = {k: (leaf(v) if k in ("cc", "pc", "zc") else v.detach())
            for k, v in tables.items()}
    return gam, leaf(params["uz"]["y0"]), tabs, dw, j


def grad_leaves(gam, y0, tabs):
    return [*gam["W"], *gam["b"], y0, tabs["cc"], tabs["pc"], tabs["zc"]]


def check_kernels(op, model, inputs) -> dict:
    """Phase 2: each kernel against the plain rollout on the same inputs."""
    from deepfbsdejsolvers_torch.ops import rollout as R

    gam, y0, tabs, dw, j = inputs
    loss = lambda x, y: torch.mean(torch.square(y - model.payoff(x)))
    with torch.no_grad():
        xk, yk = op(gam, y0, tabs, dw, j)
        xp, yp = op.plain(gam, y0, tabs, dw, j)
    fwd_err = max(float((xk - xp).abs().max()), float((yk - yp).abs().max()))
    loss_rel = abs(float(loss(xk, yk)) - float(loss(xp, yp))) / abs(
        float(loss(xp, yp)))
    print(f"B1 vs plain: max|Δ(x_N, y_N)| {fwd_err:.3e} (tol {FWD_ABS_TOL}),"
          f" loss rel {loss_rel:.3e} (tol {LOSS_REL_TOL})")
    if not (math.isfinite(fwd_err) and fwd_err <= FWD_ABS_TOL
            and loss_rel <= LOSS_REL_TOL):
        fail("B1 disagrees with rollout_plain")

    leaves = grad_leaves(gam, y0, tabs)
    before = R.b2_backward.launches
    gk = torch.autograd.grad(loss(*op(gam, y0, tabs, dw, j)), leaves)
    gk2 = torch.autograd.grad(loss(*op(gam, y0, tabs, dw, j)), leaves)
    if R.b2_backward.launches - before != 2:
        fail("the gradient check did not run kernel B2")
    gp = torch.autograd.grad(loss(*op.plain(gam, y0, tabs, dw, j)), leaves)
    num = math.sqrt(sum(float(torch.sum((a - b) ** 2))
                        for a, b in zip(gk, gp)))
    den = math.sqrt(sum(float(torch.sum(b ** 2)) for b in gp))
    grad_rel = num / den
    grad_abs = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    print(f"B2 vs autograd of plain: grad global-norm rel {grad_rel:.3e} "
          f"(tol {GRAD_REL_TOL}), max abs {grad_abs:.3e}; rerun "
          f"bit-identical: {same}")
    if not (math.isfinite(grad_rel) and grad_rel <= GRAD_REL_TOL):
        fail("B2 gradients disagree with autograd of rollout_plain")
    if not same:
        fail("two B2 runs on the same inputs differ")
    return {"B1": {"max_abs_err": fwd_err, "rel_err": loss_rel},
            "B2": {"max_abs_err": grad_abs, "rel_err": grad_rel}}


def time_kernels(op, inputs) -> dict:
    """Each kernel's device time and its plain version's, at the inputs'
    shapes: B1 with residuals as in training against the plain forward
    under autograd, B2 against autograd's backward of the plain forward."""
    from deepfbsdejsolvers_torch.ops import rollout as R

    gam, y0, tabs, dw, j = inputs
    spec = op.spec
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, b1, w2, b2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    y0d = y0.detach()
    _, _, xs, ys = R.b1_forward(spec, weights, y0d, ktabs, dw, j, save=True)
    cot = torch.ones_like(xs[0])
    out = {"B1": {"ms": cuda_ms(lambda _: R.b1_forward(
               spec, weights, y0d, ktabs, dw, j, save=True), reps=20)},
           "B2": {"ms": cuda_ms(lambda _: R.b2_backward(
               spec, weights, ktabs, dw, j, xs, ys, cot, cot), reps=20)}}
    leaves = grad_leaves(gam, y0, tabs)
    plain_loss = lambda: torch.sum(sum(op.plain(gam, y0, tabs, dw, j)))
    out["B1"]["plain_ms"] = cuda_ms(lambda _: plain_loss(), reps=5)
    out["B2"]["plain_ms"] = cuda_ms(
        lambda l: torch.autograd.grad(l, leaves), reps=5, setup=plain_loss)
    return out


def profile_steps(step, gen, step_ms: float, steps: int = 3) -> None:
    """Device time per training step by kernel (torch.profiler), and the
    device's idle share against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(gen)
        torch.cuda.synchronize()
    # device-side kernels and copies only: a user annotation such as
    # "Optimizer.step#Adam.step" spans kernels counted on their own (a
    # kernel's demangled name may hold "#" too, inside a lambda's "{...#1}",
    # but always with a "(" or "<")
    def annotation(e):
        return getattr(e, "is_user_annotation", False) or (
            "#" in e.key and not any(c in e.key for c in "(<"))

    rows = [(e.self_device_time_total / 1e3 / steps, e.count / steps, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and not annotation(e)]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile: device busy {busy:.3f} ms of a {step_ms:.3f} ms step "
          f"(idle share {1 - busy / step_ms:.3f}), "
          f"{sum(r[1] for r in rows):.0f} device ops per step")
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:8.4f} ms  x{count:5.1f}  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepfbsdejsolvers_torch.ops import _build
    from deepfbsdejsolvers_torch.ops import rollout as R
    from deepfbsdejsolvers_torch.solvers.api import SolverGlobalFBSDE
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    # 1. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name in _build.KERNEL_SOURCES:
        log = (_build.BUILD_DIR / f"{name}.ptxas.txt")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # 2. kernel vs plain on a ragged batch: full width, then the other
    # width the kernels are built for on a short rollout
    model, kw = speed_config()
    for hidden, n, batch in ((HIDDEN, N_STEPS, CHECK_BATCH), (8, 7, 1000)):
        m = dataclasses.replace(model, N=n)
        solver = PricingSolver(m, "global", hidden=(hidden, hidden), **kw)
        params = solver.init_params(make_generator("cpu", SEED, 0))
        with torch.no_grad():   # non-zero biases, so every path is exercised
            gb = make_generator("cpu", SEED, 2)
            for b in params["gam"]["b"]:
                b.copy_(0.1 * torch.randn(b.shape, generator=gb))
        print(f"check at H={hidden}, N={n}, B={batch}:")
        result = check_kernels(
            R.FusedRolloutOp(m, hidden, n_pieces=PIECES), m, rollout_inputs(
                solver, params, batch, make_generator("cuda", SEED, 3)))
        if hidden == HIDDEN:
            check = result
    op = R.FusedRolloutOp(model, HIDDEN, n_pieces=PIECES)

    # 3. the main path: training through the facade
    trainer = SolverGlobalFBSDE(model, lrate=4e-4, hidden=(HIDDEN, HIDDEN),
                                seed=SEED, **kw)
    y0_init = float(trainer.core.init_params(
        make_generator("cpu", SEED, 0))["uz"]["y0"])
    R.b1_forward.launches = 0
    R.b2_backward.launches = 0
    y0s, duration = trainer.train(TRAIN_BATCH, TRAIN_BATCH, 10, 2,
                                  verbose=True)
    launches = {"B1": R.b1_forward.launches, "B2": R.b2_backward.launches}
    print(f"train: launches {launches}, Y0 {y0_init:.6f} -> {y0s}, losses "
          f"{trainer.lossList}, {duration:.3f} s")
    if not all(math.isfinite(v) for v in trainer.lossList + y0s):
        fail("training produced a non-finite loss or Y0")
    if y0s[-1] == y0_init:
        fail("Y0 did not move in training")
    if min(launches.values()) < 20:
        fail(f"a kernel of the main path launched < 20 times: {launches}")

    params = trainer.params
    loss_fn = trainer.core.build_loss(TRAIN_BATCH)
    step = make_step(loss_fn, make_adam(params, 4e-4), params)
    gen = make_generator("cuda", SEED, 4)
    step_ms = cuda_ms(lambda _: step(gen), reps=10)
    rate = TRAIN_BATCH * N_STEPS / (step_ms * 1e-3)
    print(f"train step: {step_ms:.3f} ms at batch {TRAIN_BATCH}, N "
          f"{N_STEPS} ({rate:.4g} paths·steps/s)")
    profile_steps(step, gen, step_ms)
    times = time_kernels(op, rollout_inputs(
        trainer.core, params, TRAIN_BATCH, make_generator("cuda", SEED, 5)))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    sources = {"B1": ("rollout_fwd", 311), "B2": ("rollout_bwd", 352)}
    record = []
    for k, (src, line) in sources.items():
        b_ms, b_by = bound(k, N_STEPS, TRAIN_BATCH, HIDDEN, PIECES)
        record.append({
            "name": f"{k} {src}", "route": "cuda",
            "source": f"deepfbsdejsolvers_torch/csrc/{src}.cu",
            "replaces": f"deepfbsdejsolvers_tpu/ops/pallas_rollout.py:{line}",
            "launches": launches[k], "max_abs_err": check[k]["max_abs_err"],
            "rel_err": check[k]["rel_err"], "check": "pass",
            "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": N_STEPS, "B": TRAIN_BATCH, "H": HIDDEN,
                      "P": PIECES}})
        print(f"{k}: {times[k]['ms']:.4f} ms (plain {times[k]['plain_ms']:.3f}"
              f" ms, bound {b_ms:.4f} ms by {b_by})")
    print(json.dumps({"kernels": record, "train_step_ms": step_ms,
                      "paths_steps_per_s": rate}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
