"""The benchmark's run of one cell: build it from its files, train through
the program's own step, time the window or trace it, and hold the first
steps to the plain reference.

A cell is ``workloads/<cell>.json``: the configuration it runs
(``configs/<config>.json``), the model's and the solver's keyword arguments
(the program's public constructors, read as data), the batch, how many steps
the traced run traces, how many steps the reference follows, and the
limits of the numbers compared.  Its metrics are those of ``BENCHMARK.json``
that name it or name no cell; each is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark import trace
from benchmark.reference import training as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfbsdejsolvers_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str) -> tuple:
    """(workload, configuration) dicts of cell ``name``."""
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def cell_metrics(bench: dict, name: str, kind: str) -> List[dict]:
    """The entries of ``bench[kind]`` that cell ``name`` reports."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def seed_of(seed: int, purpose: int) -> int:
    """A 63-bit seed derived from (seed, purpose)."""
    return int(np.random.SeedSequence([abs(int(seed)), int(seed < 0),
                                       purpose]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _resolve(spec: str):
    module, attr = spec.split(":")
    return getattr(importlib.import_module(module), attr)


# ---------------------------------------------------------------- the program
def build_program(cfg: dict, wl: dict, device, solver_overrides=None):
    """(model, solver) of the cell through the program's public
    constructors named by the configuration."""
    prog = cfg["program"]
    kwargs = {arg: cfg[key] for arg, key in prog["args"].items()}
    coupling_fn, coupling_key = prog["coupling"]
    kwargs["coupling"] = _resolve(coupling_fn)(cfg[coupling_key])
    kwargs.update(wl.get("model", {}))
    model = _resolve(prog["model"])(**kwargs)
    solver_kw = dict(wl["solver"])
    solver_kw.update(solver_overrides or {})
    comp = _resolve(prog["compensator"])(**solver_kw.pop("compensator"))
    scheme = solver_kw.pop("scheme")
    solver = _resolve(prog["solver"])(
        model, scheme, hidden=tuple(cfg["hidden"]),
        activation=cfg["activation"], compensator=comp, device=str(device),
        **solver_kw)
    return model, solver


def make_params(cfg: dict, jump_diffusion: bool, seed: int, device) -> dict:
    """The initial weights from ``seed``, drawn on ``device`` in one call:
    Glorot-normal kernels, zero biases, a unit-normal Y0."""
    layout = ref.net_layout(cfg, jump_diffusion)
    shapes = []
    for head in sorted(layout):
        n_in, hidden, n_out, _ = layout[head]
        sizes = (n_in, *hidden, n_out)
        shapes += [(head, a, b) for a, b in zip(sizes[:-1], sizes[1:])]
    total = sum(a * b for _, a, b in shapes) + len(layout)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, 1))
    flat = torch.randn((total,), generator=g, device=device)
    params = {h: {"W": [], "b": []} for h in layout}
    at = 0
    for head, a, b in shapes:
        std = math.sqrt(2.0 / (a + b))
        params[head]["W"].append((std * flat[at:at + a * b]).view(a, b))
        params[head]["b"].append(torch.zeros((b,), device=device))
        at += a * b
    for head in sorted(layout):
        if layout[head][3]:
            params[head]["y0"] = flat[at].clone()
        at += 1
    return params


def clone_params(params: dict) -> dict:
    return {h: {k: ([t.detach().clone() for t in v] if isinstance(v, list)
                    else v.detach().clone()) for k, v in p.items()}
            for h, p in params.items()}


def check_layout(solver, cfg: dict, jump_diffusion: bool) -> None:
    """Raise unless the program's nets are the configuration's."""
    layout = ref.net_layout(cfg, jump_diffusion)
    specs = solver.net_specs()
    got = {k: (s.n_in, tuple(s.hidden), s.n_out, bool(s.with_y0))
           for k, s in specs.items()}
    if got != layout:
        raise RuntimeError(f"the program's nets {got} are not the "
                           f"configuration's {layout}")


# -------------------------------------------------------------------- faults
def half_batch(solver, batch: int) -> Callable:
    """A broken loss for the fault check: it draws the whole batch's noise
    and takes the mean over its first half only.  The path columns of dW
    and J are cut; a Monte-Carlo compensator's node draws, one row of
    ``n_mc`` a step whatever the batch, are left whole."""
    half = batch // 2
    from_noise = solver.build_loss_from_noise(half)

    def loss(params, generator):
        dw, j, *draws = solver._prenoise(generator, batch, solver.noise_rows)
        return from_noise(params, (dw[:, :half] if dw.shape[1] else dw,
                                   j[:, :half], *draws))

    return loss


@dataclasses.dataclass
class Plan:
    """How a run departs from the timed path, for the checks of the
    comparison itself: ``fault`` ("frozen": the step returns its state
    unchanged; "half_batch": half the batch left out), or ``control``
    ("program_tf32": the program's own lower-precision path, its solver
    overrides ``control_solver`` in the cell's file).  The other control,
    the reference in TF32, is ``reference_run(..., tf32=True)``."""

    fault: Optional[str] = None
    control: Optional[str] = None


# ---------------------------------------------------------------- one run
def process_start_s() -> float:
    """Seconds since this process started (from /proc; else since the
    harness was imported)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Cell:
    """One cell's program, built and driven through its first steps."""

    def __init__(self, name: str, seed: int, device="cuda",
                 plan: Optional[Plan] = None, batch: Optional[int] = None):
        self.name, self.seed = name, int(seed)
        self.plan = plan or Plan()
        self.wl, self.cfg = load_cell(name)
        self.device = torch.device(device)
        self.batch = int(batch or self.wl["batch"])
        overrides = {}
        if self.plan.control == "program_tf32":
            overrides = self.wl["control_solver"]
        self.times = {}
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.init()
            torch.empty((1,), device=self.device)
        self.times["card"] = time.perf_counter() - t0
        self.model, self.solver = build_program(self.cfg, self.wl,
                                                self.device, overrides)
        self.times["program"] = time.perf_counter() - t0
        self.jd = self.solver.jump_diff
        check_layout(self.solver, self.cfg, self.jd)
        self.params0 = make_params(self.cfg, self.jd, self.seed, self.device)
        self.times["weights"] = time.perf_counter() - t0
        from deepfbsdejsolvers_torch.nets.mlp import param_leaves
        from deepfbsdejsolvers_torch.solvers.train import make_adam, make_step

        self.times["train imported"] = time.perf_counter() - t0

        self.params = clone_params(self.params0)
        self.leaves = param_leaves(self.params)
        self.names = [n for n, _ in ref.leaves(self.params)]
        self.opt = make_adam(self.params, float(self.cfg["learning_rate"]))
        if self.plan.fault == "frozen":
            self.opt.step = lambda *a, **k: None
        loss = (half_batch(self.solver, self.batch)
                if self.plan.fault == "half_batch"
                else self.solver.build_loss(self.batch))
        self.step = make_step(loss, self.opt, self.params)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed_of(self.seed, 2))
        self.gen_state = self.gen.get_state()
        self.times["step built"] = time.perf_counter() - t0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def first_steps(self, n: int = 3) -> dict:
        """The first ``n`` steps through the window's own call: their losses,
        the first gradient as Adam holds it, and the weights after each."""
        losses, grads, after, times = [], None, [], []
        for k in range(n):
            t0 = time.perf_counter()
            losses.append(float(self.step(self.gen)))
            times.append(time.perf_counter() - t0)
            if k == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                grads = {}
                for name, p in zip(self.names, self.leaves):
                    st = self.opt.state.get(p, {})
                    m = st.get("exp_avg")
                    grads[name] = (torch.zeros_like(p) if m is None
                                   else m.detach() / (1.0 - beta1))
            after.append({nm: p.detach().clone()
                          for nm, p in zip(self.names, self.leaves)})
        self.sync()
        return {"losses": losses, "grads": grads, "after": after,
                "seconds": times}

    def free(self):
        """Drop the program's state, keeping what the comparison needs."""
        for attr in ("step", "opt", "params", "leaves", "solver", "model"):
            if hasattr(self, attr):
                delattr(self, attr)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_run(cell: Cell, steps: int, tf32: bool = False) -> dict:
    """The reference's first ``steps`` steps from the cell's weights and
    generator state (with ``tf32``: its products in TF32, the control):
    {"losses", "grads" (the first step's), "delta" (the weights'
    change)}."""
    wl = cell.wl
    scheme = ref.Scheme(cell.cfg, wl.get("model", {}), wl["solver"],
                        cell.batch, cell.device,
                        block=int(wl.get("reference_block", 1 << 16)),
                        tf32_products=tf32)
    losses, grads, after = ref.follow(scheme, cell.params0, cell.gen_state,
                                      steps, cell.cfg)
    p0 = dict(ref.leaves(cell.params0))
    return {"losses": losses, "grads": grads,
            "delta": {n: after[n] - p0[n] for n in after}}


def program_run(cell: Cell, first: dict, steps: int) -> dict:
    """The program's first ``steps`` steps, as ``reference_run`` gives
    the reference's."""
    p0 = dict(ref.leaves(cell.params0))
    after = first["after"][steps - 1]
    return {"losses": first["losses"][:steps], "grads": first["grads"],
            "delta": {n: after[n] - p0[n] for n in after}}


def readings(run: dict, against: dict) -> dict:
    """The numbers compared of ``run`` against the reference's run."""
    return ref.compare(run["losses"], run["grads"], run["delta"],
                       against["losses"], against["grads"],
                       against["delta"])


def load_metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``, or
    for a metric split by cells (``<base>.<part>``, each part moving its own
    end-to-end metric) ``metrics/<base>.py``'s where the part has no file
    of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    wl: dict
    cfg: dict
    batch: int
    n_nodes: int
    setup_s: float = float("nan")
    window_s: float = float("nan")
    steps: int = 0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    window_peak_bytes: int = 0
    trace: Optional[trace.TraceSummary] = None
    plain_step_s: float = float("nan")


def node_count(wl: dict, cfg: dict) -> int:
    """Nodes of the cell's compensator: its quadrature's, or a Monte-Carlo
    compensator's draws a step."""
    comp = wl["solver"]["compensator"]
    if comp.get("kind") == "mc":
        return int(comp["n_mc"])
    if cfg["model"] == "merton":
        return 1 + int(comp["n_poisson_max"]) * int(comp["n_hermite"])
    return int(comp["n_laguerre"]) * int(comp["n_hermite"])


class _HostMarks:
    """Step boundaries by the host clock, where there is no card (the
    harness's own tests)."""

    def __init__(self):
        self.t = time.perf_counter()

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return 1e3 * (other.t - self.t)


def timed_window(cell: Cell, seconds: float, step_s: float) -> dict:
    """Steps back to back for ``seconds`` of host clock, a CUDA event at
    each step boundary, no host sync inside; the window ends when the last
    step issued has finished."""
    cuda = cell.device.type == "cuda"
    mark = ((lambda: torch.cuda.Event(enable_timing=True)) if cuda
            else _HostMarks)
    events = [mark() for _ in range(int(2 * seconds / max(step_s, 1e-4))
                                    + 16)]
    losses, issued = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    cell.sync()
    t0 = time.perf_counter()
    events[0].record()
    n = 0
    while True:
        losses.append(cell.step(cell.gen))
        n += 1
        if n >= len(events):
            events.append(mark())
        events[n].record()
        issued.append(time.perf_counter())
        if issued[-1] - t0 >= seconds:
            break
    cell.sync()
    t1 = time.perf_counter()
    ms = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    finite = torch.isfinite(torch.stack(losses)).cpu()
    return {"steps": n, "window_s": t1 - t0, "step_ms": ms,
            "issue_ms": list(1e3 * np.diff([t0] + issued)),
            "lead_ms": 1e3 * (t1 - issued[-1]),
            "failed": int((~finite).sum()),
            "peak": (int(torch.cuda.max_memory_allocated(cell.device))
                     if cuda else 0)}


# Host-clock seconds of the untraced steps that time a step beside a trace.
PLAIN_SECONDS = 1.0


def plain_step_s(cell: Cell, seconds: float) -> float:
    """Seconds a step of steps run back to back without the profiler, for
    at least ``seconds`` of host clock between two syncs."""
    cell.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        cell.step(cell.gen)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    cell.sync()
    return (time.perf_counter() - t0) / n


def traced_window(cell: Cell, steps: int, layers: dict) -> dict:
    """``steps`` steps under ``torch.profiler`` after one warm-up step
    that it does not record, their trace read into a ``TraceSummary``; the
    traced window runs from a sync before the first recorded step to a
    sync after the last."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            cell.step(cell.gen)
            cell.sync()
            prof.step()
            t0 = time.perf_counter()
            for k in range(steps):
                losses.append(cell.step(cell.gen))
                if k < steps - 1:
                    prof.step()
            cell.sync()
            t1 = time.perf_counter()
            prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    summary = trace.summarize(events, layers, steps, t1 - t0)
    finite = torch.isfinite(torch.stack(losses)).cpu()
    return {"summary": summary, "failed": int((~finite).sum()),
            "steps": steps}


def device_info(device, chips: int, peak: int) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": peak}


def judge(checks: dict, failed: int) -> bool:
    """``correct``: no step of the window failed, and every number compared
    is finite and within its limit."""
    return failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def run(name: str, seed: int, seconds: float, traced: bool,
        bench: dict, chips: int = 1, log=print, device="cuda",
        plan: Optional[Plan] = None, batch: Optional[int] = None) -> dict:
    """One run of cell ``name``: the result object, its ``checks`` last.
    ``device``, ``plan`` and ``batch`` are for the harness's own tests,
    which drive a run on the CPU at a small batch, broken or not."""
    log(f"set-up: harness imported at {process_start_s():.2f} s")
    cell = Cell(name, seed, device=device, plan=plan, batch=batch)
    cuda = cell.device.type == "cuda"
    wl = cell.wl
    log(f"set-up: cell built at {process_start_s():.2f} s (cumulative: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in cell.times.items()) + ")")
    first = cell.first_steps(3)
    setup_s = process_start_s()
    log(f"set-up: first steps {first['seconds']} s, done at {setup_s:.2f} s")
    step_s = float(np.median(first["seconds"][1:]))
    rec = RunRecord(cell=name, wl=wl, cfg=cell.cfg, batch=cell.batch,
                    n_nodes=node_count(wl, cell.cfg), setup_s=setup_s)
    peak_of = ((lambda: int(torch.cuda.max_memory_allocated(cell.device)))
               if cuda else (lambda: 0))
    setup_peak = peak_of()
    if traced:
        rec.plain_step_s = plain_step_s(cell, PLAIN_SECONDS)
        got = traced_window(cell, int(wl["trace_steps"]),
                            trace.load_layers(HERE / "layers"))
        rec.trace, rec.steps = got["summary"], got["steps"]
        kind = "per_layer"
    else:
        got = timed_window(cell, seconds, step_s)
        ms = sorted(got["step_ms"])
        med = ms[len(ms) // 2]
        slow = [v - med for v in ms if v > 1.5 * med]
        issue = sorted(got["issue_ms"])
        log(f"window: {got['steps']} steps in {got['window_s']:.3f} s; step "
            f"ms min {ms[0]:.2f} median {med:.2f} max {ms[-1]:.2f}; "
            f"{len(slow)} steps over 1.5x the median, {sum(slow):.1f} ms "
            f"over it; host issue ms first {got['issue_ms'][0]:.2f} median "
            f"{issue[len(issue) // 2]:.2f} max {issue[-1]:.2f}; the host "
            f"{got['lead_ms']:.1f} ms ahead at the close")
        rec.steps, rec.window_s = got["steps"], got["window_s"]
        rec.step_ms, rec.window_peak_bytes = got["step_ms"], got["peak"]
        kind = "end_to_end"
    peak = max(setup_peak, peak_of())
    metrics = {}
    for m in cell_metrics(bench, name, kind):
        value = load_metric(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cell.free()
    t_ref = time.perf_counter()
    steps_ref = int(wl["reference_steps"])
    prog = program_run(cell, first, steps_ref)
    against = reference_run(cell, steps_ref)
    got_numbers = readings(prog, against)
    log(f"reference: {steps_ref} steps in {time.perf_counter() - t_ref:.1f} s;"
        f" losses {prog['losses']} against {against['losses']}")
    limits = wl["limits"]
    checks = {k: {"value": got_numbers[k], "limit": float(limits[k])}
              for k in limits}
    correct = judge(checks, got["failed"])
    device = device_info(cell.device, chips, peak)
    out = {"correct": correct, "attempted": got["steps"],
           "failed": got["failed"], "metrics": metrics, "device": device}
    if traced:
        s = rec.trace
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        out["breakdown"] = {"device_ops": [[n, v] for n, v in s.device_ops],
                            "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    out["checks"] = checks
    return out
