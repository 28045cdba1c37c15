"""The port's pricing pipeline (experiments/pricing.py) against the JAX
package's: the Merton and VG configs field for field with their
per-method learning rates, the models ``build_model`` makes (constants and
the oracle price), each method's solver built from a config as the JAX
pipeline builds it, the per-method choice of the sweep under
``sweep_impl="pallas"`` and its log records, and ``run_pricing`` end to
end on the CPU at a tiny size with its artifacts."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepfbsdejsolvers_torch.experiments import configs as tc
from deepfbsdejsolvers_torch.experiments import pricing as tp
from deepfbsdejsolvers_torch.utils.logging import read_jsonl
from deepfbsdejsolvers_tpu.experiments import configs as jc
from deepfbsdejsolvers_tpu.experiments import pricing as jp
from deepfbsdejsolvers_tpu.ops.compensator import CompensatorSpec as JaxComp
from deepfbsdejsolvers_tpu.solvers.pricing import PricingSolver as JaxPS

MODEL_FIELDS = {
    "merton": ("T", "N", "r", "muJ", "sigJ", "sigma", "lam", "K", "x0",
               "limit", "price_mode", "jump_sampler"),
    "vg": ("T", "N", "r", "theta", "kappa", "sigJ", "K", "x0", "pricer",
           "price_eval", "jump_sampler"),
}
CONFIGS = {"merton": (tc.MertonConfig, jc.MertonConfig),
           "vg": (tc.VGConfig, jc.VGConfig)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out.pop("io")
    return out


@pytest.mark.parametrize("exp", ["merton", "vg"])
def test_configs_match_jax(exp):
    ours, theirs = (cls() for cls in CONFIGS[exp])
    assert _fields(ours) == _fields(theirs)
    assert ours.hidden == theirs.hidden
    for method in tc.PRICING_METHODS:
        assert ours.lrate_for(method) == theirs.lrate_for(method), method
    assert tc.PRICING_METHODS == jc.PRICING_METHODS
    assert tc.PRICING_METHOD_TO_SCHEME == jc.PRICING_METHOD_TO_SCHEME
    assert dataclasses.asdict(tc.RunIO()) == dataclasses.asdict(jc.RunIO())


def test_config_refusals():
    """A bf16 configuration builds; where it asks for the kernel sweep, the
    pipeline sweeps in plain PyTorch and says why (the kernels compute in
    f32)."""
    cfg = tc.MertonConfig(compute_dtype="bfloat16", sweep_impl="pallas")
    solver, unmet = tp.build_solver(cfg, tp.build_model(cfg), "Global",
                                    device="cpu")
    assert solver.sweep_impl == "xla" and solver.compute_dtype == "bfloat16"
    assert any("compute_dtype" in why for why in unmet)


@pytest.mark.parametrize("exp,kw", [
    ("merton", {}), ("merton", dict(a_lin=0.3, limit=20)),
    ("merton", dict(jump_sampler="icdf", price_mode="chebyshev")),
    ("vg", {}), ("vg", dict(jump_sampler="icdf", price_mode="chebyshev")),
])
def test_build_model_matches_jax(exp, kw):
    ours_cls, theirs_cls = CONFIGS[exp]
    tm = tp.build_model(ours_cls(**kw))
    jm = jp.build_model(theirs_cls(**kw))
    for name in MODEL_FIELDS[exp]:
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.price_at_origin() == pytest.approx(float(jm.price_at_origin()),
                                                 abs=1e-6)
    x = torch.tensor([0.5, 1.0, 1.7])
    assert np.allclose(tm.coupling(x).numpy(),
                       np.asarray(jm.coupling(jax.numpy.asarray(x.numpy()))))


def _jax_solver(config, model, method):
    """The JAX pipeline's solver (experiments/pricing.py:78-89)."""
    return JaxPS(
        model=model, scheme=jc.PRICING_METHOD_TO_SCHEME[method],
        hidden=config.hidden, activation=config.activation,
        compensator=JaxComp(
            kind=config.compensator, n_mc=config.n_mc,
            n_poisson_max=config.n_poisson_max, n_hermite=config.n_hermite,
            n_laguerre=config.n_laguerre, x_interp=config.x_interp,
            n_cheb=config.n_cheb),
        compute_dtype=config.compute_dtype, sweep_impl=config.sweep_impl,
        hoist=config.hoist, hoist_interp=config.hoist_interp,
        scan_chunk=config.scan_chunk)


SOLVER_FIELDS = ("scheme", "hidden", "activation", "compute_dtype", "hoist",
                 "hoist_interp", "scan_chunk", "remat", "time_scale",
                 "pw_pieces", "pw_degree", "hoist_pad_frac", "hoist_z")
COMP_FIELDS = ("kind", "n_mc", "n_poisson_max", "n_hermite", "n_laguerre",
               "x_interp", "n_cheb", "cheb_robust_sigmas", "node_block")


@pytest.mark.parametrize("exp", ["merton", "vg"])
@pytest.mark.parametrize("method", tc.PRICING_METHODS)
def test_each_method_builds_the_jax_solver(exp, method):
    """Field for field, with the nets' shapes, for a config that asks for
    the kernels and the MC compensator; the sweep the port chooses is the
    one JAX's solver runs (its ``_pallas_ok``)."""
    kw = dict(sweep_impl="pallas", compensator="mc", n_mc=64, nb_neuron=16)
    ours_cls, theirs_cls = CONFIGS[exp]
    cfg, jcfg = ours_cls(**kw), theirs_cls(**kw)
    ts, unmet = tp.build_solver(cfg, tp.build_model(cfg), method, "cpu")
    js = _jax_solver(jcfg, jp.build_model(jcfg), method)
    for name in SOLVER_FIELDS:
        assert getattr(ts, name) == getattr(js, name), name
    for name in COMP_FIELDS:
        assert (getattr(ts.compensator, name)
                == getattr(js.compensator, name)), name
    specs = {k: (s.n_in, tuple(s.hidden), s.n_out, s.with_y0)
             for k, s in ts.net_specs().items()}
    jspecs = {k: (s.n_in, tuple(s.hidden), s.n_out, s.with_y0)
              for k, s in js.net_specs().items()}
    assert specs == jspecs
    if ts.with_heads:
        jax_kernel = js._pallas_ok(js.init_params(jax.random.key(0)))
        assert (ts.sweep_impl == "pallas") == jax_kernel
        assert bool(unmet) == (not jax_kernel)


@pytest.mark.parametrize("exp,method,kw,impl,reason", [
    ("merton", "Global", {}, "pallas", None),
    ("merton", "SumMultiStep2", dict(nb_neuron=64), "pallas", None),
    ("merton", "SumMultiStep1", {}, "xla", "2-output U-net"),
    ("merton", "SumLocal1", {}, "xla", "2-output U-net"),
    ("vg", "SumLocal1", dict(nb_neuron=128), "pallas", None),
    ("merton", "Global", dict(nb_neuron=129), "xla", "1..128"),
    ("vg", "Global", dict(activation="relu"), "xla", "activation"),
    ("merton", "Global", dict(sweep_impl="xla"), "xla", None),
])
def test_sweep_is_chosen_per_method(exp, method, kw, impl, reason):
    cfg = CONFIGS[exp][0](**dict(dict(sweep_impl="pallas"), **kw))
    solver, unmet = tp.build_solver(cfg, tp.build_model(cfg), method, "cpu")
    assert solver.sweep_impl == impl
    if reason is None:
        assert unmet == []
    else:
        assert any(reason in r for r in unmet), unmet


def test_run_pricing_logs_each_methods_sweep(tmp_path, capsys):
    """sweep_impl="pallas" asked for: Global trains on the kernels' sweep
    (their plain version on the CPU), SumMultiStep1 on the plain sweep,
    said on stderr and carried by every record of the method."""
    cfg = tc.MertonConfig(
        n_epoch_ext=2, n_epoch=1, batch_size=4, nb_neuron=8,
        methods=("Global", "SumMultiStep1"), sweep_impl="pallas",
        io=tc.RunIO(outdir=str(tmp_path)))
    res = tp.run_pricing(cfg, verbose=False, device="cpu")
    assert res.methods["Global"].sweep_impl == "pallas"
    assert res.methods["SumMultiStep1"].sweep_impl == "xla"
    assert "SumMultiStep1: sweep_impl 'pallas' asked for" in (
        capsys.readouterr().err)
    records = read_jsonl(str(tmp_path / "metrics.jsonl"))
    for method, impl in (("Global", "pallas"), ("SumMultiStep1", "xla")):
        mine = [r for r in records if r.get("method") == method]
        assert len(mine) == 4          # the choice, two epochs, done
        assert all(r["sweep_impl"] == impl for r in mine)
        choice = [r for r in mine if r.get("event") == "sweep_choice"]
        assert choice[0]["asked"] == "pallas"
        assert bool(choice[0]["reasons"]) == (impl == "xla")


def test_run_pricing_on_the_cpu(tmp_path):
    """Two methods at a tiny size: finite read-outs, the tail average and
    the warm start, the oracle, and the artifacts (metrics, checkpoints,
    profile trace, figure)."""
    out = tmp_path / "run"
    cfg = tc.MertonConfig(
        n_epoch_ext=2, n_epoch=1, batch_size=4, nb_neuron=8,
        methods=("Global", "SumMultiStepReg"), y0_tail_avg=2,
        y0_warm_start=True,
        io=tc.RunIO(outdir=str(out), save_plots=True, checkpoint_every=1,
                    profile_dir=str(tmp_path / "trace")))
    res = tp.run_pricing(cfg, verbose=False, device="cpu")
    assert res.reference_price == pytest.approx(0.271457, abs=1e-6)
    for method, r in res.methods.items():
        assert len(r.y0_history) == 2 and np.isfinite(r.y0)
        assert r.y0 == pytest.approx(np.mean(r.y0_history))
        assert r.abs_error == pytest.approx(abs(r.y0 - res.reference_price))
        assert sorted(p.name for p in (out / "ckpt" / method).iterdir()) == [
            "step_0", "step_1"]
    # the warm start puts Y0 near the discounted payoff, far from N(0, 1)
    assert abs(res.methods["Global"].y0_history[0] - 0.27) < 0.1
    assert res.best() in res.methods.values()
    assert (out / "convergence.png").stat().st_size > 0
    assert any(p.stat().st_size > 0 for p in (tmp_path / "trace").iterdir())
    events = [r.get("event") for r in read_jsonl(str(out / "metrics.jsonl"))]
    assert events.count("start") == 1
    assert events.count("method_done") == 2
