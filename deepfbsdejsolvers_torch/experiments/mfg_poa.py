"""Price-of-Anarchy pipeline: the mainMFGPoA.py equivalent.

For each pricing case and each π, trains an MFG model (coeff_equi = 1) and
an aggregate-MFC model (coeff_equi = 2), replays both players' trained
policies on ONE frozen common-noise set, and tabulates PoA = cost_MFG /
cost_MFC with 95% CIs (mainMFGPoA.py:189-337).  Artifacts under
``io.outdir``: ``poa_table.csv`` (the columns of ``PoARunResult.table``),
``metrics.jsonl``, and with ``io.save_plots`` the multi-page PDF of
consumption / deviation / price panels (matplotlib, imported only then);
with ``io.profile_dir`` a ``torch.profiler`` trace of the training and
replays.  Runs on the card unless ``device="cpu"`` is asked for.  With
``config.data_parallel`` every cell trains data-parallel over the ranks of
the launcher's world (``parallel/data_parallel.py``), each rank on its
``per_shard_batch`` of the batches, and every rank replays the policies;
rank 0 alone writes under ``io.outdir``, the others waiting at a barrier.

Seeds: the frozen noise from the generator of (seed, 0) on the device,
each (case, π, model) cell's training from a seed derived from (seed, 1,
cell), the untrained policy of the figures' first pages from (seed, 10^6).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List

import numpy as np

from deepfbsdejsolvers_torch.eval.mfg_solutions import (
    FrozenNoise, MFGFixedTrajectoryEvaluator, draw_frozen_noise,
    price_of_anarchy)
from deepfbsdejsolvers_torch.experiments.configs import (
    MFG_METHOD_TO_SCHEME, MFGPoAConfig)
from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
    SmartGridMFGModel, make_mfg_default)
from deepfbsdejsolvers_torch.parallel.data_parallel import optional_mesh
from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
from deepfbsdejsolvers_torch.solvers.train import make_generator
from deepfbsdejsolvers_torch.utils.logging import MetricsLogger
from deepfbsdejsolvers_torch.utils.profiling import trace_profile

TABLE_COLUMNS = ("case", "pi", "PoA", "MFG cost", "MFG ci95", "MFC cost",
                 "MFC ci95")


@dataclasses.dataclass
class PoACell:
    """One (case, π) sweep point."""

    case: str
    pi: float
    poa: float
    mfg_cost: float
    mfg_ci: float
    mfc_cost: float
    mfc_ci: float
    evaluators: Dict[str, MFGFixedTrajectoryEvaluator]


@dataclasses.dataclass
class PoARunResult:
    cells: List[PoACell]

    def table(self) -> List[dict]:
        """The PoA table (mainMFGPoA.py:332-337), one dict per cell keyed
        by ``TABLE_COLUMNS``."""
        return [dict(zip(TABLE_COLUMNS, (c.case, c.pi, c.poa, c.mfg_cost,
                                         c.mfg_ci, c.mfc_cost, c.mfc_ci)))
                for c in self.cells]

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=TABLE_COLUMNS)
            writer.writeheader()
            writer.writerows(self.table())


def _make_model(config: MFGPoAConfig, pi: float, p0: float, p1: float,
                f0: float, f1: float,
                coeff_equi: float) -> SmartGridMFGModel:
    model = make_mfg_default(
        nb_days=config.nb_days, raf_coef=config.raf_coef,
        jump_factor=config.jump_factor, pi=pi, p0=p0, p1=p1, f0=f0, f1=f1,
        jump_model=config.jump_model, coeff_equi=coeff_equi,
    )
    return dataclasses.replace(model, jump_sampler=config.jump_sampler)


def _solver(config: MFGPoAConfig, model, scheme: str,
            device: str) -> MFGSolver:
    return MFGSolver(model=model, scheme=scheme,
                     hidden_hat=config.hidden_hat, hidden=config.hidden,
                     activation_hat=config.activation_hat,
                     activation=config.activation,
                     scan_chunk=config.scan_chunk, device=device)


def _cell_seed(seed: int, cell_id: int) -> int:
    return int(np.random.SeedSequence([seed, 1, cell_id]).generate_state(
        1)[0])


def run_mfg_poa(config: MFGPoAConfig, verbose: bool = True,
                device: str = "cuda") -> PoARunResult:
    with optional_mesh(config.data_parallel, device) as mesh:
        return _run_mfg_poa(config, verbose, device, mesh)


def _run_mfg_poa(config: MFGPoAConfig, verbose: bool, device: str,
                 mesh) -> PoARunResult:
    io = config.io
    main = mesh is None or mesh.rank == 0
    verbose = verbose and main
    if main:
        io.warn_no_checkpoint("mfg-poa")
    logger = None
    if io.outdir and io.metrics_jsonl:
        if main:
            os.makedirs(io.outdir, exist_ok=True)
        logger = MetricsLogger(os.path.join(io.outdir, "metrics.jsonl"),
                               tags={"experiment": "mfg_poa"}, mesh=mesh)

    # the frozen noise, drawn once from the zero-price model at π = 0.5
    # (mainMFGPoA.py:110-121)
    noise_model = _make_model(config, pi=0.5, p0=0.0, p1=0.0, f0=0.0,
                              f1=0.0, coeff_equi=1.0)
    dw0, dws, dn = draw_frozen_noise(
        noise_model, make_generator(device, config.seed, 0), config.n_frozen,
        n_players=2)

    scheme = MFG_METHOD_TO_SCHEME[config.method]
    cells: List[PoACell] = []
    with trace_profile(io.profile_dir if main else None):
        for i_case, (case, (p0, p1, f0, f1)) in enumerate(
                config.cases.items()):
            for i_pi, pi in enumerate(config.pi_list):
                if verbose:
                    print(f"==== case '{case}'  pi={pi} ====")
                evaluators: Dict[str, MFGFixedTrajectoryEvaluator] = {}
                for i_tag, (tag, coeff_equi) in enumerate((("mfg", 1.0),
                                                           ("mfc", 2.0))):
                    model = _make_model(config, pi, p0, p1, f0, f1, coeff_equi)
                    solver = _solver(config, model, scheme, device)
                    cell_id = (i_case * len(config.pi_list) + i_pi) * 2 + i_tag
                    res = solver.train(
                        seed=_cell_seed(config.seed, cell_id),
                        batch=config.batch_size,
                        batch_val=config.batch_size * 10,
                        num_epoch=config.n_epoch,
                        num_epoch_ext=config.n_epoch_ext,
                        lrate=config.lrate_for(config.method),
                        couplage=config.couplage, verbose=verbose,
                        mesh=mesh, y0_warm_start=config.y0_warm_start)
                    for player, dw in enumerate(dws):
                        evaluators[f"{tag}_p{player + 1}"] = (
                            MFGFixedTrajectoryEvaluator(
                                solver=solver, params=res.params,
                                noise=FrozenNoise(dW0=dw0, dW=dw, dN=dn)))
                poa = price_of_anarchy(evaluators["mfg_p1"],
                                       evaluators["mfc_p1"], config.n_frozen)
                # player-2 replays for the two-player trajectory panels
                evaluators["mfg_p2"].simulate_all_processes(config.n_frozen)
                evaluators["mfc_p2"].simulate_all_processes(config.n_frozen)
                cells.append(PoACell(
                    case=case, pi=pi, poa=poa["poa"], mfg_cost=poa["mfg_cost"],
                    mfg_ci=poa["mfg_ci"], mfc_cost=poa["mfc_cost"],
                    mfc_ci=poa["mfc_ci"], evaluators=evaluators))
                if logger:
                    logger.log(event="cell_done", case=case, pi=pi, **poa)
                if verbose:
                    print(f"  PoA = {poa['poa']:.6f}  "
                          f"(MFG {poa['mfg_cost']:.4f}±{poa['mfg_ci']:.4f}, "
                          f"MFC {poa['mfc_cost']:.4f}±{poa['mfc_ci']:.4f})")

    result = PoARunResult(cells=cells)
    if io.outdir and main:
        os.makedirs(io.outdir, exist_ok=True)
        result.to_csv(os.path.join(io.outdir, "poa_table.csv"))
        if io.save_plots:
            pretrain = _pretrain_evaluators(config, noise_model, scheme,
                                            device, dw0, dws, dn)
            _plot_pdf(config, result, pretrain)
    if logger:
        logger.close()
    if mesh is not None:
        mesh.barrier()
    return result


def _pretrain_evaluators(config: MFGPoAConfig, noise_model, scheme, device,
                         dw0, dws, dn):
    """Untrained-policy replays on the frozen noise, the reference's
    pre-training diagnostic (mainMFGPoA.py:139-186): both players run a
    fresh network pair through the zero-price model."""
    solver0 = _solver(config, noise_model, scheme, device)
    params0 = solver0.init_params(make_generator("cpu", config.seed, 10**6))
    evs = []
    for dw in dws:
        ev = MFGFixedTrajectoryEvaluator(
            solver=solver0, params=params0,
            noise=FrozenNoise(dW0=dw0, dW=dw, dN=dn))
        ev.simulate_all_processes(min(config.n_frozen,
                                      max(config.n_replay, 1)))
        evs.append(ev)
    return tuple(evs)


def _plot_pdf(config: MFGPoAConfig, result: PoARunResult, pretrain=None):
    """Multi-page PDF: the pre-training panels (untrained policy), then
    consumption / deviation / price / intensity panels per sweep point, then
    the PoA-vs-π curves (mainMFGPoA.py:252-335, 362-375)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    path = os.path.join(config.io.outdir, "simulations_all_cases.pdf")
    n_show = min(config.n_replay, result.cells[0].evaluators["mfg_p1"]
                 .trajectories["Q"].shape[0]) if result.cells else 0
    with PdfPages(path) as pdf:
        if pretrain is not None:
            _pretrain_pages(config, pretrain, pdf, plt)
        for cell in result.cells:
            ev1, ev2 = cell.evaluators["mfg_p1"], cell.evaluators["mfg_p2"]
            t_hours = ev1.trajectories["t"] * ev1.model.dt * 24.0
            tr1, tr2 = ev1.trajectories, ev2.trajectories
            for j in range(n_show):
                fig, ax = plt.subplots(nrows=2, ncols=2, figsize=(12, 8))
                ax[0, 0].plot(t_hours, tr1["hQ"][j], color="dimgray",
                              linewidth=2.2, label=r"$\hat{Q}$")
                ax[0, 0].plot(t_hours, tr1["Q"][j] + tr1["alpha"][j],
                              color="blue", label=r"$Q^1+\alpha^1$")
                ax[0, 0].plot(t_hours, tr2["Q"][j] + tr2["alpha"][j],
                              color="red", label=r"$Q^2+\alpha^2$")
                ax[0, 0].set_title(f"consumption — {cell.case}, pi={cell.pi}")
                ax[0, 1].plot(t_hours, tr1["S"][j], label=r"$S^1$")
                ax[0, 1].plot(t_hours, tr1["hS"][j], label=r"$\hat S$")
                ax[0, 1].set_title("cumulative deviation")
                price = ev1.price(cell.pi, tr1["alpha_hat"])
                ax[1, 0].plot(t_hours, price[j], label="price")
                ax[1, 0].set_title("dynamic price")
                ax[1, 1].plot(t_hours, tr1["lam"][j], linestyle="dashed",
                              color="brown", label=r"$\lambda$")
                ax[1, 1].set_title("intensity")
                for a in ax.flat:
                    a.set(xlabel="time (hours)")
                    a.legend(prop={"size": 6})
                pdf.savefig(fig)
                plt.close(fig)
        fig, ax = plt.subplots(figsize=(8, 5))
        for case in sorted({c.case for c in result.cells}):
            pts = sorted((c.pi, c.poa) for c in result.cells if c.case == case)
            ax.plot([p for p, _ in pts], [v for _, v in pts], marker="o",
                    label=case)
        ax.set(xlabel=r"$\pi$", ylabel="PoA", title="Price of Anarchy")
        ax.grid()
        ax.legend(prop={"size": 7})
        pdf.savefig(fig)
        plt.close(fig)


def _pretrain_pages(config: MFGPoAConfig, pretrain, pdf, plt):
    """One page per shown trajectory with the reference's four
    pre-training panels (mainMFGPoA.py:157-183): the players' consumptions
    against the projection, the intensity on a twin axis against hQ, the
    intensity alone, and the R < θ jump-window indicator."""
    ev1, ev2 = pretrain
    tr1, tr2 = ev1.trajectories, ev2.trajectories
    t_hours = tr1["t"] * ev1.model.dt * 24.0
    for j in range(min(config.n_replay, tr1["Q"].shape[0])):
        fig, ax = plt.subplots(nrows=2, ncols=2, figsize=(12, 8))
        ax[0, 0].plot(t_hours, tr1["hQ"][j], label=r"$\hat{Q}$",
                      linewidth=2.2, color="dimgray")
        ax[0, 0].plot(t_hours, tr1["Q"][j], label=r"$Q^{1}$ player 1",
                      color="blue")
        ax[0, 0].plot(t_hours, tr2["Q"][j], label=r"$Q^{2}$ player 2",
                      color="red")
        ax[0, 0].set_title("consumption (kW) — pre-training")
        ax[0, 0].legend(prop={"size": 6})
        ax[0, 1].plot(t_hours, tr1["hQ"][j], label=r"$\hat{Q}$",
                      linewidth=2.2, color="dimgray")
        ax[0, 1].set_title("intensity")
        ax[0, 1].set(ylabel=r"$\hat{Q}$")
        ax2 = ax[0, 1].twinx()
        ax2.plot(t_hours, tr1["lam"][j], label=r"$\lambda$",
                 linestyle="dashed", color="tab:brown")
        ax2.legend(loc=1, prop={"size": 6})
        ax[1, 0].plot(t_hours, tr1["lam"][j], label=r"$\lambda$",
                      linestyle="dashed", color="brown")
        ax[1, 0].set_title("intensity")
        ax[1, 0].legend(prop={"size": 6})
        ax[1, 1].plot(t_hours, tr1["R"][j] < ev1.model.theta, label="jumps")
        ax[1, 1].set_title("jumps")
        for a in ax.flat:
            a.set(xlabel="time (hours)")
        pdf.savefig(fig)
        plt.close(fig)
