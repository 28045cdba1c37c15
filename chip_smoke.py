"""Smoke run of the PyTorch port on one CUDA card: build, check, train.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the CUDA kernels from ``deepfbsdejsolvers_torch/csrc`` with nvcc,
   all sources at once, and print each kernel's registers and spills
   (ptxas) and B1's, B2's, B3's and B4's shared memory per block and
   resident blocks per SM (B1 and B2 in both instances), the wide B1/B2
   (``rollout_wide_*.cu``) and B3/B4 (``sweep_wide_*.cu``) per width class
   32, 64 and 128;
2. hold each kernel against its plain PyTorch version on ragged batches:
   - B1's (x_N, y_N) and B2's gradients through ``FusedRollout`` at full
     width (hidden 21, N = 50, the real hoisted tables of the Merton speed
     configuration, 2^14 + 37 paths), B2 run twice bit for bit; then the
     same at hidden 8, N = 7, 1000 paths; then at hidden 21, N = 50 and
     at hidden 8, N = 7 on 2.5 of B2's 128-path tiles for each of its
     most blocks, less 91 paths (a ragged last tile), so that half its
     blocks walk two tiles and half three;
   - B3's sweep and B4's gradients of (x, a, c, W1, b1, v) against
     ``sweep_plain`` and autograd of it, on the parity path's node sets:
     hidden 21 with the 49-node quadrature at 2^14 + 37 paths and with
     5000 Monte-Carlo nodes at 2^12 + 37 paths, and hidden 8 with the
     quadrature at 1000 paths; then the edges of the kernels' tiling: a
     node count one past a node chunk (17) and a single node, a batch below
     one tile (37 paths) and one path past whole tiles (1025), and batches
     past B4's 512 blocks of 256-path tiles, so that blocks walk two tiles
     (the quadrature at 2^17 + 37) and three (17 nodes at 2^18 + 37, at
     hidden 21 and 8); and hidden 21 with the quadrature at 2^14 + 37
     paths on the node feature f = e^J of multistep2/sumlocal2 (0.13 to
     7.6 where J spans ±2.03);
   - B3/B4 on the pure-jump regime's two forms over the Variance-Gamma
     node sets: the Γ net on f = X·J, whose a = W0[x] + J·W0[f] differs
     per node, and the one-output U-net on (t, X·(1 + J)) of
     multistep1/sumlocal1, on the 96-node quadrature at 2^14 + 37 and
     2^17 + 37 paths (hidden 21 and, at 2^14 + 37, 8) and on 5000
     Monte-Carlo draws at 2^12 + 37 (``VG_SWEEP_CHECKS``); B4 run twice
     bit for bit in every sweep check;
   - the wide B3/B4 at hidden 20, 64, 100 and 128 (``WIDE_SWEEP_CHECKS``):
     the 49-node quadrature and both VG forms on the 96-node set at
     2^14 + 37 paths, the CLI's wide runs' shapes (the 49-node quadrature
     on J and the 96-node set on X·J at 2^17 + 37 paths), 5000
     Monte-Carlo nodes at 2^12 + 37, one node at 37 paths, 17 nodes at
     1025 and at 2^17 + 37 (the wide B4's 264 blocks walk 3 or 4 tiles);
     the plain reference summed over node blocks where its grid passes
     2^29 elements; B4's gradients held leaf by leaf and as a whole; at
     H = 128 on the 5000 nodes, each leaf's distance from a float64
     evaluation printed for B4 and for the plain version;
   - the wide B1/B2 at hidden 20, 64, 100 and 128 (``WIDE_ROLLOUT_CHECKS``):
     N = 50 at 2^14 + 37 paths, N = 7 at 1000 paths and at 2.5 tiles for
     each of the wide B2's 264 blocks (its blocks walk two and three
     tiles), and N = 50 at 2^17 + 37 (they walk 4 to 16); B1w's (x_N, y_N)
     and loss, and B2w's gradients two ways (``check_wide_grads``), each as
     a whole and leaf by leaf: B2w alone on the plain version's own
     trajectory, and B1w then B2w over the paths whose two forward
     trajectories straddle no discontinuity of the gradient (a piece of the
     tables, the sign in the coupling, the payoff's kink; fewer than 1% of
     the paths, counted in the log); at H = 128, N = 50 on 2^12 + 37 paths,
     the loss's and each gradient leaf's distance from a float64
     evaluation of ``rollout_plain`` printed for B1w + B2w and for the
     plain version (``ROLLOUT_F64_CHECK``);
3. drive the training paths through their facades at batch 2^17, every
   kernel's launch counter set to 0 just before a path and read just
   after; each kernel must have launched exactly the times the code
   implies for the path, and the others never:
   - the speed path (``SolverGlobalFBSDE``, hoisted piecewise tables,
     ``fused_rollout=True``), 2 outer epochs of 10 Adam steps: B1 once a
     step and once an evaluation, B2 once a step, the icdf jump kernel J
     (``csrc/icdf_jumps.cu``) once a noise draw, so as B1; the same at
     hidden (64, 64) and (128, 128), 2 × 2 steps: B1w and J 6 and B2w 4
     times, B1/B2 never; J never on the exact samplers' paths (parity,
     schemes, VG, the CLI's defaults) nor on the MFG model's;
   - the parity path (``SolverGlobalFBSDE(make_merton_default(), ...,
     sweep_impl="pallas")``, the 49-node quadrature swept at every path),
     2 × 10 steps: B3 at each of the 50 time steps of a step and of an
     evaluation, B4 at each of a step's;
   - the six other schemes in the parity configuration, 2 outer epochs of
     2 steps each, with ``sweep_impl="pallas"`` where the scheme takes it
     (multistep2, sumlocal2) and "xla" elsewhere: finite losses, and the
     launches of ``SCHEMES``;
   - the Variance-Gamma parity path (``SolverGlobalFBSDE(make_vg_default(),
     ..., sweep_impl="pallas")``: exact gamma jumps, the per-path FFT
     price, the 96-node quadrature swept at every path on X·J), 2 × 10
     steps: B3 at each of the 30 time steps of a step and of an
     evaluation, B4 at each of a step's; the VG speed path (collocated
     price, icdf jumps, hoisted piecewise tables), 2 × 10 steps and no
     kernel; and the six other schemes on the VG model, 2 × 2 steps, with
     the launches of ``VG_SCHEMES`` (multistep1/2 30 B3 + 30 B4 a step,
     sumlocal1/2 31 + 30, the regressions none);
   - the parity path at the CLI's wide widths (``WIDE_PARITY``): Merton at
     hidden (64, 64) on the 49 nodes and VG at (128, 128) on the 96 nodes
     on X·J, 2 × 2 steps: B3w and B4w at each time step of a step, B3w at
     each of an evaluation's, the other kernels never;
4. time a training step of each path (``cuda_ms``) and profile it, and
   time each kernel and its plain version the same way (``kernel_ms``:
   calls back to back between two CUDA events, after a warm-up) at the
   path's shapes; J bit for bit its plain version at the fused benchmark
   cell's (50, 2^20) (``icdf_phase``), with its time, the plain chain's
   and the draws'; B3/B4 also at 5000 Monte-Carlo nodes and on the two
   pure-jump forms at the 96-node quadrature; the wide B3/B4 at batch 2^17
   on the 49- and 96-node sets at each of hidden 20, 64, 100, 128; the wide
   B1/B2 at N = 50, batch 2^17 at the same widths, and a step of the wide
   speed path at hidden 64 and 128 and of the wide parity paths; the VG
   speed step's profile must hold no ``indexing_backward_kernel`` (the
   piece select's backward is the one-hot product of ``ops/piecewise.py``,
   not PyTorch's gather backward);
5. drive the smart-grid MFG model (``mfg_phases``), every launch counter
   set to 0 just before and each required to read 0 just after (its
   paths reach no kernel): the comparison model (N = 95, hidden (20, 20) /
   (22, 22)) with the icdf Cox sampler at batch 2^17, the global scheme
   trained 2 × 2 steps through ``MFGSolver.train``, then timed over 5
   steps and profiled over 2; the exact sampler, 2 timed steps, and
   ``torch.poisson``'s mean and variance on 2^20 draws at the trough, peak
   and +5σ Cox rates; the four other schemes trained 2 × 2 steps and timed
   over 2 (sumlocal also with couplage OFF); the Picard warm start on the
   linear-quadratic corner (16384 paths, 24 iterates), both read-outs
   within 2e-2 relative of the exact oracle; and the trained global
   policy replayed on 10^5 frozen paths: finite processes and objective,
   and a Price of Anarchy of exactly 1.0 against itself;
6. drive the experiment CLI (``cli.main``, what ``python -m
   deepfbsdejsolvers_torch`` runs) in this process, each run's launches
   held exact (``cli_phases``): ``merton`` and ``vg`` at the reference's
   defaults (hidden (21, 21), batch 10, the quadrature, the exact
   samplers, the kernel sweep), one method a run of 2 outer epochs of 2
   steps, with the sweep each method's records name (``CLI_MERTON``,
   ``CLI_VG``); ``mfg-compare`` and ``mfg-poa`` at their defaults, cut to
   1 × 2 steps and 1000 / 100 frozen paths, launching nothing; ``merton
   --nbNeuron 64`` and ``vg --nbNeuron 128``, Global at batch 2^17, on the
   wide kernels; ``merton --methods Global --checkpointEvery 1`` 3 outer
   epochs uncut against 2 and then ``--resume`` to 3 (the third epoch's
   Y0, loss and params bit for bit, else within 1e-6 and said so);
   ``--profileDir`` (a non-empty trace) and ``--debugNans`` (finite);
7. drive the bench (``python -m deepfbsdejsolvers_torch bench``) in this
   process, a cell a run (``BENCH_CELLS``), each run's launches held exact
   and its JSON line printed: the speed, --fused and --parity cells and the
   VG parity cell at bench.py's protocol (2 + 3 epochs of 10 steps at batch
   2^17), the MC-5000 parity cell cut to 1-step epochs, the VG speed and
   MFG cells to 2-step epochs and 1 timed epoch;
8. run the accuracy gate ``merton_speed_fused`` through the port's gate
   runner at its registered budget (3 seeds × 2400 steps, batch 8192,
   warm Y0): it must pass (|Y0 − 0.271457| ≤ 1e-3 on every seed) and
   launch B1 and B2 once per step, J once per step and once per warm
   start's time step;
9. data parallelism (``dp_phases``), ranks started by ``spawn`` on this
   one card (the kernels built once, in phase 1), each reporting its
   launches, losses and parameter digests, a rank still running after
   ``DP_TIMEOUT`` failing the phase: (a) a world of one on NCCL, the fused
   speed configuration 2 × 2 steps through ``fit(mesh=...)``, bit for bit
   the run without a mesh; (b) two gloo ranks of 2^16 paths, the fused
   speed configuration: mesh loss and gradients against the serial mean
   of both shards, B1/B2 launches exact, the params bit-identical across
   ranks after every step; (c) four gloo ranks as (data 2, comp 2), the
   parity configuration with the 49-node quadrature padded to 50, B3/B4
   sweeping 25 nodes a rank: loss and gradients against the same world
   unsharded, and both against a float64 evaluation, B4 bit-identical on
   rerun, launches exact; the step times of (b) and (c) beside a step in
   one process at batch 2^17 (the ranks share the card: the figures show
   the collectives' cost, not a scaling); (d) the dry run
   (``experiments/dryrun_multichip.py``) at 4 ranks; (e) ``merton
   --dataParallel --methods Global`` under ``torch.distributed.run
   --nproc_per_node 1`` (NCCL), exit 0 and each record written once.
10. the opt-in instruments (``item13_phases``): the hand-written adjoint
   against autograd on the unfused speed path at one noise draw (loss
   within 1e-6, gradients 3e-5 relative) and both step times;
   ``scan_chunk`` 0, 5 and 16 on the unfused speed path, the parity path
   and the MFG global scheme (losses and gradients bit-identical, the
   peak memory of each); one speed step each of ``hoist_gamma``,
   ``hoist_z=False``, ``price_mode="table"`` and ``compute_dtype=
   "bfloat16"``, its loss within 5e-4 (bf16: 5e-3) of the f32 default;
   ``fuse_heads`` against the split heads on the five MFG schemes (loss
   1e-6, gradient 1e-5 relative), with step times, and device ops on the
   global scheme; the head-TF32 instances of B1, B2, B1w and B2w against
   their plain versions at hidden 21, 8, 20, 64 and 128 and where B2w's
   blocks walk two and three tiles (``TF32_CHECKS``, ``check_kernels``,
   the forward step by step on B1's own trajectory), the fused speed path
   trained on them at hidden 21, 64 and 128 (its launches the TF32 rows'
   launches), and their times beside the FP32 instances' in turns (A, B,
   B, A) at hidden 21 and at HP 32, 64 and 128, each beside its FP32
   bound, with the registers and blocks per SM of B2 and the wide pair in
   their rows; and the bench with
   ``--adjoint``, ``--rng rbg`` and ``--fused --fusedPrecision default``,
   each exiting 0 with its launches exact.

The line before the last holds the card's name and power limit
(nvidia-smi), the one before it the kernels' JSON record (each kernel's
launches on its main path, and per path under ``launches_by_path``; the
wide sweep pair's rows at the ``merton --nbNeuron 64`` path's shapes, the
wide rollout pair's at the hidden-64 speed path's, every width and node
set under ``by_width``, with the tensor-core floor of the wide pairs
beside their FP32 bound; the bench cells' lines under ``bench``, the
unfused speed cell's and the VG speed step's times under ``f1``, the
data-parallel phases' under ``dp``, whose launches are in each kernel's
``launches_by_path`` as ``dp_a``..``dp_dryrun``, summed over ranks; the
head-TF32 rows named "... [head tf32]", and the opt-in instruments'
figures under ``item13``); the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_STEPS, HIDDEN, PIECES = 50, 21, 8
CHECK_BATCH = 2**14 + 37
TRAIN_BATCH = 2**17
FWD_ABS_TOL, LOSS_REL_TOL, GRAD_REL_TOL = 1e-4, 1e-5, 1e-4
# B3: max |Δ out| relative to max |out| of the plain sweep
SWEEP_REL_TOL = 1e-5
N_QUAD, N_MC = 49, 5000
# The six other schemes: (facade name, sweep_impl, B3 and B4 launches per
# training step, B3 launches per validation evaluation).  multistep2 sweeps
# at each of its N steps; sumlocal2 also before the loop (N + 1 sweeps,
# whose last step's heads go unused, so N backward sweeps); the evaluation
# runs no backward; the U-net schemes sweep in plain PyTorch.
SCHEMES = {
    "multistep1": ("SumMultiStep1", "xla", 0, 0, 0),
    "multistep2": ("SumMultiStep2", "pallas", N_STEPS, N_STEPS, N_STEPS),
    "sumlocal1": ("SumLocal1", "xla", 0, 0, 0),
    "sumlocal2": ("SumLocal2", "pallas", N_STEPS + 1, N_STEPS,
                  N_STEPS + 1),
    "sumlocal_reg": ("SumLocalReg", "xla", 0, 0, 0),
    "multistep_reg": ("SumMultiStepReg", "xla", 0, 0, 0),
}
# The Variance-Gamma model's steps and its default quadrature's nodes
# (12 Laguerre × 8 Hermite), and the pure-jump regime's schemes: there
# multistep1/sumlocal1 sweep a U-net of one output, which B3/B4 take, so
# the four schemes with a Γ head sweep through the kernels, as above.
N_VG, N_VG_QUAD = 30, 96
VG_SCHEMES = {
    "multistep1": ("SumMultiStep1", "pallas", N_VG, N_VG, N_VG),
    "multistep2": ("SumMultiStep2", "pallas", N_VG, N_VG, N_VG),
    "sumlocal1": ("SumLocal1", "pallas", N_VG + 1, N_VG, N_VG + 1),
    "sumlocal2": ("SumLocal2", "pallas", N_VG + 1, N_VG, N_VG + 1),
    "sumlocal_reg": ("SumLocalReg", "xla", 0, 0, 0),
    "multistep_reg": ("SumMultiStepReg", "xla", 0, 0, 0),
}
# B3/B4 on the pure-jump forms: (hidden, node set, form, batch), the
# quadrature at 2^14 + 37 paths and at 2^17 + 37 (B4's 512 blocks walk two
# tiles), 5000 Monte-Carlo draws at 2^12 + 37, and hidden 8
VG_SWEEP_CHECKS = (
    (HIDDEN, "quadrature", "x_prop", CHECK_BATCH),
    (HIDDEN, "quadrature", "two_feature", CHECK_BATCH),
    (HIDDEN, "mc", "x_prop", 2**12 + 37),
    (HIDDEN, "quadrature", "x_prop", 2**17 + 37),
    (HIDDEN, "quadrature", "two_feature", 2**17 + 37),
    (8, "quadrature", "x_prop", CHECK_BATCH),
    (8, "quadrature", "two_feature", CHECK_BATCH),
)
SCHEME_STEPS, SCHEME_EPOCHS = 2, 2
# The wide kernels (every other width up to 128): their checks at each of
# WIDE_WIDTHS, (node set, MC nodes, form, batch): the Merton 49-node
# quadrature and the VG 96-node set on both pure-jump forms at 2^14 + 37
# paths; the shapes of the CLI's wide runs (merton --nbNeuron 64 and vg
# --nbNeuron 128, Global at batch 2^17: the 49 nodes on J, the 96 on X·J)
# at 2^17 + 37 paths; 5000 Monte-Carlo nodes at 2^12 + 37; and the
# tiling's edges: one node at 37 paths, 17 nodes (one past a node chunk) at
# 1025, and 17 nodes at 2^17 + 37, where the wide B4's 264 blocks walk 3
# or 4 tiles of 128 paths (and flush dW1 after node 16 and at each tile's
# end)
WIDE_WIDTHS = (20, 64, 100, 128)
WIDE_SWEEP_CHECKS = (
    ("quadrature", 0, "j", CHECK_BATCH),
    ("quadrature", 0, "x_prop", CHECK_BATCH),
    ("quadrature", 0, "two_feature", CHECK_BATCH),
    ("quadrature", 0, "j", 2**17 + 37),
    ("quadrature", 0, "x_prop", 2**17 + 37),
    ("mc", N_MC, "j", 2**12 + 37),
    ("mc", 1, "j", 37),
    ("mc", 17, "j", 1025),
    ("mc", 17, "j", 2**17 + 37),
)
# The CLI at the reference's defaults, one method a run of 2 outer epochs
# of 2 steps: per method the sweep its records must name, and B3 and B4
# launches per training step and B3 per evaluation (as SCHEMES and
# VG_SCHEMES; Global sweeps at each time step).  The regressions have no
# sweep: their solver keeps the asked-for "pallas" and launches nothing.
CLI_EPOCHS, CLI_STEPS = 2, 2
CLI_MERTON = {
    "Global": ("pallas", N_STEPS, N_STEPS, N_STEPS),
    "SumMultiStep1": ("xla", 0, 0, 0),
    "SumMultiStep2": ("pallas", N_STEPS, N_STEPS, N_STEPS),
    "SumLocal1": ("xla", 0, 0, 0),
    "SumLocal2": ("pallas", N_STEPS + 1, N_STEPS, N_STEPS + 1),
    "SumLocalReg": ("pallas", 0, 0, 0),
    "SumMultiStepReg": ("pallas", 0, 0, 0),
}
CLI_VG = {
    "Global": ("pallas", N_VG, N_VG, N_VG),
    "SumMultiStep1": ("pallas", N_VG, N_VG, N_VG),
    "SumMultiStep2": ("pallas", N_VG, N_VG, N_VG),
    "SumLocal1": ("pallas", N_VG + 1, N_VG, N_VG + 1),
    "SumLocal2": ("pallas", N_VG + 1, N_VG, N_VG + 1),
    "SumLocalReg": ("pallas", 0, 0, 0),
    "SumMultiStepReg": ("pallas", 0, 0, 0),
}
# The CLI at full wide width, Global at batch 2^17: (subcommand, width,
# steps per epoch); and the resume check's steps per epoch
CLI_WIDE = (("merton", 64, N_STEPS), ("vg", 128, N_VG))
RESUME_STEPS = 5
# The MFG phases: the comparison model's batch, the warm start's paths and
# Picard iterates (the bar of its LQ check is 2e-2 relative)
MFG_BATCH, MFG_WARM_BATCH, MFG_PICARD = 2**17, 16384, 24
GATE = "merton_speed_fused"
# The wide fused rollout (B1w/B2w, every width up to 128 but 8 and 21): its
# checks at each of WIDE_WIDTHS, (N, batch): the shapes of the specialised
# B1/B2 checks (full depth at 2^14 + 37 paths; 7 steps at 1000 paths and at
# 2.5 tiles for each of the wide B2's 264 blocks, less 91 paths, "walk":
# its blocks walk two and three tiles) and full depth at 2^17 + 37 paths
# (they walk 4 to 16); and its training at full width in the speed
# configuration, 2 × 2 steps at batch 2^17
WIDE_ROLLOUT_CHECKS = ((N_STEPS, CHECK_BATCH), (7, 1000), (7, "walk"),
                       (N_STEPS, 2**17 + 37))
WIDE_TRAIN_WIDTHS = (64, 128)
# The bench (``python -m deepfbsdejsolvers_torch bench``, in this process):
# (label, its arguments, each kernel's launches).  At bench.py's protocol,
# 2 warm-up and 3 timed epochs of 10 steps at batch 2^17 (50 steps): the
# speed cell (the plain rollout; its icdf jumps through J once a step),
# --fused (B1/B2 and J once a step) and --parity (B3/B4 at each of the 50
# time steps), the VG parity cell (the plain sweep: bench.py builds it so);
# cut to 1 step an epoch, the MC-5000 parity cell (3 steps of 50 sweeps
# over 5000 nodes); cut to 2 steps an epoch and 1 timed epoch, the VG speed
# and MFG cells (no kernel)
BENCH_STEPS = 5 * 10
BENCH_CELLS = (
    ("speed", [], {"J": BENCH_STEPS}),
    ("fused", ["--fused"], {"B1": BENCH_STEPS, "B2": BENCH_STEPS,
                            "J": BENCH_STEPS}),
    ("parity", ["--parity"], {"B3": BENCH_STEPS * N_STEPS,
                              "B4": BENCH_STEPS * N_STEPS}),
    ("parity_mc5000", ["--parity", "--compensator", "mc", "--inner", "1",
                       "--rounds", "1"], {"B3": 3 * N_STEPS,
                                          "B4": 3 * N_STEPS}),
    ("vg_parity", ["--model", "vg", "--parity"], {}),
    ("vg_speed", ["--model", "vg", "--inner", "2", "--rounds", "1"], {}),
    ("mfg", ["--model", "mfg", "--inner", "2", "--rounds", "1"], {}),
)
# The plain sweep's checks run over node blocks of at most this many M·B·H
# grid elements (2 GB a tensor), so its autograd fits the card at H = 128
PLAIN_GRID = 2**29
# The opt-in instruments' phase: the chunks of the time loop held bit for
# bit to the plain loop, the bounds of one speed step's loss against the f32
# default (the JAX package's, tests/test_fast_paths.py: bf16 5e-3,
# hoist_gamma 5e-4, and 5e-4 for the other table and head variants), the
# hand adjoint's (tests/test_adjoint.py) and fuse_heads' against the split
# heads (tests/test_fast_paths.py), and the TF32 instances' widths.
ITEM13_CHUNKS = (0, 5, 16)
ITEM13_LOSS_REL = {"hoist_gamma": 5e-4, "hoist_z=False": 5e-4,
                   "price_mode=table": 5e-4, "bfloat16": 5e-3}
ADJOINT_LOSS_REL, ADJOINT_GRAD_REL = 1e-6, 3e-5
FUSE_LOSS_REL, FUSE_GRAD_REL = 1e-6, 1e-5
# the head-TF32 checks (H, N, batch): full depth at each width class and
# at 21 and 8, and N = 7 where B2w's blocks walk two and three tiles
# ("walk"); the
# fused speed path trained on TF32 heads at these widths; the kernels timed
# at these (B1/B2 at 21 and 8, the wide pair at HP 32, 64 and 128)
TF32_CHECKS = ((21, N_STEPS, CHECK_BATCH), (8, N_STEPS, CHECK_BATCH),
               (20, N_STEPS, CHECK_BATCH),
               (64, N_STEPS, CHECK_BATCH), (128, N_STEPS, CHECK_BATCH),
               (20, 7, "walk"), (128, 7, "walk"))
TF32_TRAINED = (HIDDEN, 64, 128)
TF32_TIMED = (21, 8, 32, 64, 128)
# the bench's opt-in flags, 2 warm-up and 1 timed epoch of 2 steps: the
# adjoint and --rng rbg on the unfused speed cell (J once a step), the
# fused cell's select precision (B1/B2 and J once a step)
ITEM13_BENCH = (
    ("adjoint", "module", ["--adjoint"], {"J": 6}),
    ("rng_rbg", "cli", ["--rng", "rbg"], {"J": 6}),
    ("fused_precision_default", "cli", ["--fused", "--fusedPrecision",
                                        "default"],
     {"B1": 6, "B2": 6, "J": 6}),
)
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit):
# FP32 outside the tensor cores, TF32 on them (dense), and HBM3 bandwidth.
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 67e12, 495e12, 3.35e12
# The wide parity paths: SolverGlobalFBSDE(..., sweep_impl="pallas") at the
# CLI's wide widths, (label, model, width, time steps), batch 2^17, 2 × 2
# steps: Merton at hidden (64, 64) with the 49 nodes on J, VG at (128, 128)
# with the 96 nodes on X·J; B3w at every time step of a step and of an
# evaluation, B4w at every time step of a step.
WIDE_PARITY = (("parity_64", "merton", 64, N_STEPS),
               ("vg_parity_128", "vg", 128, N_VG))
# The wide check held to a float64 evaluation as well: H = 128 on 5000
# Monte-Carlo nodes at 2^12 + 37 paths, where B4w's dW1 sums the most
# path-node terms of any check.
F64_CHECK = (128, ("mc", N_MC, "j", 2**12 + 37))
# The wide rollout held to a float64 evaluation of rollout_plain: (H, N,
# batch), the widest head at full depth, where B2w's three products in
# split TF32 sum the most terms.
ROLLOUT_F64_CHECK = (128, N_STEPS, 2**12 + 37)


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


def vg_speed_config():
    """The Variance-Gamma speed configuration (the JAX package's ``bench.py
    --model vg`` without its scan chunking): the collocated FFT price, icdf
    jumps, hoisted piecewise tables.  (model, solver keyword arguments)."""
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec

    model = dataclasses.replace(make_vg_default(jump_sampler="icdf"),
                                price_eval="chebyshev")
    return model, dict(
        compensator=CompensatorSpec(x_interp="chebyshev", n_cheb=64),
        hoist=True, hoist_interp="piecewise", device="cuda")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of a training step ``fn()`` over ``reps`` steps,
    each between two CUDA events and waited for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn()`` over ``reps`` calls
    launched back to back between one pair of CUDA events: a kernel's (or
    its plain version's) own time, without a host launch gap before each
    call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def work(kernel: str, n: int, batch: int, h: int, p: int):
    """(FLOPs, bytes) the kernel's function needs on these shapes, counted
    from the code per path and step (B1, B2) or per path and node (B3, B4,
    with ``n`` the node count M); each tanh counts as one operation.
    B1: the head 2H² + 10H, 2H tanh, three degree-7 Clenshaw evaluations of
    24 FLOPs, ~40 FLOPs of piece lookup, BSDE and walk update; dW and J read,
    xs and ys written.  B2: the head recomputed (2H² + 10H, 2H tanh), its
    backward (2H² + 4H, which also gives dΓ/dx as Σ_h W1[x, h]·dp1[h]), the
    parameter sums (2H² + 12H), three Clenshaw evaluations with derivative
    (48 each), the table sums (3·8·2) and ~50 FLOPs of recurrence; xs, ys,
    dW and J read."""
    ps = n * batch
    table_bytes = 3 * n * p * 8 * 4
    weight_bytes = 4 * (h * h + h)
    if kernel == "B3":
        # x·a + c (2H), tanh (H), the H×H layer with bias (2H² + H), tanh
        # (H), the v-weighted sum (2H); x read, out written, the node rows
        # (a, c, v) and W1, b1 read once
        return ps * (2 * h * h + 7 * h), 8 * batch + 12 * n * h + weight_bytes
    if kernel == "B4":
        # the hidden layers again (2H² + 5H), their backward: g·h2 (H), dz2
        # (4H), W1·dz2 (2H²), dz1 (3H), dx (2H); the sums over paths: dW1
        # (2H²), db1, dc, dv (H each), da (2H); x and g read, dx written,
        # the node rows and weights read and their cotangents written
        return (ps * (6 * h * h + 20 * h),
                12 * batch + 24 * n * h + 2 * weight_bytes)
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


def tc_floor(kernel, n, batch, h, p=PIECES):
    """The bound of a wide kernel whose H×H products run on the tensor
    cores, as (ms, what bounds it): the larger of the products' 2H²
    operations each (one product in B1 and B3, three in B2 and B4) at the
    TF32 peak, the rest of ``work()``'s operations at the FP32 peak, and its
    bytes at the HBM rate.  The wide pairs' ``bound_ms``; ``bound()`` is
    their FP32 figure."""
    flops, nbytes = work(kernel, n, batch, h, p)
    products = n * batch * 2 * h * h * (1 if kernel in ("B1", "B3") else 3)
    t_ops = max(products / PEAK_TF32_FLOPS,
                (flops - products) / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
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


# the names of grad_leaves' tensors, in order
ROLLOUT_LEAVES = ("W1", "W2", "W3", "b1", "b2", "b3", "y0", "cc", "pc", "zc")


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled entry
    (``fwd_kernel<128>``, ``bwd_kernel<128,true>``, ``reduce_partials``):
    the first length-prefixed name that ends in ``_kernel``."""
    for m in re.finditer(r"\d+", mangled):
        name = mangled[m.end():m.end() + int(m.group())]
        if name.endswith("_kernel") or name == "reduce_partials":
            args = re.match(r"I((?:L[ib]\d+E)+)",
                            mangled[m.end() + len(name):])
            vals = [v if kind == "i" else ("true" if v == "1" else "false")
                    for kind, v in re.findall(r"L([ib])(\d+)E",
                                              args.group(1) if args else "")]
            return name + (f"<{','.join(vals)}>" if vals else "")
    return mangled


def ptxas_lines(log: str):
    """(kernel, line) for each register and spill line of an nvcc -Xptxas
    -v log, the kernel named by ``kernel_name``."""
    fn = "?"
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            fn = kernel_name(entry.group(1))
        elif "registers" in line or "spill" in line:
            yield fn, line.replace("ptxas info    : ", "").strip()


def occupancy(name: str, *args: int, entry: str = None):
    """(dynamic shared bytes per block, resident blocks per SM) of the
    kernel of library ``name`` at the widths ``args``, from its info entry
    ``<entry>_info`` (``entry`` defaults to ``name``: ``sweep_*_info(hidden)``,
    ``rollout_bwd_info(hidden, pieces)``; the wide rollout's head-TF32
    instances ``rollout_wide_*_tf32_info(hidden)``)."""
    import ctypes

    from deepfbsdejsolvers_torch.ops import _build

    entry = entry or name
    fn = getattr(_build.load(name), f"{entry}_info")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    if fn(*args, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
        fail(f"{entry}_info{args} failed")
    return smem.value, blocks.value


def rollout_case(model, kw, hidden: int, n: int, batch: int):
    """(model cut to ``n`` steps, rollout inputs at ``batch``) of the speed
    configuration at ``hidden``: seeded weights with non-zero biases, so
    every path of the kernels is exercised."""
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    m = dataclasses.replace(model, N=n)
    solver = PricingSolver(m, "global", hidden=(hidden, hidden), **kw)
    params = solver.init_params(make_generator("cpu", SEED, 0))
    with torch.no_grad():
        gb = make_generator("cpu", SEED, 2)
        for b in params["gam"]["b"]:
            b.copy_(0.1 * torch.randn(b.shape, generator=gb))
    return m, rollout_inputs(solver, params, batch,
                             make_generator("cuda", SEED, 3))


def kernel_module(op):
    """The module of ``op``'s class, whose B1/B2 wrappers it launches
    (another version's ``ops/rollout.py`` in an A/B)."""
    return sys.modules[type(op).__module__]


def rollout_pair(op):
    """(B1, B2) wrappers that ``op`` launches at its width: its module's
    ``rollout_kernels`` (the wide pair at widths other than 8 and 21), or
    ``b1_forward``/``b2_backward`` in a version that predates it."""
    R = kernel_module(op)
    pick = getattr(R, "rollout_kernels", None)
    return pick(op.spec.hidden) if pick else (R.b1_forward, R.b2_backward)


def grad_errors(gk, gp):
    """(global-norm relative error, max abs error, per-leaf relative errors
    by ``ROLLOUT_LEAVES`` name) of the gradients ``gk`` against ``gp``."""
    num = math.sqrt(sum(float(torch.sum((a - b) ** 2))
                        for a, b in zip(gk, gp)))
    den = math.sqrt(sum(float(torch.sum(b ** 2)) for b in gp))
    grad_abs = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    leaf_rel = {n: float((a - b).norm()) / max(float(b.norm()), 1e-30)
                for n, a, b in zip(ROLLOUT_LEAVES, gk, gp)}
    return num / den, grad_abs, leaf_rel


def require_grads(what: str, rel: float, leaf_rel: dict) -> None:
    """Fail unless the global and every per-leaf relative error is within
    ``GRAD_REL_TOL``."""
    if not (math.isfinite(rel) and rel <= GRAD_REL_TOL):
        fail(f"{what}: gradients disagree with autograd of rollout_plain")
    off = [n for n, r in leaf_rel.items()
           if not (math.isfinite(r) and r <= GRAD_REL_TOL)]
    if off:
        fail(f"{what}: the gradients of {', '.join(off)} disagree with "
             "autograd of rollout_plain")


def straddling_paths(model, tabs, kernel_res, plain_res):
    """The paths whose kernel and plain forward trajectories lie, at some
    step, on two sides of a discontinuity of the rollout's gradient, or
    within a margin of one: the step's piece of the tables (the piece
    coordinate within 1e-5 of a boundary), the sign of y − A(x) in the
    coupling |y − A| (within 4e-6), or x_N against the payoff's strike K
    (within 1e-5).  Each is (x_N, xs, ys) of one trajectory."""
    from deepfbsdejsolvers_torch.ops.rollout import table_eval

    p = tabs["cc"].shape[1]
    lo, hi = tabs["lo"][:, None], tabs["hi"][:, None]
    out = torch.zeros_like(kernel_res[0], dtype=torch.bool)
    sides = []
    for xn, xs, ys in (kernel_res, plain_res):
        s = torch.clamp((xs - lo) / torch.clamp(hi - lo, min=1e-6), 0, 1) * p
        k = torch.clamp(torch.floor(s), 0, p - 1)
        with torch.no_grad():
            a = torch.stack([table_eval(tabs["pc"][i], xs[i], tabs["lo"][i],
                                        tabs["hi"][i])
                             for i in range(xs.shape[0])])
        u = ys - a
        out |= ((s - torch.round(s)).abs() < 1e-5).any(0)
        out |= (u.abs() < 4e-6).any(0) | ((xn - model.K).abs() < 1e-5)
        sides.append((k, torch.sign(u), xn > model.K))
    (k1, u1, g1), (k2, u2, g2) = sides
    return out | (k1 != k2).any(0) | (u1 != u2).any(0) | (g1 != g2)


def check_wide_grads(op, model, inputs, loss) -> dict:
    """Phase 2, the wide B2: its gradients held two ways against autograd
    of ``rollout_plain`` on the same inputs, each as a whole and leaf by
    leaf.  (a) B2 alone, replaying the plain version's own forward
    residuals and cotangents: the gradient of the same trajectory.  (b) B1
    then B2, as training runs them, over the paths whose two forward
    trajectories never straddle a discontinuity of the gradient
    (``straddling_paths``): where they do, a path's whole gradient lands in
    another piece or sign, and one such path in 2^14 moves the global norm
    ~1e-4; those paths get no weight in the loss, and they must be fewer
    than 1% of the paths.  B2 twice bit for bit."""
    R = kernel_module(op)
    b1, b2 = rollout_pair(op)
    gam, y0, tabs, dw, j = inputs
    leaves = grad_leaves(gam, y0, tabs)
    tf32 = {"head_tf32": True} if getattr(op.spec, "head_tf32", False) \
        else {}
    xp, yp, pxs, pys = R.rollout_plain(model, gam, y0, tabs, dw, j,
                                       op.spec.time_scale, residuals=True,
                                       **tf32)
    gp = torch.autograd.grad(loss(xp, yp), leaves, retain_graph=True)
    # (a): B2 on the plain trajectory
    xl, yl = xp.detach().requires_grad_(True), yp.detach().requires_grad_(True)
    cxn, cyn = torch.autograd.grad(loss(xl, yl), [xl, yl])
    (w1, w2, w3), (bb1, bb2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, bb1, w2, bb2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    out = b2(op.spec, weights, ktabs, dw, j, pxs.detach().contiguous(),
             pys.detach().contiguous(), cxn.contiguous(), cyn.contiguous())
    dw1, db1, dw2, db2, dw3, db3, dy0, dcc, dpc, dzc = R.b2_cotangents(
        out, op.spec, dw.shape[0])
    ga = [g.reshape(t.shape) for g, t in zip(
        (dw1, dw2, dw3, db1, db2, db3, dy0, dcc, dpc, dzc), leaves)]
    rel_a, abs_a, leaf_a = grad_errors(ga, gp)
    print(f"B2 on the plain trajectory: grad global-norm rel {rel_a:.3e} "
          f"(tol {GRAD_REL_TOL}, per leaf: "
          + ", ".join(f"{n} {r:.1e}" for n, r in leaf_a.items())
          + f"), max abs {abs_a:.3e}")
    require_grads("B2 on the plain trajectory", rel_a, leaf_a)
    # (b): B1 then B2, off the straddling paths
    with torch.no_grad():
        kxn, _, kxs, kys = b1(op.spec, weights, y0.detach(), ktabs, dw, j,
                              save=True)
    skip = straddling_paths(model, tabs, (kxn, kxs, kys),
                            (xp.detach(), pxs.detach(), pys.detach()))
    keep = (~skip).to(torch.float32)
    n_skip = int(skip.sum())
    masked = lambda x, y: torch.sum(keep * torch.square(y - model.payoff(x))
                                    ) / x.shape[0]
    gk = torch.autograd.grad(masked(*op(gam, y0, tabs, dw, j)), leaves)
    gk2 = torch.autograd.grad(masked(*op(gam, y0, tabs, dw, j)), leaves)
    gpm = torch.autograd.grad(masked(xp, yp), leaves)
    same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    rel_b, abs_b, leaf_b = grad_errors(gk, gpm)
    unmasked = grad_errors(torch.autograd.grad(
        loss(*op(gam, y0, tabs, dw, j)), leaves), gp)[0]
    print(f"B1 + B2 vs autograd of plain over {xp.shape[0] - n_skip} paths "
          f"({n_skip} straddle a discontinuity; over all: rel "
          f"{unmasked:.3e}): grad global-norm rel {rel_b:.3e} (tol "
          f"{GRAD_REL_TOL}, per leaf: "
          + ", ".join(f"{n} {r:.1e}" for n, r in leaf_b.items())
          + f"), max abs {abs_b:.3e}; rerun bit-identical: {same}")
    require_grads("B1 + B2", rel_b, leaf_b)
    if n_skip > 0.01 * xp.shape[0]:
        fail(f"{n_skip} of {xp.shape[0]} paths straddle a discontinuity: "
             "the kernels' forward leaves the plain version's")
    if not same:
        fail("two B2 runs on the same inputs differ")
    return {"max_abs_err": max(abs_a, abs_b), "rel_err": max(rel_a, rel_b),
            "straddling_paths": n_skip, "rel_err_all_paths": unmasked}


def tf32_step_errors(op, model, inputs):
    """The head-TF32 instance's forward held step by step, on every path and
    every step: B1's own trajectory (its residuals x_i and y_{i+1}) fed back
    a step at a time through the plain version's step under the same flag
    (``rollout_plain``'s body, run by its ``scan`` hook), each step's
    (x_{i+1}, y_{i+1}) against B1's.  Rounding to TF32 makes h1 a step
    function of x, so two trajectories that run freely a last bit apart
    land a whole TF32 unit (2^-11 of h1) apart where one of them crosses a
    step, and part by more than the forward tolerance; fed the same state,
    the kernel's h1 and the plain version's are the same bits (the first
    layer summed in the plain order, ``first_sum_tf32``), so no path is left
    out.  Returns per path the sum over the steps of max(|Δx|, |Δy|), the
    distance the kernel's own rounding puts between the two ends to first
    order, and (a count printed) how many paths' free runs end more than
    ``FWD_ABS_TOL`` apart."""
    R = kernel_module(op)
    gam, y0, tabs, dw, j = inputs
    (w1, w2, w3), (bb1, bb2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, bb1, w2, bb2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    errs = []

    def forced(body, carry, n):
        x_to = torch.cat([kxs[1:], kxn[None]])
        err = (kxs[0] - carry[0]).abs()
        for i in range(n):
            y_in = carry[1] if i == 0 else kys[i - 1]
            (x1, y1), _ = body((kxs[i], y_in), i)
            err = err + torch.maximum((x1 - x_to[i]).abs(),
                                      (y1 - kys[i]).abs())
        errs.append(err)
        return (kxn, kyn), None

    with torch.no_grad():
        kxn, kyn, kxs, kys = rollout_pair(op)[0](
            op.spec, weights, y0.detach(), ktabs, dw, j, save=True)
        R.rollout_plain(model, gam, y0, tabs, dw, j, op.spec.time_scale,
                        head_tf32=True, scan=forced)
        pxn, pyn = op.plain(gam, y0, tabs, dw, j)
    free = torch.maximum((kxn - pxn).abs(), (kyn - pyn).abs())
    n_free = int((free > FWD_ABS_TOL).sum())
    print(f"head TF32: B1 step by step on its own trajectory, every path: "
          f"the largest path's Σ_i max|Δ(x, y)| {float(errs[0].max()):.3e}"
          f" (tol {FWD_ABS_TOL}); free runs: {n_free} of "
          f"{free.shape[0]} paths end more than {FWD_ABS_TOL} apart "
          f"(max {float(free.max()):.3e}, TF32 steps crossed apart)")
    return errs[0]


def check_kernels(op, model, inputs) -> dict:
    """Phase 2: each kernel of ``op``'s width against the plain rollout on
    the same inputs: B1's (x_N, y_N) and loss; B2's gradients, and B2 twice
    bit for bit.  The specialised B2 through ``FusedRollout`` over all
    paths, as a whole (each leaf printed); the wide B2 as
    ``check_wide_grads`` says, as a whole and leaf by leaf (W1, W2, W3, b1,
    b2, b3, y0, cc, pc, zc), so that a wrong leaf the global norm would
    hide fails.  A head-TF32 ``op``'s forward is held step by step on its
    own trajectory (``tf32_step_errors``), its loss and gradients as the
    FP32 instance's."""
    b2 = rollout_pair(op)[1]
    gam, y0, tabs, dw, j = inputs
    loss = lambda x, y: torch.mean(torch.square(y - model.payoff(x)))
    with torch.no_grad():
        xk, yk = op(gam, y0, tabs, dw, j)
        xp, yp = op.plain(gam, y0, tabs, dw, j)
    if getattr(op.spec, "head_tf32", False):
        fwd_err = float(tf32_step_errors(op, model, inputs).max())
    else:
        fwd_err = max(float((xk - xp).abs().max()),
                      float((yk - yp).abs().max()))
    loss_rel = abs(float(loss(xk, yk)) - float(loss(xp, yp))) / abs(
        float(loss(xp, yp)))
    what = ("Σ_i max|Δ(x, y)| step by step"
            if getattr(op.spec, "head_tf32", False) else "max|Δ(x_N, y_N)|")
    print(f"B1 vs plain: {what} {fwd_err:.3e} (tol {FWD_ABS_TOL}),"
          f" loss rel {loss_rel:.3e} (tol {LOSS_REL_TOL})")
    if not (math.isfinite(fwd_err) and fwd_err <= FWD_ABS_TOL
            and loss_rel <= LOSS_REL_TOL):
        fail("B1 disagrees with rollout_plain")
    if op.spec.hidden not in kernel_module(op).KERNEL_WIDTHS:
        return {"B1": {"max_abs_err": fwd_err, "rel_err": loss_rel},
                "B2": check_wide_grads(op, model, inputs, loss)}

    leaves = grad_leaves(gam, y0, tabs)
    before = b2.launches
    gk = torch.autograd.grad(loss(*op(gam, y0, tabs, dw, j)), leaves)
    gk2 = torch.autograd.grad(loss(*op(gam, y0, tabs, dw, j)), leaves)
    if b2.launches - before != 2:
        fail(f"the gradient check did not run kernel {b2.__name__}")
    gp = torch.autograd.grad(loss(*op.plain(gam, y0, tabs, dw, j)), leaves)
    grad_rel, grad_abs, leaf_rel = grad_errors(gk, gp)
    same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    each = ", ".join(f"{n} {r:.1e}" for n, r in leaf_rel.items())
    print(f"B2 vs autograd of plain: grad global-norm rel {grad_rel:.3e} "
          f"(tol {GRAD_REL_TOL}; per leaf: {each}), max abs "
          f"{grad_abs:.3e}; rerun bit-identical: {same}")
    require_grads("B2", grad_rel, {})
    if not same:
        fail("two B2 runs on the same inputs differ")
    return {"B1": {"max_abs_err": fwd_err, "rel_err": loss_rel},
            "B2": {"max_abs_err": grad_abs, "rel_err": grad_rel}}


def float64_model(model):
    """``model`` with its paths started in float64, so that
    ``rollout_plain`` runs in float64 on float64 inputs."""
    m = dataclasses.replace(model)
    x0 = model.x0
    object.__setattr__(m, "init_x", lambda batch, device="cuda": torch.full(
        (batch,), x0, dtype=torch.float64, device=device))
    return m


def rollout_f64_distances(op, model, inputs) -> dict:
    """The loss's and each gradient leaf's relative distance from a float64
    evaluation of ``rollout_plain`` on the same inputs, for ``op``'s kernels
    (B1 then B2, through ``FusedRollout``) and for ``rollout_plain`` in
    f32, over the paths whose three trajectories (kernel, f32, float64)
    straddle no discontinuity of the gradient (``straddling_paths``; the
    count is printed): {"kernel": {...}, "plain": {...}, "straddling": n},
    each {"loss": d, leaf: d}."""
    R = kernel_module(op)
    gam, y0, tabs, dw, j = inputs
    leaves = grad_leaves(gam, y0, tabs)
    d64 = lambda t: t.detach().double().requires_grad_(t.requires_grad)
    gam64 = {k: [d64(t) for t in v] for k, v in gam.items()}
    tabs64 = {k: d64(v) for k, v in tabs.items()}
    y064 = d64(y0)
    leaves64 = grad_leaves(gam64, y064, tabs64)
    m64 = float64_model(model)
    res64 = R.rollout_plain(m64, gam64, y064, tabs64, dw.double(),
                            j.double(), op.spec.time_scale, residuals=True)
    res32 = R.rollout_plain(model, gam, y0, tabs, dw, j, op.spec.time_scale,
                            residuals=True)
    b1 = rollout_pair(op)[0]
    (w1, w2, w3), (bb1, bb2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, bb1, w2, bb2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    with torch.no_grad():
        kxn, _, kxs, kys = b1(op.spec, weights, y0.detach(), ktabs, dw, j,
                              save=True)
    tabs_d = {k: v.detach().double() for k, v in tabs.items()}
    trio = [(kxn, kxs, kys), tuple(t.detach() for t in
                                   (res32[0], res32[2], res32[3])),
            tuple(t.detach() for t in (res64[0], res64[2], res64[3]))]
    trio = [tuple(t.double() for t in r) for r in trio]
    skip = (straddling_paths(model, tabs_d, trio[0], trio[2])
            | straddling_paths(model, tabs_d, trio[1], trio[2]))
    keep = (~skip).double()
    masked = lambda x, y: torch.sum(keep.to(x.dtype) * torch.square(
        y - model.payoff(x))) / x.shape[0]
    l64 = masked(res64[0], res64[1])
    g64 = torch.autograd.grad(l64, leaves64)
    out = {"straddling": int(skip.sum())}
    for who, (x, y) in (("kernel", op(gam, y0, tabs, dw, j)),
                        ("plain", res32[:2])):
        lk = masked(x, y)
        gk = torch.autograd.grad(lk, leaves)
        d = {"loss": abs(float(lk.detach()) - float(l64.detach()))
             / abs(float(l64.detach()))}
        d.update({n: float((a.double() - b).norm() / b.norm())
                  for n, a, b in zip(ROLLOUT_LEAVES, gk, g64)})
        out[who] = d
        print(f"{who} vs float64 over {x.shape[0] - out['straddling']} "
              f"paths ({out['straddling']} straddle): "
              + ", ".join(f"{n} {r:.2e}" for n, r in d.items()))
    return out


def kernel_calls(op, inputs):
    """(B1 call, B2 call) of ``op``'s kernels (the pair of its width) on
    detached ``inputs``, as training launches them: B1 saving its
    residuals, B2 over them with unit cotangents.  Each call returns the
    kernel's outputs."""
    R = kernel_module(op)
    k1, k2 = rollout_pair(op)
    gam, y0, tabs, dw, j = inputs
    (w1, w2, w3), (b1, b2, b3) = gam["W"], gam["b"]
    weights = tuple(t.detach() for t in (w1, b1, w2, b2, w3))
    ktabs = {"cc": R._fold_b3(tabs["cc"].detach(), b3.detach()),
             "pc": tabs["pc"].detach(), "zc": tabs["zc"].detach(),
             "lo": tabs["lo"], "hi": tabs["hi"]}
    y0d = y0.detach()
    fwd = lambda: k1(op.spec, weights, y0d, ktabs, dw, j, save=True)
    _, _, xs, ys = fwd()
    cot = torch.ones_like(xs[0])
    return fwd, lambda: k2(op.spec, weights, ktabs, dw, j, xs, ys, cot, cot)


def time_kernels(op, inputs, plain_reps: int = 5) -> dict:
    """Each kernel's device time and its plain version's, at the inputs'
    shapes: B1 with residuals as in training against the plain forward
    under autograd, B2 against autograd's backward of the plain forward
    (one graph, run again and again, ``plain_reps`` times)."""
    gam, y0, tabs, dw, j = inputs
    fwd, bwd = kernel_calls(op, inputs)
    out = {"B1": {"ms": kernel_ms(fwd, reps=20)},
           "B2": {"ms": kernel_ms(bwd, reps=20)}}
    leaves = grad_leaves(gam, y0, tabs)
    plain_loss = lambda: torch.sum(sum(op.plain(gam, y0, tabs, dw, j)))
    out["B1"]["plain_ms"] = kernel_ms(plain_loss, reps=plain_reps)
    loss = plain_loss()
    out["B2"]["plain_ms"] = kernel_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
        reps=plain_reps)
    return out


def sweep_inputs(hidden: int, node_set: str, batch: int, tag: int,
                 n_mc: int = N_MC, form: str = "j"):
    """One call of a parity path's sweep at step 25: a head with non-zero
    biases, the node set in rank-1 form (the model's quadrature, or
    ``n_mc`` Monte-Carlo draws with uniform weights), spots drawn
    lognormally around x0, and a cotangent for B4.  ``form`` names the
    head and its node feature: on the Merton model's 49 nodes the Γ net on
    J ("j", global) or on e^J ("exp", multistep2/sumlocal2); on the
    Variance-Gamma model's 96 nodes the Γ net on X·J ("x_prop", a per-node
    a) or the one-output U-net on (t, X·(1 + J)) ("two_feature",
    multistep1/sumlocal1).  Returns ((x, a, c, W1, b1, v), g), detached and
    contiguous on the card."""
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.nets.mlp import MLPSpec, init_mlp
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_torch.ops.sweep import (
        rank1_three_feature, rank1_two_feature)
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    vg = form in ("x_prop", "two_feature")
    model = make_vg_default() if vg else make_merton_default()
    gcpu = make_generator("cpu", SEED, 6, tag)
    n_in = 2 if form == "two_feature" else 3
    head = init_mlp(gcpu, MLPSpec(n_in, (hidden, hidden), 1), "cuda")
    head["b"] = [0.1 * torch.randn(b.shape, generator=gcpu).cuda()
                 for b in head["b"]]
    gen = make_generator("cuda", SEED, 7, tag)
    if node_set == "mc":
        nodes = model.sample_jumps(gen, (n_mc,))
        weights = torch.full_like(nodes, 1.0 / n_mc)
    else:
        nodes, weights = (t.cuda() for t in
                          model.jump_quadrature(CompensatorSpec()))
    t25 = torch.tensor(25.0, device="cuda")
    with torch.no_grad():
        if form == "two_feature":
            a, c, v, _ = rank1_two_feature(head, t25, 1.0 + nodes, weights)
        else:
            feat = torch.exp(nodes) if form == "exp" else nodes
            a, c, v, _ = rank1_three_feature(head, t25, feat,
                                             form == "x_prop", weights)
    x = model.x0 * torch.exp(0.3 * torch.randn(batch, generator=gen,
                                               device="cuda"))
    g = torch.randn(batch, generator=gen, device="cuda") / batch
    args = tuple(t.detach().contiguous()
                 for t in (x, a, c, head["W"][1], head["b"][1], v))
    return args, g


def plain_sweep_and_grads(args, g, max_elems: int = PLAIN_GRID):
    """``sweep_plain``'s output and autograd's gradients of (x, a, c, W1,
    b1, v) for the cotangent ``g``, over node blocks of at most
    ``max_elems`` M·B·H grid elements each (one block below that): the
    sweep is a sum over nodes, so the blocks' outputs and their x, W1, b1
    gradients add up and their node gradients stack."""
    from deepfbsdejsolvers_torch.ops import sweep as S

    x, a, c, w1, b1, v = args
    m, h = a.shape
    step = max(1, max_elems // (x.shape[0] * h))
    out, parts = 0.0, []
    for k in range(0, m, step):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x, a[k:k + step], c[k:k + step], w1, b1,
                            v[k:k + step])]
        o = S.sweep_plain(*leaves)
        parts.append(torch.autograd.grad(o, leaves, g))
        out = out + o.detach()
    dx, dw1, db1 = (sum(p[i] for p in parts) for i in (0, 3, 4))
    da, dc, dv = (torch.cat([p[i] for p in parts]) for i in (1, 2, 5))
    return out, (dx, da, dc, dw1, db1, dv)


def check_sweep(args, g, kernels=None) -> dict:
    """Phase 2: B3 against ``sweep_plain``, B4 against autograd of it, on
    the same inputs, through the kernel pair of the head's width (the
    specialised B3/B4 at 8 and 21, the wide pair elsewhere; or the
    (forward, backward) ``kernels`` given); B4's gradients held as a whole
    and each leaf (x, a, c, W1, b1, v) on its own, so a wrong leaf that the
    global norm would hide fails; B4 twice bit for bit."""
    from deepfbsdejsolvers_torch.ops import sweep as S

    fwd, bwd = kernels or S.sweep_kernels(args[1].shape[1])
    with torch.no_grad():
        out_k = fwd(*args)
    out_p, gp = plain_sweep_and_grads(args, g)
    fwd_err = float((out_k - out_p).abs().max())
    fwd_rel = fwd_err / float(out_p.abs().max())
    print(f"B3 vs plain: max|Δ out| {fwd_err:.3e}, relative to max|out| "
          f"{fwd_rel:.3e} (tol {SWEEP_REL_TOL})")
    if not (math.isfinite(fwd_rel) and fwd_rel <= SWEEP_REL_TOL):
        fail("B3 disagrees with sweep_plain")
    gk = bwd(*args, g)
    gk2 = bwd(*args, g)
    same = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    num = math.sqrt(sum(float(torch.sum((a - b) ** 2))
                        for a, b in zip(gk, gp)))
    den = math.sqrt(sum(float(torch.sum(b ** 2)) for b in gp))
    grad_rel = num / den
    grad_abs = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    leaf_rel = {n: float((a - b).norm() / b.norm()) for n, a, b
                in zip(("x", "a", "c", "W1", "b1", "v"), gk, gp)}
    each = ", ".join(f"{n} {r:.1e}" for n, r in leaf_rel.items())
    print(f"B4 vs autograd of plain: grad global-norm rel {grad_rel:.3e} "
          f"(tol {GRAD_REL_TOL}, also per leaf: {each}), max abs "
          f"{grad_abs:.3e}; rerun bit-identical: {same}")
    if not (math.isfinite(grad_rel) and grad_rel <= GRAD_REL_TOL):
        fail("B4 gradients disagree with autograd of sweep_plain")
    off = [n for n, r in leaf_rel.items()
           if not (math.isfinite(r) and r <= GRAD_REL_TOL)]
    if off:
        fail(f"B4's gradients of {', '.join(off)} disagree with autograd "
             "of sweep_plain")
    if not same:
        fail("two B4 runs on the same inputs differ")
    return {"B3": {"max_abs_err": fwd_err, "rel_err": fwd_rel},
            "B4": {"max_abs_err": grad_abs, "rel_err": grad_rel}}


def f64_distances(args, g, kernels=None) -> dict:
    """Each gradient leaf's relative distance from a float64 evaluation
    of the sweep (``plain_sweep_and_grads`` on the inputs in float64, summed
    over node blocks as the plain reference is), for B4 (the pair of the
    head's width, or ``kernels``) and for autograd of ``sweep_plain`` in
    f32: {"kernel": {leaf: d}, "plain": {leaf: d}}."""
    from deepfbsdejsolvers_torch.ops import sweep as S

    bwd = (kernels or S.sweep_kernels(args[1].shape[1]))[1]
    _, g64 = plain_sweep_and_grads(tuple(t.double() for t in args),
                                   g.double(), max_elems=PLAIN_GRID // 4)
    _, g32 = plain_sweep_and_grads(args, g)
    gk = bwd(*args, g)
    leaves = ("x", "a", "c", "W1", "b1", "v")
    out = {who: {n: float((a.double() - b).norm() / b.norm())
                 for n, a, b in zip(leaves, grads, g64)}
           for who, grads in (("kernel", gk), ("plain", g32))}
    for who, d in out.items():
        print(f"{who} vs float64: " + ", ".join(f"{n} {r:.2e}"
                                                for n, r in d.items()))
    return out


def time_sweep(args, g, node_block=None) -> dict:
    """B3 and B4 (the pair of the head's width) against their plain
    versions at these inputs' shapes: B3
    against ``sweep_plain`` without autograd, B4 against autograd's
    backward of it (one graph, run again and again).  With ``node_block``
    the plain versions run over blocks
    of that many nodes, as the solver's plain sweep does when the whole
    [M, B, H] grid does not fit: the forward summed block by block, the
    backward through blocks under torch.utils.checkpoint (its time includes
    each block's recomputed forward)."""
    from torch.utils.checkpoint import checkpoint

    from deepfbsdejsolvers_torch.ops import sweep as S

    m = args[1].shape[0]
    step = m if node_block is None else node_block
    blocks = [slice(k, k + step) for k in range(0, m, step)]
    reps = 10 if node_block is None else 3

    def plain(x, a, c, w1, b1, v, remat=False):
        one = lambda s: S.sweep_plain(x, a[s], c[s], w1, b1, v[s])
        if remat:
            return sum(checkpoint(one, s, use_reentrant=False)
                       for s in blocks)
        return sum(one(s) for s in blocks)

    fwd, bwd = S.sweep_kernels(args[1].shape[1])
    out = {"B3": {"ms": kernel_ms(lambda: fwd(*args), reps=reps)},
           "B4": {"ms": kernel_ms(lambda: bwd(*args, g), reps=reps)}}
    with torch.no_grad():
        out["B3"]["plain_ms"] = kernel_ms(lambda: plain(*args),
                                          reps=max(1, reps // 3))
    leaves = [t.clone().requires_grad_(True) for t in args]
    y = plain(*leaves, remat=node_block is not None)
    out["B4"]["plain_ms"] = kernel_ms(
        lambda: torch.autograd.grad(y, leaves, g, retain_graph=True),
        reps=max(1, reps // 3))
    return out


ICDF_SHAPE = (N_STEPS, 2**20)     # the fused benchmark cell's J


def icdf_phase() -> dict:
    """The icdf jump kernel (``ops/noise.py``) at ``ICDF_SHAPE``: its J
    bit for bit the plain version's at μJ = 0 and −0.1, then its time, the
    plain version's, the two draws' (u and z) and its memory bound (12
    bytes an element at 3.35 TB/s); the kernel table's row, to which
    ``main`` adds the launches of the main paths."""
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.ops import noise

    g = torch.Generator(device="cuda").manual_seed(2**31 + 17)
    u = torch.rand(ICDF_SHAPE, generator=g, device="cuda")
    z = torch.randn(ICDF_SHAPE, generator=g, device="cuda")
    err = 0.0
    for mu_j in (0.0, -0.1):
        model = dataclasses.replace(make_merton_default(jump_sampler="icdf"),
                                    muJ=mu_j)
        cdf = model.tables("cpu")["poisson_cdf"]
        got = noise.icdf_jumps(u, z, cdf, model.muJ, model.sigJ)
        want = noise.icdf_jumps_plain(u, z, cdf.cuda(), model.muJ,
                                      model.sigJ)
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"icdf_jumps differs from its plain version at μJ {mu_j} "
                 f"(max |Δ| {err:.3e})")
    args = (u, z, cdf, model.muJ, model.sigJ)
    plain_args = (u, z, cdf.cuda(), model.muJ, model.sigJ)
    ms = kernel_ms(lambda: noise.icdf_jumps(*args), reps=50)
    plain_ms = kernel_ms(lambda: noise.icdf_jumps_plain(*plain_args), reps=10)
    draws_ms = kernel_ms(lambda: (
        torch.rand(ICDF_SHAPE, generator=g, device="cuda"),
        torch.randn(ICDF_SHAPE, generator=g, device="cuda")), reps=10)
    n = u.numel()
    bound_ms = 12 * n / 3.35e12 * 1e3
    print(f"icdf_jumps at {ICDF_SHAPE}: bit-identical at μJ 0 and −0.1; "
          f"{ms:.4f} ms (bound {bound_ms:.4f}, plain {plain_ms:.4f}, the "
          f"draws u and z {draws_ms:.4f})")
    return {"name": "icdf_jumps", "route": "cuda",
            "source": "deepfbsdejsolvers_torch/csrc/icdf_jumps.cu",
            "replaces": None, "check": "pass", "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms, "draws_ms": draws_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "shape": {"N": ICDF_SHAPE[0], "B": ICDF_SHAPE[1]}}


def profile_steps(step, gen, step_ms: float, steps: int = 3,
                  names: list | None = None):
    """Device time per training step by kernel (torch.profiler), and the
    device's idle share against the unprofiled step time; returns (busy
    ms, device ops) per step, or None when the profiler saw no device
    time.  ``names``, when given, receives every device kernel's name."""
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
    if names is not None:
        names.extend(r[2] for r in rows)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print("profile: the profiler recorded no device time")
        return None
    ops = sum(r[1] for r in rows)
    print(f"profile: device busy {busy:.3f} ms of a {step_ms:.3f} ms step "
          f"(idle share {1 - busy / step_ms:.3f}), {ops:.0f} device ops "
          "per step")
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"  {ms:8.4f} ms  x{count:5.1f}  {name[:100]}")
    return busy, ops


def train_path(solver_kw: dict, per_step: dict, per_eval: dict, counters,
               facade: str = "Global", steps: int = 10, epochs: int = 2,
               hidden: int = HIDDEN):
    """Phase 3: train one path through the facade ``facade`` (a key of
    ``SOLVER_CLASSES``) with hidden (``hidden``, ``hidden``) at batch 2^17
    for ``epochs`` outer epochs of ``steps`` steps, with every kernel's
    launch counter set to 0 just
    before and read just after; fails unless each kernel launched exactly
    ``per_step`` times per training step plus ``per_eval`` times per
    epoch's validation evaluation (a kernel absent from both: never).
    Returns the trainer and the launches."""
    from deepfbsdejsolvers_torch.solvers.api import SOLVER_CLASSES
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    trainer = SOLVER_CLASSES[facade](lrate=4e-4, hidden=(hidden, hidden),
                                     seed=SEED, **solver_kw)
    y0_init = float(trainer.core.y0_estimate(trainer.core.init_params(
        make_generator("cpu", SEED, 0))).detach())
    for fn in counters.values():
        fn.launches = 0
    y0s, duration = trainer.train(TRAIN_BATCH, TRAIN_BATCH, steps, epochs,
                                  verbose=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"train: launches {launches}, Y0 {y0_init:.6f} -> {y0s}, losses "
          f"{trainer.lossList}, {duration:.3f} s")
    if not all(math.isfinite(v) for v in trainer.lossList + y0s):
        fail("training produced a non-finite loss or Y0")
    if y0s[-1] == y0_init:
        fail("Y0 did not move in training")
    want = {k: steps * epochs * per_step.get(k, 0)
            + epochs * per_eval.get(k, 0) for k in counters}
    if launches != want:
        fail(f"kernel launches {launches}, the code implies {want}")
    return trainer, launches


def time_step(trainer, tag: int, label: str, reps: int = 5,
              names: list | None = None):
    """Device time of one training step of ``trainer``'s path (CUDA
    events, after a warm-up), its rate, and its profile (every device
    kernel's name into ``names`` when given)."""
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    params = trainer.params
    loss_fn = trainer.core.build_loss(TRAIN_BATCH)
    step = make_step(loss_fn, make_adam(params, 4e-4), params)
    gen = make_generator("cuda", SEED, tag)
    step_ms = cuda_ms(lambda: step(gen), reps=reps)
    n = trainer.core.model.N
    rate = TRAIN_BATCH * n / (step_ms * 1e-3)
    print(f"{label} train step: {step_ms:.3f} ms at batch {TRAIN_BATCH}, N "
          f"{n} ({rate:.4g} paths·steps/s)")
    profile_steps(step, gen, step_ms, steps=2, names=names)
    return step_ms, rate


def mfg_step(solver, params, batch: int, tag: int, reps: int, label: str,
             profile: bool = False) -> dict:
    """Time (``cuda_ms``) and, with ``profile``, profile an Adam step of
    ``solver``'s coupled loss at ``batch``: {"ms", "busy_ms", "ops"}."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    for t in param_leaves(params):
        t.requires_grad_(True)
    step = make_step(solver.build_losses(batch)["coupled"],
                     make_adam(params, 1e-3), params)
    gen = make_generator("cuda", SEED, tag)
    ms = cuda_ms(lambda: step(gen), reps=reps, warmup=1)
    print(f"MFG {label} train step: {ms:.3f} ms at batch {batch}, N "
          f"{solver.model.N}")
    out = {"ms": ms}
    if profile:
        prof = profile_steps(step, gen, ms, steps=2)
        if prof is not None:
            out.update(busy_ms=prof[0], ops=prof[1])
    return out


def mfg_train(solver, label: str, couplage: str = "ON") -> dict:
    """Phase 5: 2 outer epochs of 2 Adam steps of ``solver`` at batch
    ``MFG_BATCH`` through ``MFGSolver.train``; fails on a non-finite loss
    or read-out, or a Y0 pair that did not move."""
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    y0_init = tuple(float(v) for v in solver.y0_estimates(
        solver.init_params(make_generator("cpu", SEED, 0))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.train(SEED, MFG_BATCH, MFG_BATCH, 2, 2, 1e-3,
                       couplage=couplage, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    y0 = (res.y0_hat_history[-1], res.y0_history[-1])
    print(f"MFG {label} (couplage {couplage}): losses {res.loss_history}, "
          f"(Y0_hat, Y0) {y0_init} -> {y0}, {seconds:.2f} s")
    values = res.loss_history + res.y0_hat_history + res.y0_history
    if not all(math.isfinite(v) for v in values):
        fail(f"MFG {label}: a non-finite loss or read-out")
    if y0 == y0_init:
        fail(f"MFG {label}: (Y0_hat, Y0) did not move in training")
    return {"result": res, "seconds": seconds}


def check_poisson(model, rates_hq=(0.6, 0.74, 0.9), draws=2**20) -> dict:
    """torch.poisson on the card at the Cox rates λ·dt of hQ at the
    profile's trough, its peak and a +5σ excursion: mean within 4.5
    standard errors (+1e-3) of λ·dt, variance over mean within 1e-2."""
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    gen = make_generator("cuda", SEED, 61)
    out = {}
    for hq in rates_hq:
        lam_dt = float(model.intensity_of(torch.tensor(hq)) * model.dt)
        dn = torch.poisson(torch.full((draws,), lam_dt, device="cuda"),
                           generator=gen).double()
        mean, ratio = float(dn.mean()), float(dn.var()) / lam_dt
        print(f"torch.poisson at λ·dt {lam_dt:.6g}: mean {mean:.6g}, "
              f"var/mean {ratio:.5f} ({draws} draws)")
        if abs(mean - lam_dt) > 4.5 * math.sqrt(lam_dt / draws) + 1e-3:
            fail(f"torch.poisson mean {mean} at λ·dt {lam_dt}")
        if abs(ratio - 1.0) > 1e-2:
            fail(f"torch.poisson var/mean {ratio} at λ·dt {lam_dt}")
        out[f"{lam_dt:.6g}"] = {"mean": mean, "var_over_mean": ratio}
    return out


def mfg_phases(counters) -> dict:
    """Phase 5: the smart-grid MFG model on the card (no kernel may
    launch): the comparison model's global scheme with the icdf sampler
    (train, time, profile), the exact sampler and torch.poisson's moments,
    the four other schemes (sumlocal also couplage OFF), the Picard warm
    start on the linear-quadratic corner against the exact oracle, and the
    frozen-noise replay of the trained global policy with its Price of
    Anarchy against itself."""
    from deepfbsdejsolvers_torch.eval.mfg_lq_oracle import solve_lq
    from deepfbsdejsolvers_torch.eval.mfg_solutions import (
        FrozenNoise, MFGFixedTrajectoryEvaluator, draw_frozen_noise,
        price_of_anarchy)
    from deepfbsdejsolvers_torch.experiments.configs import (
        MFGComparisonConfig)
    from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
        make_mfg_default)
    from deepfbsdejsolvers_torch.solvers.mfg import MFGSolver
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    t_start = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    out = {"steps": {}, "train_s": {}}
    icdf = dataclasses.replace(make_mfg_default(), jump_sampler="icdf")
    print(f"MFG comparison model: N {icdf.N}, hidden (20, 20) / (22, 22), "
          f"batch {MFG_BATCH}, icdf depth {icdf._icdf_k_eff}")
    glob = MFGSolver(icdf, "global", device="cuda")
    trained = mfg_train(glob, "global icdf")
    out["train_s"]["global"] = trained["seconds"]
    params = trained["result"].params
    out["steps"]["global"] = mfg_step(glob, params, MFG_BATCH, 50, 5,
                                      "global icdf", profile=True)

    exact = MFGSolver(make_mfg_default(), "global", device="cuda")
    out["steps"]["global_exact"] = mfg_step(
        exact, exact.init_params(make_generator("cpu", SEED, 0)),
        MFG_BATCH, 51, 2, "global exact")
    out["poisson"] = check_poisson(icdf)

    for k, scheme in enumerate(("multistep", "sumlocal", "sumlocal_reg",
                                "multistep_reg")):
        solver = MFGSolver(icdf, scheme, device="cuda")
        res = mfg_train(solver, scheme)
        out["train_s"][scheme] = res["seconds"]
        out["steps"][scheme] = mfg_step(solver, res["result"].params,
                                        MFG_BATCH, 52 + k, 2, scheme)
    out["train_s"]["sumlocal_off"] = mfg_train(
        MFGSolver(icdf, "sumlocal", device="cuda"), "sumlocal",
        couplage="OFF")["seconds"]

    lq = dataclasses.replace(make_mfg_default(f0=0.0, f1=0.0),
                             jump_sampler="icdf")
    oracle = solve_lq(lq)
    lq_solver = MFGSolver(lq, "global", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = lq_solver.warm_start_y0(
        lq_solver.init_params(make_generator("cpu", SEED, 0)),
        make_generator("cuda", SEED, 62), batch=MFG_WARM_BATCH,
        n_picard=MFG_PICARD)
    warm_y0 = (float(warm["hat"]["y0"]), float(warm["full"]["y0"]))
    rel = [abs(v - w) / abs(w) for v, w in zip(warm_y0,
                                                (oracle.y0_hat, oracle.y0))]
    print(f"MFG warm start on the LQ model ({MFG_WARM_BATCH} paths, "
          f"{MFG_PICARD} iterates, {time.perf_counter() - t0:.2f} s): "
          f"(Y0_hat, Y0) {warm_y0}, oracle {oracle.y0_hat:.6f}, rel {rel}")
    if max(rel) > 2e-2:
        fail(f"MFG warm start {warm_y0} not within 2e-2 of {oracle.y0_hat}")
    out["warm_start"] = {"y0": warm_y0, "oracle": oracle.y0_hat,
                         "rel": max(rel)}

    n_sim = MFGComparisonConfig().n_simulation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dw0, dws, dn = draw_frozen_noise(icdf, make_generator("cuda", SEED, 63),
                                     n_sim)
    noise = FrozenNoise(dW0=dw0, dW=dws[0], dN=dn)
    ev = MFGFixedTrajectoryEvaluator(glob, params, noise)
    tr = ev.simulate_all_processes(n_sim)
    cost, std = ev.objective_function()
    poa = price_of_anarchy(ev, MFGFixedTrajectoryEvaluator(glob, params,
                                                           noise), n_sim)
    replay_s = time.perf_counter() - t0
    print(f"MFG frozen replay of the global policy on {n_sim} paths "
          f"({replay_s:.2f} s): cost {cost:.6g} ± {1.96 * std / n_sim**0.5:.4g}"
          f", PoA against itself {poa['poa']!r}")
    if not (math.isfinite(cost) and all(np.isfinite(v).all()
                                        for v in tr.values())):
        fail("MFG frozen replay: a non-finite process or objective")
    if poa["poa"] != 1.0:
        fail(f"MFG PoA of a policy against itself is {poa['poa']!r}, not 1")
    out["replay"] = {"paths": n_sim, "cost": cost, "std": std,
                     "poa_self": poa["poa"], "seconds": replay_s}

    launched = {k: fn.launches for k, fn in counters.items()}
    print(f"MFG phases: launches {launched} (none may launch), "
          f"{time.perf_counter() - t_start:.1f} s")
    if any(launched.values()):
        fail(f"the MFG paths launched kernels: {launched}")
    out["launches"] = launched
    out["seconds"] = time.perf_counter() - t_start
    return out


def cli_run(label: str, argv, counters, want: dict, outdir: str):
    """Phase 6: one run of the experiment CLI in this process (``cli.main``,
    what ``python -m deepfbsdejsolvers_torch`` calls) on the card, writing
    into ``outdir``, every launch counter set to 0 just before and read just
    after; fails unless it exits 0 and each kernel launched exactly
    ``want`` times (a kernel absent from ``want``: never).  Returns the
    run's metrics records and seconds."""
    from deepfbsdejsolvers_torch.experiments import cli
    from deepfbsdejsolvers_torch.utils.logging import read_jsonl

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main([*argv, "--outdir", outdir, "--quiet"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    want = {k: want.get(k, 0) for k in counters}
    print(f"CLI {label}: `{' '.join(argv)}` exit {rc}, launches "
          f"{ {k: n for k, n in launched.items() if n} }, {seconds:.1f} s")
    if rc != 0:
        fail(f"CLI {label} exited {rc}")
    if launched != want:
        fail(f"CLI {label} launched {launched}, the code implies {want}")
    path = os.path.join(outdir, "metrics.jsonl")
    return (read_jsonl(path) if os.path.isfile(path) else []), seconds


def cli_method_runs(cmd: str, table: dict, counters, tmp: str) -> dict:
    """Phase 6: ``cmd`` (merton or vg) at the reference's defaults, one
    method a run, cut to 2 outer epochs of 2 steps: each method's exact
    launches, the sweep every one of its records names, a finite Y0."""
    out = {}
    for method, (impl, b3, b4, b3_eval) in table.items():
        kernels = {"B3": CLI_EPOCHS * (CLI_STEPS * b3 + b3_eval),
                   "B4": CLI_EPOCHS * CLI_STEPS * b4}
        records, seconds = cli_run(
            f"{cmd} {method}",
            [cmd, "--methods", method, "--nEpochExt", str(CLI_EPOCHS),
             "--nEpoch", str(CLI_STEPS)], counters, kernels,
            os.path.join(tmp, f"{cmd}_{method}"))
        mine = [r for r in records if r.get("method") == method]
        impls = {r["sweep_impl"] for r in mine}
        done = [r for r in mine if r.get("event") == "method_done"]
        if impls != {impl} or len(done) != 1:
            fail(f"CLI {cmd} {method}: records name sweeps {impls}, "
                 f"expected {impl!r}")
        if not math.isfinite(done[0]["y0"]):
            fail(f"CLI {cmd} {method}: Y0 {done[0]['y0']}")
        out[method] = {"sweep_impl": impl, "y0": done[0]["y0"],
                       "seconds": seconds, **kernels}
    return out


def _epoch_record(records, epoch: int) -> dict:
    """The last record of outer epoch ``epoch`` in a metrics log."""
    return [r for r in records if r.get("epoch") == epoch][-1]


def cli_phases(counters, tmp: str) -> dict:
    """Phase 6: the experiment CLI on the card.  The four subcommands at
    the reference's defaults with cut epochs (merton and vg one method a
    run, the MFG ones with cut --nbSimulation and --nFrozen, launching no
    kernel); merton --nbNeuron 64 and vg --nbNeuron 128 at batch 2^17 on
    the wide kernels; a run resumed from its checkpoints against the uncut
    run; --profileDir; --debugNans."""
    from deepfbsdejsolvers_torch.utils.checkpointing import (
        restore_checkpoint)

    t_start = time.perf_counter()
    out = {"merton": cli_method_runs("merton", CLI_MERTON, counters, tmp),
           "vg": cli_method_runs("vg", CLI_VG, counters, tmp)}
    cut = ["--nEpochExt", "1", "--nEpoch", "2"]
    for cmd, extra in (("mfg-compare", ["--nbSimulation", "1000"]),
                       ("mfg-poa", ["--nFrozen", "100"])):
        records, seconds = cli_run(cmd, [cmd, *cut, *extra], counters, {},
                                   os.path.join(tmp, cmd))
        out[cmd] = {"seconds": seconds, "records": len(records)}

    for cmd, width, n in CLI_WIDE:
        kernels = {"B3w": CLI_EPOCHS * (CLI_STEPS + 1) * n,
                   "B4w": CLI_EPOCHS * CLI_STEPS * n}
        records, seconds = cli_run(
            f"{cmd} wide", [cmd, "--nbNeuron", str(width), "--methods",
                            "Global", "--batchSize", str(TRAIN_BATCH),
                            "--nEpochExt", str(CLI_EPOCHS), "--nEpoch",
                            str(CLI_STEPS)], counters, kernels,
            os.path.join(tmp, f"{cmd}_wide"))
        done = [r for r in records if r.get("event") == "method_done"][0]
        if done["sweep_impl"] != "pallas" or not math.isfinite(done["y0"]):
            fail(f"CLI {cmd} --nbNeuron {width}: {done}")
        out[f"{cmd}_{width}"] = {"y0": done["y0"], "seconds": seconds,
                                 **kernels}

    # resume: 3 outer epochs uncut, against 2 then --resume to 3
    base = ["merton", "--methods", "Global", "--nEpoch", str(RESUME_STEPS),
            "--checkpointEvery", "1"]
    per_epoch = {"B3": (RESUME_STEPS + 1) * N_STEPS,
                 "B4": RESUME_STEPS * N_STEPS}
    times = lambda k: {name: k * n for name, n in per_epoch.items()}
    dir_a, dir_b = os.path.join(tmp, "uncut"), os.path.join(tmp, "resumed")
    rec_a, _ = cli_run("uncut", base + ["--nEpochExt", "3"], counters,
                       times(3), dir_a)
    cli_run("two epochs", base + ["--nEpochExt", "2"], counters, times(2),
            dir_b)
    rec_b, _ = cli_run("resumed", base + ["--nEpochExt", "3", "--resume"],
                       counters, times(1), dir_b)
    ra, rb = _epoch_record(rec_a, 2), _epoch_record(rec_b, 2)
    state = [restore_checkpoint(os.path.join(d, "ckpt", "Global", "step_2"))
             for d in (dir_a, dir_b)]
    same_params = all(torch.equal(x, y) for x, y in
                      zip(state[0]["params"], state[1]["params"]))
    same = ra["y0"] == rb["y0"] and ra["loss"] == rb["loss"] and same_params
    rel = max(abs(ra[k] - rb[k]) / abs(ra[k]) for k in ("y0", "loss"))
    print(f"resume: third epoch uncut (Y0 {ra['y0']!r}, loss "
          f"{ra['loss']!r}), resumed (Y0 {rb['y0']!r}, loss "
          f"{rb['loss']!r}); params equal {same_params}; bit-identical "
          f"{same}" + ("" if same else f", NOT bit-identical: rel {rel:.3e}"
                       " (tol 1e-6)"))
    if not same and not rel <= 1e-6:
        fail("the resumed run left the uncut run's third epoch")
    out["resume"] = {"bit_identical": same, "rel": rel, "y0": ra["y0"],
                     "loss": ra["loss"]}

    trace_dir = os.path.join(tmp, "trace")
    cli_run("profile", ["merton", "--methods", "Global", *cut,
                        "--profileDir", trace_dir], counters,
            {"B3": 3 * N_STEPS, "B4": 2 * N_STEPS},
            os.path.join(tmp, "profiled"))
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.startswith("trace_")]     # spans_*.json lies beside it
    sizes = [os.path.getsize(f) for f in traces]
    if not traces or min(sizes) == 0:
        fail(f"--profileDir wrote {traces} of sizes {sizes}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"profile: {len(traces)} trace of {sizes[0]} bytes, "
          f"{len(events)} events, {n_kernels} device kernels")
    out["profile"] = {"bytes": sizes[0], "events": len(events),
                      "kernels": n_kernels}

    records, _ = cli_run("NaN guard", ["merton", "--methods", "Global", *cut,
                                       "--debugNans"], counters,
                         {"B3": 3 * N_STEPS, "B4": 2 * N_STEPS},
                         os.path.join(tmp, "nan_guard"))
    y0 = _epoch_record(records, 0)["y0"]
    if not math.isfinite(y0) or torch.is_anomaly_enabled():
        fail(f"--debugNans: Y0 {y0}, anomaly mode left "
             f"{torch.is_anomaly_enabled()}")
    out["seconds"] = time.perf_counter() - t_start
    print(f"CLI phases: {out['seconds']:.1f} s")
    return out


def bench_phases(counters) -> dict:
    """Phase 7: the bench through the CLI (``cli.main(["bench", ...])``, what
    ``python -m deepfbsdejsolvers_torch bench`` runs) in this process, a
    cell of ``BENCH_CELLS`` a run, every launch counter set to 0 just before
    and read just after: exit 0, bench.py's one JSON line (its keys, the
    cell's metric, a finite positive value), and exactly the cell's
    launches.  Returns each cell's JSON, seconds and launches."""
    import contextlib
    import io

    from deepfbsdejsolvers_torch.experiments import cli

    t_start = time.perf_counter()
    out = {}
    for label, argv, want in BENCH_CELLS:
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", *argv])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: fn.launches for k, fn in counters.items()}
        want = {k: want.get(k, 0) for k in counters}
        lines = buf.getvalue().strip().splitlines()
        cut = (" (cut from bench.py's --inner 10 --rounds 3)"
               if "--inner" in argv else "")
        print(f"bench {label}: `bench {' '.join(argv)}` exit {rc}, "
              f"{seconds:.1f} s, launches "
              f"{ {k: n for k, n in launched.items() if n} }{cut}")
        print(lines[-1] if lines else "(no output)")
        if rc != 0 or not lines:
            fail(f"bench {label} exited {rc}")
        rec = json.loads(lines[-1])
        model = argv[argv.index("--model") + 1] if "--model" in argv \
            else "merton"
        if (list(rec) != ["metric", "value", "unit", "vs_baseline"]
                or rec["metric"] != f"{model}_global_train_throughput"
                or not (math.isfinite(rec["value"]) and rec["value"] > 0)):
            fail(f"bench {label} printed {rec}")
        if launched != want:
            fail(f"bench {label} launched {launched}, the code implies "
                 f"{want}")
        out[label] = {"argv": argv, "json": rec, "seconds": seconds,
                      "launches": {k: n for k, n in launched.items() if n}}
    out["seconds"] = time.perf_counter() - t_start
    print(f"bench phases: {out['seconds']:.1f} s")
    return out


# The data-parallel phases (``dp_phases``): ranks spawned on this card,
# each reporting back its launches, losses, errors and parameter digests.
# (a) NCCL, a world of one; (b) gloo, 2 data ranks; (c) gloo, a 2 × 2
# (data, comp) mesh; a rank still running after DP_TIMEOUT seconds fails
# the phase.  DP_STEPS training updates in (b) and (c), the first untimed.
DP_TIMEOUT, DP_STEPS = 300.0, 4
# (c)'s float64 run of the sharded and the unsharded loss through the plain
# sweep: every gradient leaf held (as ``dp_errors`` holds them) within this
# of the other (3.1e-11 on the CPU at 4096 paths a rank).  In f32 the Γ
# head's leaves, differences of the realized Γ and its compensator that
# cancel to ~1e-3 of the gradient's norm, sit 2e-5 to 2e-3 from float64 in
# either run (CPU, 1024 and 4096 paths a rank), so the f32 runs do not
# agree on them to GRAD_REL_TOL: those leaves are held per leaf here, in
# float64, and in f32 as part of the global norm; their f32 distances are
# printed.
DP_F64_TOL = 1e-9


class ShardMean:
    """``loss(params, generator)``: the mean over ``n`` data shards of
    ``loss_fn`` at ``fold_in(generator, i)``, in one process; the shards'
    generators persist while ``generator`` does, as each data rank's does
    under a mesh."""

    def __init__(self, loss_fn, n: int):
        self.loss_fn, self.n, self.gen, self.shards = loss_fn, n, None, []

    def __call__(self, params, generator):
        from deepfbsdejsolvers_torch.solvers.train import fold_in

        if generator is not self.gen:
            self.gen = generator
            self.shards = [fold_in(generator, i) for i in range(self.n)]
        return torch.mean(torch.stack([self.loss_fn(params, g)
                                       for g in self.shards]))


def kernel_counters() -> dict:
    """Every kernel's launch counter by its short name."""
    from deepfbsdejsolvers_torch.ops import noise
    from deepfbsdejsolvers_torch.ops import rollout as R
    from deepfbsdejsolvers_torch.ops import sweep as S

    return {"B1": R.b1_forward, "B2": R.b2_backward,
            "B3": S.b3_forward, "B4": S.b4_backward,
            "B3w": S.b3_wide_forward, "B4w": S.b4_wide_backward,
            "B1w": R.b1_wide_forward, "B2w": R.b2_wide_backward,
            "J": noise.icdf_jumps}


def dp_reset() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def dp_read() -> dict:
    return {k: fn.launches for k, fn in kernel_counters().items()}


def dp_digest(params) -> str:
    import hashlib

    from deepfbsdejsolvers_torch.nets.mlp import param_leaves

    h = hashlib.sha256()
    for t in param_leaves(params):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_fresh(params, dtype=None):
    """A copy of a params tree with trainable leaves (cast to ``dtype``
    when given)."""
    if isinstance(params, dict):
        return {k: dp_fresh(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [dp_fresh(v, dtype) for v in params]
    return params.detach().to(dtype).clone().requires_grad_(True)


def dp_errors(got, want) -> dict:
    """The global-norm relative distance of the gradient leaves ``got``
    from ``want``, the worst per-leaf one over the leaves that carry at
    least GRAD_REL_TOL of the gradient's norm (the others' distances are
    bounded by the global one; the Γ head's output bias has an exact
    gradient of 0, 1 − Σw over a normalised node set), and the largest
    absolute.  Leaves are numbered in ``param_leaves`` order."""
    num = math.sqrt(sum(float(torch.sum((a - b) ** 2))
                        for a, b in zip(got, want)))
    den = math.sqrt(sum(float(torch.sum(b ** 2)) for b in want))
    leaves = {i: float((a - b).norm()) / float(b.norm())
              for i, (a, b) in enumerate(zip(got, want))
              if float(b.norm()) >= GRAD_REL_TOL * den}
    worst = max(leaves, key=leaves.get)
    return {"rel": num / den, "leaf_rel": leaves[worst], "worst_leaf": worst,
            "per_leaf": leaves, "leaves_held": len(leaves),
            "leaves": len(want),
            "max_abs": max(float((a - b).abs().max())
                           for a, b in zip(got, want))}


def dp_value_and_grad(loss_fn, params, gen, mesh):
    """This rank's loss and gradients (``local``) and their mesh means."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.parallel.data_parallel import (
        all_reduce_grads)

    p = dp_fresh(params)
    loss = loss_fn(p, gen)
    loss.backward()
    leaves = param_leaves(p)
    local = [t.grad.clone() for t in leaves]
    mean = all_reduce_grads(leaves, loss, mesh)
    return {"loss": float(loss.detach()), "mesh_loss": float(mean),
            "local": local,
            "grads": [t.grad.clone() for t in leaves]}


def dp_train(update, gen, params) -> dict:
    """DP_STEPS updates: each one's mesh loss and the params' digest after
    it, and the host milliseconds of the timed ones (all but the first),
    each ending in a sync on the loss."""
    losses, digests, ms = [], [], []
    for k in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(update(gen)))
        if k:
            ms.append(1e3 * (time.perf_counter() - t0))
        digests.append(dp_digest(params))
    return {"losses": losses, "digests": digests,
            "step_ms": float(np.mean(ms))}


def dp_rank_a(rank: int) -> dict:
    """(a): the fused speed configuration in a world of one (NCCL), 2 × 2
    steps through ``fit(mesh=...)``, against ``fit`` without a mesh of the
    same shard's loss (``ShardMean(loss, 1)``): every loss, Y0 and param
    bit for bit."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.parallel import make_mesh
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import fit, make_generator

    mesh = make_mesh(device="cuda")
    model, kw = speed_config()
    solver = PricingSolver(model, "global", hidden=(HIDDEN, HIDDEN), **kw)
    loss, val = solver.build_loss(TRAIN_BATCH), solver.build_loss(TRAIN_BATCH)

    def run(m, lf, vf):
        params = solver.init_params(make_generator("cpu", SEED, 0))
        dp_reset()
        res = fit(lf, params, SEED, 4e-4, 2, 2, val_loss_fn=vf,
                  y0_fn=solver.y0_estimate, verbose=False, mesh=m)
        return res, dp_read()

    dp, launches = run(mesh, loss, val)
    one, _ = run(None, ShardMean(loss, 1), ShardMean(val, 1))
    same = (dp.loss_history == one.loss_history
            and dp.y0_history == one.y0_history
            and all(torch.equal(a, b) for a, b in
                    zip(param_leaves(dp.params), param_leaves(one.params))))
    return {"backend": mesh.backend, "launches": launches,
            "losses": dp.loss_history, "y0": dp.y0_history,
            "single_losses": one.loss_history, "bit_identical": same,
            "digest": dp_digest(dp.params)}


def dp_rank_b(rank: int) -> dict:
    """(b): the fused speed configuration on 2 data ranks (gloo), each on
    2^16 paths: the mesh loss and gradients against the mean of both
    shards' evaluated serially here, then DP_STEPS updates."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.parallel import (
        make_dp_update, make_mesh, per_shard_batch)
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        fold_in, make_adam, make_generator)

    mesh = make_mesh(device="cuda")
    d, n = mesh.coord("data"), mesh.shape["data"]
    model, kw = speed_config()
    solver = PricingSolver(model, "global", hidden=(HIDDEN, HIDDEN), **kw)
    batch = per_shard_batch(TRAIN_BATCH, mesh)
    loss_fn = solver.build_loss(batch)
    params = solver.init_params(make_generator("cpu", SEED, 0))
    g = make_generator("cuda", SEED, 11)
    dp_reset()
    got = dp_value_and_grad(loss_fn, params, fold_in(g, d), mesh)
    p = dp_fresh(params)
    serial = torch.mean(torch.stack([loss_fn(p, fold_in(g, i))
                                     for i in range(n)]))
    serial.backward()
    serial = float(serial.detach())
    check_launches = dp_read()
    want = [t.grad for t in param_leaves(p)]
    params = dp_fresh(params)
    update = make_dp_update(loss_fn, make_adam(params, 4e-4), params, mesh)
    dp_reset()
    train = dp_train(update, fold_in(make_generator("cuda", SEED, 12), d),
                     params)
    return {"backend": mesh.backend, "batch": batch,
            "mesh_loss": got["mesh_loss"], "serial_loss": serial,
            "loss_rel": abs(got["mesh_loss"] - serial) / abs(serial),
            "grads": dp_errors(got["grads"], want),
            "check_launches": check_launches, "launches": dp_read(),
            **train}


def dp_rank_c(rank: int) -> dict:
    """(c): the parity configuration on a 2 × 2 (data, comp) mesh (gloo),
    2^16 paths a data rank, the 49-node quadrature padded to 50 and swept
    25 nodes a rank through B3/B4: loss and gradients against the same
    world unsharded at the same noise, the sharded run twice (B4 bit for
    bit), then DP_STEPS updates.  Both runs' gradients are also measured
    against a float64 evaluation of the unsharded loss (the plain sweep)
    at the same noise (``f64``: per leaf, the sharded and the unsharded
    run's relative distances from it)."""
    import deepfbsdejsolvers_torch.solvers.pricing as P
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.parallel import (
        make_dp_update, make_mesh, per_shard_batch)
    from deepfbsdejsolvers_torch.solvers.train import (
        fold_in, make_adam, make_generator)

    mesh = make_mesh((2, 2), ("data", "comp"), device="cuda")
    d = mesh.coord("data")
    kw = dict(hidden=(HIDDEN, HIDDEN), sweep_impl="pallas", device="cuda")
    base = P.PricingSolver(make_merton_default(), "global", **kw)
    shard = P.PricingSolver(make_merton_default(), "global", comp_axis="comp",
                            comp_shards=2, **kw)
    batch = per_shard_batch(TRAIN_BATCH, mesh)
    params = base.init_params(make_generator("cpu", SEED, 0))
    # the node count of each sweep the kernels are handed
    swept = []
    sweep = P.fused_sweep
    P.fused_sweep = lambda x, a, *r: (swept.append(int(a.shape[0])),
                                      sweep(x, a, *r))[1]
    g = make_generator("cuda", SEED, 13)
    out = {"backend": mesh.backend, "batch": batch}
    try:
        dp_reset()
        first = dp_value_and_grad(shard.build_loss(batch, mesh), params,
                                  fold_in(g, d), mesh)
        again = dp_value_and_grad(shard.build_loss(batch, mesh), params,
                                  fold_in(g, d), mesh)
        out["check_launches"] = dp_read()
        out["nodes_sharded"] = sorted(set(swept))
        swept.clear()
        ref = dp_value_and_grad(base.build_loss(batch), params,
                                fold_in(g, d), mesh)
        out["nodes_unsharded"] = sorted(set(swept))
        # the same comparison in float64 through the plain sweep: the
        # sharding's own error, free of f32 rounding
        m64 = float64_model(make_merton_default())
        kw64 = dict(hidden=(HIDDEN, HIDDEN), device="cuda")
        noise = tuple(t.double() for t in base._prenoise(fold_in(g, d),
                                                         batch))
        exact = {who: dp_value_and_grad(
            s.build_loss_from_noise(batch, mesh),
            dp_fresh(params, torch.float64),
            noise, mesh)["grads"] for who, s in (
                ("unsharded", P.PricingSolver(m64, "global", **kw64)),
                ("sharded", P.PricingSolver(m64, "global", comp_axis="comp",
                                            comp_shards=2,
                                            **kw64)))}
        def dist(got, want):
            """Per leaf, as dp_errors holds them."""
            whole = math.sqrt(sum(float(b.norm()) ** 2 for b in want))
            return {i: float((a.double() - b).norm() / b.norm())
                    for i, (a, b) in enumerate(zip(got, want))
                    if float(b.norm()) >= GRAD_REL_TOL * whole}

        out["f64"] = {who: dist(run["grads"], exact["unsharded"])
                      for who, run in (("sharded", first), ("unsharded", ref))}
        out["f64_sharding"] = max(dist(exact["sharded"],
                                       exact["unsharded"]).values())
        out["heads"] = [name for name in sorted(params)
                        for _ in param_leaves(params[name])]

        out["rerun_identical"] = (first["loss"] == again["loss"] and all(
            torch.equal(a, b) for a, b in zip(first["local"],
                                              again["local"])))
        out["mesh_loss"], out["unsharded_loss"] = (first["mesh_loss"],
                                                   ref["mesh_loss"])
        out["loss_rel"] = (abs(first["mesh_loss"] - ref["mesh_loss"])
                           / abs(ref["mesh_loss"]))
        out["grads"] = dp_errors(first["grads"], ref["grads"])
        params = dp_fresh(params)
        update = make_dp_update(shard.build_loss(batch, mesh),
                                make_adam(params, 4e-4), params, mesh)
        dp_reset()
        out.update(dp_train(update, fold_in(make_generator("cuda", SEED, 14),
                                            d), params))
        out["launches"] = dp_read()
    finally:
        P.fused_sweep = sweep
    return out


def dp_single_step_ms(solver) -> float:
    """The host milliseconds of a training step of ``solver`` in this
    process at batch TRAIN_BATCH, timed as ``dp_train`` times the ranks'."""
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    params = solver.init_params(make_generator("cpu", SEED, 0))
    step = make_step(solver.build_loss(TRAIN_BATCH), make_adam(params, 4e-4),
                     params)
    return dp_train(step, make_generator("cuda", SEED, 15), params)["step_ms"]


def dp_phases(counters) -> dict:
    """Phase 9: data parallelism on this card.  The kernels are built (phase
    1); the ranks start by ``spawn`` and share the card, so the step times
    show the cost of the collectives and launches, not a scaling.  Fails
    unless: (a) is bit-identical to the run without a mesh and launches B1
    6 and B2 4 times; in (b) every rank's mesh loss is within LOSS_REL_TOL
    and its gradients within GRAD_REL_TOL (as a whole and per leaf) of the
    serial ones, the params bit-identical across ranks after every step,
    and B1/B2 launched once per shard loss and backward; in (c) B3/B4 sweep
    25 nodes a rank (49 unsharded), loss and gradients within the same
    tolerances of the unsharded run (per leaf but the Γ head's, as
    DP_F64_TOL's comment says) and, in float64 through the plain sweep,
    every leaf within DP_F64_TOL of the unsharded run, B4 bit-identical on
    rerun, B3 and B4 N_STEPS times per loss and backward; (d) the dry run at 4 ranks passes;
    (e) ``merton --dataParallel --methods Global`` under
    ``torch.distributed.run --nproc_per_node 1`` exits 0 and writes each
    record once."""
    from deepfbsdejsolvers_torch.experiments import dryrun_multichip
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.parallel.launch import run_ranks
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver

    zero = {k: 0 for k in counters}
    out, by_path = {}, {}
    t0 = time.perf_counter()

    def ranks(label, fn, k):
        print(f"dp ({label}): {k} rank(s) of {fn.__name__}:")
        t = time.perf_counter()
        try:
            res = run_ranks(fn, k, device="cuda", timeout=DP_TIMEOUT)
        except RuntimeError as e:
            fail(f"dp ({label}): {e}")
        print(f"dp ({label}): {time.perf_counter() - t:.1f} s")
        return res

    def want(label, got, **counts):
        exp = dict(zero, **counts)
        if got != exp:
            fail(f"dp ({label}): launches {got}, the code implies {exp}")

    (a,) = ranks("a", dp_rank_a, 1)
    print(f"dp (a): backend {a['backend']}, losses {a['losses']} (without "
          f"a mesh {a['single_losses']}), bit-identical "
          f"{a['bit_identical']}, launches {a['launches']}")
    if a["backend"] != "nccl" or not a["bit_identical"]:
        fail("dp (a): the NCCL world of one is not bit-identical to the "
             "run without a mesh")
    want("a", a["launches"], B1=2 * 2 + 2, B2=2 * 2, J=2 * 2 + 2)
    by_path["dp_a"] = a["launches"]
    out["a"] = {k: a[k] for k in ("backend", "losses", "y0", "launches")}

    b = ranks("b", dp_rank_b, 2)
    for r, res in enumerate(b):
        print(f"dp (b) rank {r}: backend {res['backend']}, {res['batch']} "
              f"paths, mesh loss {res['mesh_loss']:.7g} (serial "
              f"{res['serial_loss']:.7g}, rel {res['loss_rel']:.2e}), grads "
              f"rel {res['grads']['rel']:.2e} (worst leaf "
              f"{res['grads']['leaf_rel']:.2e}, leaf {res['grads']['worst_leaf']} of "
              f"{res['grads']['leaves_held']} held), step "
              f"{res['step_ms']:.2f} ms, launches {res['launches']}")
        if res["loss_rel"] > LOSS_REL_TOL:
            fail(f"dp (b) rank {r}: mesh loss off the serial mean")
        if max(res["grads"]["rel"], res["grads"]["leaf_rel"]) > GRAD_REL_TOL:
            fail(f"dp (b) rank {r}: gradients off the serial ones")
        want(f"b, rank {r}, checks", res["check_launches"], B1=1 + 2,
             B2=1 + 2, J=1 + 2)
        want(f"b, rank {r}", res["launches"], B1=DP_STEPS, B2=DP_STEPS,
             J=DP_STEPS)
    if b[0]["digests"] != b[1]["digests"] or b[0]["losses"] != b[1]["losses"]:
        fail("dp (b): the ranks' params or losses differ after a step")
    by_path["dp_b"] = {k: sum(r["launches"][k] for r in b) for k in zero}

    c = ranks("c", dp_rank_c, 4)
    for r, res in enumerate(c):
        print(f"dp (c) rank {r}: backend {res['backend']}, {res['batch']} "
              f"paths a data rank, nodes a sweep {res['nodes_sharded']} "
              f"(unsharded {res['nodes_unsharded']}), mesh loss "
              f"{res['mesh_loss']:.7g} (unsharded "
              f"{res['unsharded_loss']:.7g}, rel {res['loss_rel']:.2e}), "
              f"grads rel {res['grads']['rel']:.2e} (worst leaf "
              f"{res['grads']['leaf_rel']:.2e}, leaf {res['grads']['worst_leaf']} of "
              f"{res['grads']['leaves_held']} held), B4 rerun identical "
              f"{res['rerun_identical']}, step {res['step_ms']:.2f} ms, "
              f"launches {res['launches']}")
        if res["nodes_sharded"] != [25] or res["nodes_unsharded"] != [N_QUAD]:
            fail(f"dp (c) rank {r}: the kernels swept "
                 f"{res['nodes_sharded']} nodes, not 25")
        if res["loss_rel"] > LOSS_REL_TOL:
            fail(f"dp (c) rank {r}: loss off the unsharded run")
        # per leaf within GRAD_REL_TOL of the unsharded run, but the Γ
        # head's, which DP_F64_TOL holds (its comment)
        f64, heads = res["f64"], res["heads"]
        off = {i: e for i, e in res["grads"]["per_leaf"].items()
               if heads[i] != "gam" and e > GRAD_REL_TOL}
        if r == 0:
            print(f"dp (c): per leaf (head), distance from the "
                  "unsharded run; the sharded and the unsharded run's from "
                  "float64: " + ", ".join(
                      f"{i} ({heads[i]}): {e:.2e}; {f64['sharded'][i]:.2e}, "
                      f"{f64['unsharded'][i]:.2e}"
                      for i, e in res["grads"]["per_leaf"].items())
                  + f"; in float64 sharded against unsharded "
                  f"{res['f64_sharding']:.2e}")
        if res["grads"]["rel"] > GRAD_REL_TOL or off:
            fail(f"dp (c) rank {r}: gradients off the unsharded run "
                 f"(global {res['grads']['rel']:.2e}; leaves {off})")
        if res["f64_sharding"] > DP_F64_TOL:
            fail(f"dp (c) rank {r}: in float64 the sharded gradients are "
                 f"{res['f64_sharding']:.2e} from the unsharded ones")
        if not res["rerun_identical"]:
            fail(f"dp (c) rank {r}: B4 not bit-identical on rerun")
        want(f"c, rank {r}, checks", res["check_launches"],
             B3=2 * N_STEPS, B4=2 * N_STEPS)
        want(f"c, rank {r}", res["launches"], B3=DP_STEPS * N_STEPS,
             B4=DP_STEPS * N_STEPS)
    if len({tuple(r["digests"]) for r in c}) != 1:
        fail("dp (c): the ranks' params differ after a step")
    by_path["dp_c"] = {k: sum(r["launches"][k] for r in c) for k in zero}
    model, kw = speed_config()
    single_ms = {
        "speed": dp_single_step_ms(PricingSolver(
            model, "global", hidden=(HIDDEN, HIDDEN), **kw)),
        "parity": dp_single_step_ms(PricingSolver(
            make_merton_default(), "global", hidden=(HIDDEN, HIDDEN),
            sweep_impl="pallas", device="cuda"))}
    for label, res, key in (("b", b, "speed"), ("c", c, "parity")):
        ms = [r["step_ms"] for r in res]
        out[label] = {"ranks": len(res), "batch_per_rank": res[0]["batch"],
                      "step_ms_by_rank": ms, "single_step_ms": single_ms[key],
                      "loss_rel": max(r["loss_rel"] for r in res),
                      "grad_rel": max(r["grads"]["rel"] for r in res),
                      "grad_leaf_rel": max(r["grads"]["leaf_rel"]
                                           for r in res),
                      "launches_by_rank": [r["launches"] for r in res]}
        print(f"dp ({label}) on one shared card: step {max(ms):.2f} ms at "
              f"global batch {TRAIN_BATCH} over {len(res)} ranks, against "
              f"{single_ms[key]:.2f} ms in one process")

    # (e) runs beside (d): neither is timed, and the card holds both
    print("dp (d) and (e): the dry run at 4 ranks, beside merton "
          "--dataParallel under torch.distributed.run:")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cli = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "deepfbsdejsolvers_torch",
             "merton", "--dataParallel", "--methods", "Global",
             "--nEpochExt", str(CLI_EPOCHS), "--nEpoch", str(CLI_STEPS),
             "--outdir", tmp, "--quiet"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            dry = dryrun_multichip.run(4, "cuda", timeout=DP_TIMEOUT)
            print(f"dp (d): {time.perf_counter() - t:.1f} s")
            stdout, stderr = cli.communicate(timeout=DP_TIMEOUT)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            fail(f"dp (d) or (e): {e}")
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.communicate()
        print(stdout[-2000:])
        if cli.returncode != 0:
            fail(f"dp (e): exit {cli.returncode}:\n{stderr[-4000:]}")
        with open(os.path.join(tmp, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
    for r, passes in enumerate(dry["launches"]):
        want(f"d, rank {r}, merton", dict(zero, **passes["merton"]),
             B3=N_STEPS, B4=N_STEPS)
        want(f"d, rank {r}, speed_fused", dict(zero, **passes["speed_fused"]),
             B1=1, B2=1, J=1)
        want(f"d, rank {r}, speed", dict(zero, **passes["speed"]), J=1)
        for name in ("vg_speed", "mfg"):
            want(f"d, rank {r}, {name}", dict(zero, **passes[name]))
    by_path["dp_dryrun"] = {k: sum(p.get(k, 0) for r in dry["launches"]
                                   for p in r.values()) for k in zero}
    out["d"] = {name: res["loss"] for name, res in dry["passes"].items()}
    events = [r.get("event") for r in records]
    epochs = sorted(r["epoch"] for r in records if "epoch" in r)
    print(f"dp (e): {time.perf_counter() - t:.1f} s, exit 0, events "
          f"{events}, epochs {epochs}")
    if ("backend nccl" not in stdout or events.count("start") != 1
            or events.count("method_done") != 1
            or epochs != list(range(CLI_EPOCHS))):
        fail("dp (e): the records are not written once each, or the rank "
             "did not join NCCL")
    out["e"] = {"events": events, "epochs": epochs}
    out["seconds"] = time.perf_counter() - t0
    print(f"dp phases: {out['seconds']:.1f} s")
    return out, by_path


def loss_and_grads(loss, params):
    """(loss, gradients of the params' leaves) of one evaluation."""
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves

    leaves = param_leaves(params)
    value = loss(params)
    return value.detach(), torch.autograd.grad(value, leaves)


def peak_mib(fn):
    """(fn()'s result, the card's peak allocated MiB while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**20


def rel_errors(a, b) -> tuple:
    """(loss relative error, gradient global-norm relative error) of the
    (loss, gradients) pair ``a`` against ``b``."""
    num = math.sqrt(sum(float(torch.sum((x.double() - y.double()) ** 2))
                        for x, y in zip(a[1], b[1])))
    den = math.sqrt(sum(float(torch.sum(y.double() ** 2)) for y in b[1]))
    return abs(float(a[0]) - float(b[0])) / abs(float(b[0])), num / den


def bitwise(a, b) -> bool:
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def fresh_params(solver):
    from deepfbsdejsolvers_torch.nets.mlp import param_leaves
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    params = solver.init_params(make_generator("cpu", SEED, 0))
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def step_ms_of(solver, params, tag: int, reps: int = 3,
               mfg: bool = False) -> float:
    """Device time of one Adam step of ``solver`` at batch 2^17."""
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    loss = (solver.build_losses(TRAIN_BATCH)["coupled"] if mfg
            else solver.build_loss(TRAIN_BATCH))
    step = make_step(loss, make_adam(params, 4e-4), params)
    gen = make_generator("cuda", SEED, tag)
    return cuda_ms(lambda: step(gen), reps=reps, warmup=1)


def item13_phases(counters) -> tuple:
    """Phase 10, the opt-in instruments (module docstring); returns (their
    figures, the TF32 rows' checks, times and launches)."""
    import contextlib
    import io

    from deepfbsdejsolvers_torch.experiments import bench as B
    from deepfbsdejsolvers_torch.experiments import cli
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.models.mfg_smart_grid import (
        make_mfg_default)
    from deepfbsdejsolvers_torch.ops import rollout as R
    from deepfbsdejsolvers_torch.solvers.mfg import MFG_SCHEMES, MFGSolver
    from deepfbsdejsolvers_torch.solvers.pricing import PricingSolver
    from deepfbsdejsolvers_torch.solvers.train import (
        make_adam, make_generator, make_step)

    t_start = time.perf_counter()
    out = {"laps": {}}
    model, kw = speed_config()
    unfused = dict(kw, fused_rollout=False)
    hid = (HIDDEN, HIDDEN)
    last = [t_start]

    def lap(label):
        now = time.perf_counter()
        out["laps"][label] = now - last[0]
        last[0] = now

    def at_noise(solver, tag):
        noise = solver._prenoise(make_generator("cuda", SEED, tag),
                                 TRAIN_BATCH, solver.noise_rows)
        loss = solver.build_loss_from_noise(TRAIN_BATCH)
        return lambda p: loss(p, noise)

    # (a) the hand-written adjoint against autograd, one noise draw
    auto = PricingSolver(model, "global", hidden=hid, **unfused)
    adj = dataclasses.replace(auto, adjoint=True)
    params = fresh_params(auto)
    ra, peak_a = peak_mib(lambda: loss_and_grads(at_noise(auto, 90), params))
    rj, peak_j = peak_mib(lambda: loss_and_grads(at_noise(adj, 90), params))
    loss_rel, grad_rel = rel_errors(rj, ra)
    ms = {k: step_ms_of(s, fresh_params(s), 91) for k, s in
          (("autograd", auto), ("adjoint", adj))}
    print(f"adjoint vs autograd (speed path, batch {TRAIN_BATCH}): loss rel "
          f"{loss_rel:.3e} (tol {ADJOINT_LOSS_REL}), grads rel "
          f"{grad_rel:.3e} (tol {ADJOINT_GRAD_REL}); step {ms['adjoint']:.3f}"
          f" ms, peak {peak_j:.1f} MiB (autograd's {ms['autograd']:.3f} ms, "
          f"{peak_a:.1f} MiB)")
    if not (loss_rel <= ADJOINT_LOSS_REL and grad_rel <= ADJOINT_GRAD_REL):
        fail("the hand-written adjoint disagrees with autograd")
    out["adjoint"] = {"loss_rel": loss_rel, "grad_rel": grad_rel,
                      "step_ms": ms, "peak_mib": {"autograd": peak_a,
                                                  "adjoint": peak_j}}

    lap("adjoint")

    # (b) the chunked time loop: bit for bit, and its peak memory
    mfg_model = dataclasses.replace(make_mfg_default(), jump_sampler="icdf")
    chunk_paths = (
        ("speed", PricingSolver(model, "global", hidden=hid, **unfused)),
        ("parity", PricingSolver(make_merton_default(), "global", hidden=hid,
                                 sweep_impl="pallas", device="cuda")),
        ("mfg_global", MFGSolver(mfg_model, "global", device="cuda")))
    out["scan_chunk"] = {}
    for label, base in chunk_paths:
        mfg = isinstance(base, MFGSolver)
        rows, ref = {}, None
        params = fresh_params(base)
        for chunk in ITEM13_CHUNKS:
            solver = dataclasses.replace(base, scan_chunk=chunk)
            if mfg:
                pair = solver.build_losses(TRAIN_BATCH)["coupled"]
                loss = lambda p: pair(p, make_generator("cuda", SEED, 92))
            else:
                loss = at_noise(solver, 92)
            for fn in counters.values():
                fn.launches = 0
            res, peak = peak_mib(lambda: loss_and_grads(loss, params))
            ref = res if ref is None else ref
            same = bitwise(res, ref)
            launched = {k: fn.launches for k, fn in counters.items()
                        if fn.launches}
            ms = step_ms_of(solver, fresh_params(solver), 92, reps=2,
                            mfg=mfg)
            rows[chunk] = {"bit_identical": same, "peak_mib": peak,
                           "step_ms": ms, "launches": launched}
            print(f"scan_chunk {chunk} on {label}: loss {float(res[0])!r}, "
                  f"bit-identical to the plain loop: {same}, peak "
                  f"{peak:.1f} MiB, step {ms:.3f} ms, launches {launched}")
            if not same:
                fail(f"scan_chunk {chunk} on {label} left the plain loop")
        out["scan_chunk"][label] = rows
        del params, ref, res

    lap("scan_chunk")

    # (c) the table and head variants: one speed step each
    base = PricingSolver(model, "global", hidden=hid, **unfused)
    params = fresh_params(base)
    ref = loss_and_grads(at_noise(base, 93), params)
    variants = {
        "hoist_gamma": dataclasses.replace(base, hoist_gamma=True),
        "hoist_z=False": dataclasses.replace(base, hoist_z=False),
        "price_mode=table": dataclasses.replace(
            base, model=dataclasses.replace(model, price_mode="table")),
        "bfloat16": dataclasses.replace(base, compute_dtype="bfloat16")}
    out["variants"] = {}
    for label, solver in variants.items():
        res = loss_and_grads(at_noise(solver, 93), params)
        loss_rel, grad_rel = rel_errors(res, ref)
        finite = math.isfinite(float(res[0])) and all(
            bool(torch.isfinite(g).all()) for g in res[1])
        ms = step_ms_of(solver, fresh_params(solver), 94)
        print(f"{label}: loss {float(res[0]):.6e} against the f32 "
              f"default's {float(ref[0]):.6e}, rel {loss_rel:.3e} (tol "
              f"{ITEM13_LOSS_REL[label]}), grads rel {grad_rel:.3e}, "
              f"finite {finite}; step {ms:.3f} ms")
        if not (finite and loss_rel <= ITEM13_LOSS_REL[label]):
            fail(f"{label}: the speed step's loss left the f32 default's")
        out["variants"][label] = {"loss_rel": loss_rel,
                                  "grad_rel": grad_rel, "step_ms": ms}

    lap("variants")

    # (d) fuse_heads against the split heads, each MFG scheme
    out["fuse_heads"] = {}
    for scheme in MFG_SCHEMES:
        row = {}
        pair = {}
        for fuse in (False, True):
            solver = MFGSolver(mfg_model, scheme, fuse_heads=fuse,
                               device="cuda")
            params = fresh_params(solver)
            loss = solver.build_losses(TRAIN_BATCH)["coupled"]
            pair[fuse], peak = peak_mib(lambda: loss_and_grads(
                lambda p: loss(p, make_generator("cuda", SEED, 95)), params))
            step = make_step(loss, make_adam(params, 1e-3), params)
            gen = make_generator("cuda", SEED, 96)
            ms = cuda_ms(lambda: step(gen), reps=2, warmup=1)
            # the ops of one scheme (the fused heads save the same ~3.0k
            # a step in each; the profiler takes ~10 s a step here)
            prof = (profile_steps(step, gen, ms, steps=1)
                    if scheme == MFG_SCHEMES[0] else None)
            row["fused" if fuse else "split"] = {
                "step_ms": ms, "peak_mib": peak,
                "device_ops": None if prof is None else prof[1]}
        loss_rel, grad_rel = rel_errors(pair[True], pair[False])
        row.update(loss_rel=loss_rel, grad_rel=grad_rel)
        ops = {k: "" if r["device_ops"] is None
               else f"{r['device_ops']:.0f} ops, "
               for k, r in row.items() if k in ("fused", "split")}
        print(f"fuse_heads on MFG {scheme}: loss rel {loss_rel:.3e} (tol "
              f"{FUSE_LOSS_REL}), grads rel {grad_rel:.3e} (tol "
              f"{FUSE_GRAD_REL}); step {row['fused']['step_ms']:.3f} ms, "
              f"{ops['fused']}peak {row['fused']['peak_mib']:.1f} MiB "
              f"(split {row['split']['step_ms']:.3f} ms, {ops['split']}"
              f"{row['split']['peak_mib']:.1f} MiB)")
        if not (loss_rel <= FUSE_LOSS_REL and grad_rel <= FUSE_GRAD_REL):
            fail(f"fuse_heads on MFG {scheme} left the split heads")
        out["fuse_heads"][scheme] = row

    lap("fuse_heads")

    # (e) the head-TF32 instances: checks, the fused speed path trained on
    # them, and their times beside the FP32 instances'
    tf32 = {"check": {}, "times": {}, "launches": {}}
    for h, n, batch in TF32_CHECKS:
        if batch == "walk":
            batch = 5 * R.b2_wide_blocks(2**30, h, True) // 2 * R.wide_tile(
                h) - 91
        print(f"head TF32 check at H={h}, N={n}, B={batch}:")
        m, inputs = rollout_case(model, kw, h, n, batch)
        result = check_kernels(
            R.FusedRolloutOp(m, h, n_pieces=PIECES,
                             head_precision="default"), m, inputs)
        if n == N_STEPS:
            tf32["check"][h] = result
        del inputs
    for h in TF32_TRAINED:
        solver = PricingSolver(model, "global", hidden=(h, h),
                               fused_head_precision="default", **kw)
        params = fresh_params(solver)
        step = make_step(solver.build_loss(TRAIN_BATCH),
                         make_adam(params, 4e-4), params)
        gen = make_generator("cuda", SEED, 97)
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, "launches_tf32"):
                fn.launches_tf32 = 0
        losses = [float(step(gen)) for _ in range(2)]
        launched = {k: fn.launches_tf32 for k, fn in counters.items()
                    if getattr(fn, "launches_tf32", 0)}
        print(f"fused speed path at hidden ({h}, {h}), head TF32, 2 steps: "
              f"losses {losses}, TF32 launches {launched}")
        want = {"B1": 2, "B2": 2} if h == HIDDEN else {"B1w": 2, "B2w": 2}
        if launched != want or not all(map(math.isfinite, losses)):
            fail(f"the head-TF32 speed path launched {launched}, the code "
                 f"implies {want}")
        tf32["launches"][h] = launched
    for h in TF32_TIMED:
        m, inputs = rollout_case(model, kw, h, N_STEPS, TRAIN_BATCH)
        ops = {mode: R.FusedRolloutOp(m, h, n_pieces=PIECES,
                                      head_precision=mode)
               for mode in ("highest", "default")}
        calls = {mode: kernel_calls(op, inputs) for mode, op in ops.items()}
        turns = {mode: {"B1": [], "B2": []} for mode in ops}
        for mode in ("highest", "default", "default", "highest"):
            fwd, bwd = calls[mode]
            turns[mode]["B1"].append(kernel_ms(fwd, reps=20))
            turns[mode]["B2"].append(kernel_ms(bwd, reps=20))
        plain = time_kernels(ops["default"], inputs, plain_reps=3)
        tf32["times"][h] = {
            k: {"highest_ms": turns["highest"][k],
                "ms": turns["default"][k],
                "plain_ms": plain[k]["plain_ms"],
                "bound_ms": tc_floor(k, N_STEPS, TRAIN_BATCH, h)[0],
                "bound_by": tc_floor(k, N_STEPS, TRAIN_BATCH, h)[1],
                "fp32_bound_ms": bound(k, N_STEPS, TRAIN_BATCH, h,
                                       PIECES)[0]}
            for k in ("B1", "B2")}
        for k, row in tf32["times"][h].items():
            print(f"{k} at H={h}: head TF32 {row['ms'][0]:.4f} / "
                  f"{row['ms'][1]:.4f} ms, FP32 {row['highest_ms'][0]:.4f} /"
                  f" {row['highest_ms'][1]:.4f} ms in turns; plain (TF32) "
                  f"{row['plain_ms']:.3f} ms; bound with the products at "
                  f"the TF32 rate {row['bound_ms']:.4f} ms, FP32 bound "
                  f"{row['fp32_bound_ms']:.4f} ms")
        del inputs, calls

    lap("head_tf32")

    # (f) the bench's opt-in flags, launches exact
    out["bench"] = {}
    for label, entry, argv, want in ITEM13_BENCH:
        for fn in counters.values():
            fn.launches = 0
        cut = [*argv, "--inner", "2", "--rounds", "1"]
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = (B.main(cut) if entry == "module"
                  else cli.main(["bench", *cut]))
        launched = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        lines = buf.getvalue().strip().splitlines()
        detail = [ln for ln in err.getvalue().splitlines()
                  if ln.startswith("# detail:")]
        print(f"bench {label}: `{' '.join(cut)}` exit {rc}, launches "
              f"{launched}; {lines[-1] if lines else '(no output)'}")
        if detail:
            print(detail[-1][:300])
        if rc != 0 or not lines or launched != want:
            fail(f"bench {label}: exit {rc}, launches {launched}, the code "
                 f"implies {want}")
        rec = json.loads(lines[-1])
        if not (math.isfinite(rec["value"]) and rec["value"] > 0):
            fail(f"bench {label} printed {rec}")
        out["bench"][label] = {"json": rec, "launches": launched}
    lap("bench")
    out["seconds"] = time.perf_counter() - t_start
    print(f"opt-in instrument phases: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["laps"].items())
          + ")")
    return out, tf32


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepfbsdejsolvers_torch.experiments import (
        convergence_gates as gates)
    from deepfbsdejsolvers_torch.models.merton import make_merton_default
    from deepfbsdejsolvers_torch.models.variance_gamma import make_vg_default
    from deepfbsdejsolvers_torch.ops import _build
    from deepfbsdejsolvers_torch.ops import rollout as R
    from deepfbsdejsolvers_torch.ops.compensator import CompensatorSpec
    from deepfbsdejsolvers_torch.ops import sweep as S
    from deepfbsdejsolvers_torch.solvers.train import make_generator

    # 1. build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    ptxas = {}
    for name in _build.KERNEL_SOURCES:
        log = _build.ptxas_log(_build.library_path(name))
        if log.is_file():
            for fn, line in ptxas_lines(log.read_text()):
                print(f"  {name} {fn}: {line}")
                ptxas.setdefault(f"{name} {fn}", []).append(line)
    occupancy_by = {}
    for name, entry, widths, pieces in (
            ("rollout_fwd", None, (HIDDEN, 8), ()),
            ("rollout_fwd", "rollout_fwd_tf32", (HIDDEN, 8), ()),
            ("rollout_bwd", None, (HIDDEN, 8), (PIECES,)),
            ("rollout_bwd", "rollout_bwd_tf32", (HIDDEN, 8), (PIECES,)),
            ("rollout_wide_fwd", None, (32, 64, 128), ()),
            ("rollout_wide_fwd", "rollout_wide_fwd_tf32", (32, 64, 128), ()),
            ("rollout_wide_bwd", None, (32, 64, 128), ()),
            ("rollout_wide_bwd", "rollout_wide_bwd_tf32", (32, 64, 128), ()),
            ("sweep_fwd", None, (HIDDEN, 8), ()),
            ("sweep_bwd", None, (HIDDEN, 8), ()),
            ("sweep_wide_fwd", None, (32, 64, 128), ()),
            ("sweep_wide_bwd", None, (32, 64, 128), ())):
        for hidden in widths:
            smem, blocks = occupancy(name, hidden, *pieces, entry=entry)
            occupancy_by[f"{entry or name}<{hidden}>"] = {
                "smem": smem, "blocks_per_sm": blocks}
            print(f"  {entry or name}<{hidden}>: {smem} bytes of shared "
                  f"memory per block, {blocks} blocks per SM")

    # 2. kernel vs plain on ragged batches: full width, then the other
    # width the kernels are built for at a small size, then both where B2's
    # blocks walk two and three tiles
    model, kw = speed_config()
    vg_check = {}
    walk_batch = (5 * R.b2_blocks(2**30) // 2) * 128 - 91
    for hidden, n, batch in ((HIDDEN, N_STEPS, CHECK_BATCH), (8, 7, 1000),
                             (HIDDEN, N_STEPS, walk_batch),
                             (8, 7, walk_batch)):
        tiles = -(-batch // 128)
        print(f"check at H={hidden}, N={n}, B={batch} (B2: "
              f"{R.b2_blocks(batch)} blocks walk {tiles} tiles):")
        m, inputs = rollout_case(model, kw, hidden, n, batch)
        result = check_kernels(R.FusedRolloutOp(m, hidden, n_pieces=PIECES),
                               m, inputs)
        del inputs
        if batch == CHECK_BATCH:
            check = result
    for tag, (hidden, node_set, n_mc, batch) in enumerate((
            (HIDDEN, "quadrature", 0, CHECK_BATCH),
            (HIDDEN, "mc", N_MC, 2**12 + 37), (8, "quadrature", 0, 1000),
            (HIDDEN, "mc", 17, 37), (HIDDEN, "mc", 1, 1025),
            (HIDDEN, "quadrature", 0, 1025), (8, "mc", 17, 37),
            (HIDDEN, "quadrature", 0, 2**17 + 37),
            (HIDDEN, "mc", 17, 2**18 + 37), (8, "mc", 17, 2**18 + 37))):
        nodes = f"{n_mc} MC" if node_set == "mc" else "quadrature"
        print(f"sweep check at H={hidden}, {nodes} nodes, B={batch} (B4: "
              f"{S.b4_blocks(batch)} blocks walk {-(-batch // 256)} tiles):")
        result = check_sweep(*sweep_inputs(hidden, node_set, batch, tag,
                                           n_mc))
        if tag == 0:
            check.update(result)
    print(f"sweep check at H={HIDDEN}, quadrature nodes on the feature "
          f"e^J, B={CHECK_BATCH}:")
    check_sweep(*sweep_inputs(HIDDEN, "quadrature", CHECK_BATCH, 11,
                              form="exp"))
    # the pure-jump regime's forms: a per-node a (the Γ net on X·J) and the
    # one-output U-net on (t, X·(1 + J)), on the Variance-Gamma node sets
    for tag, (hidden, node_set, form, batch) in enumerate(VG_SWEEP_CHECKS,
                                                          start=30):
        nodes = f"{N_MC} MC" if node_set == "mc" else f"{N_VG_QUAD}-node"
        print(f"sweep check at H={hidden}, VG {nodes} nodes, form {form}, "
              f"B={batch} (B4: {S.b4_blocks(batch)} blocks walk "
              f"{-(-batch // 256)} tiles):")
        result = check_sweep(*sweep_inputs(hidden, node_set, batch, tag,
                                           form=form))
        vg_check.setdefault(form, result)
    # the wide kernels at every width class, on the same node sets and
    # edges; results by (H, case)
    wide_check = {}
    for h in WIDE_WIDTHS:
        for tag, case in enumerate(WIDE_SWEEP_CHECKS, start=100 + 10 * h):
            node_set, n_mc, form, batch = case
            nodes = f"{n_mc} MC" if node_set == "mc" else (
                f"{N_VG_QUAD}-node VG" if form != "j" else "quadrature")
            print(f"wide sweep check at H={h}, {nodes} nodes, form {form}, "
                  f"B={batch} (B4: {S.b4_wide_blocks(batch, h)} blocks walk "
                  f"{-(-batch // S.b4_wide_tile())} tiles):")
            args, g = sweep_inputs(h, node_set, batch, tag, n_mc or N_MC,
                                   form=form)
            wide_check[(h, case)] = check_sweep(args, g)
            if (h, case) == F64_CHECK:
                f64 = f64_distances(args, g)
            del args, g
    # the wide rollout at the same widths, results by (H, (N, B))
    wide_roll_check = {}
    for h in WIDE_WIDTHS:
        for case in WIDE_ROLLOUT_CHECKS:
            n, batch = case
            if batch == "walk":
                batch = 5 * R.b2_wide_blocks(2**30, h) // 2 * R.wide_tile(
                    h) - 91
            print(f"wide rollout check at H={h}, N={n}, B={batch} (B2w: "
                  f"{R.b2_wide_blocks(batch, h)} blocks walk "
                  f"{-(-batch // R.wide_tile(h))} tiles):")
            m, inputs = rollout_case(model, kw, h, n, batch)
            wide_roll_check[(h, case)] = check_kernels(
                R.FusedRolloutOp(m, h, n_pieces=PIECES), m, inputs)
            del inputs
    h, n, batch = ROLLOUT_F64_CHECK
    print(f"wide rollout at H={h}, N={n}, B={batch} against float64:")
    m, inputs = rollout_case(model, kw, h, n, batch)
    rollout_f64 = rollout_f64_distances(
        R.FusedRolloutOp(m, h, n_pieces=PIECES), m, inputs)
    del inputs
    op = R.FusedRolloutOp(model, HIDDEN, n_pieces=PIECES)

    # 3. the main paths: training through the facade
    counters = kernel_counters()
    print("speed path (hoisted tables, fused rollout):")
    trainer, launches = train_path(dict(kw, math_model=model),
                                   {"B1": 1, "B2": 1, "J": 1},
                                   {"B1": 1, "J": 1}, counters)
    # the same at the wide widths: B1w/B2w, the specialised pair never
    wide_trainers, wide_launches = {}, {}
    for h in WIDE_TRAIN_WIDTHS:
        print(f"speed path at hidden ({h}, {h}) (fused rollout, B1w/B2w), "
              f"2 × 2 steps:")
        wide_trainers[h], wide_launches[h] = train_path(
            dict(kw, math_model=model), {"B1w": 1, "B2w": 1, "J": 1},
            {"B1w": 1, "J": 1}, counters, steps=2, epochs=2, hidden=h)
    print("parity path (direct 49-node sweep, sweep_impl='pallas'):")
    parity, launches_p = train_path(
        dict(math_model=make_merton_default(), sweep_impl="pallas",
             device="cuda"),
        {"B3": N_STEPS, "B4": N_STEPS}, {"B3": N_STEPS}, counters)
    by_path = {"speed": dict(launches), "parity": launches_p,
               **{f"speed_{h}": n for h, n in wide_launches.items()}}
    launches.update({k: launches_p[k] for k in ("B3", "B4")})
    schemes = {}
    for scheme, (facade, impl, b3, b4, b3_eval) in SCHEMES.items():
        print(f"{scheme} (parity configuration, sweep_impl={impl!r}):")
        schemes[scheme], by_path[scheme] = train_path(
            dict(math_model=make_merton_default(),
                 compensator=CompensatorSpec(), sweep_impl=impl,
                 device="cuda"),
            {"B3": b3, "B4": b4}, {"B3": b3_eval}, counters, facade=facade,
            steps=SCHEME_STEPS, epochs=SCHEME_EPOCHS)
    # the pure-jump regime: the Variance-Gamma model's parity path (exact
    # gamma jumps, the per-path FFT price, the direct 96-node sweep through
    # B3/B4 on X·J), its speed path (no kernel) and the six other schemes
    vg_model = make_vg_default()
    print("VG parity path (direct 96-node sweep, sweep_impl='pallas'):")
    vg_parity, by_path["vg_parity"] = train_path(
        dict(math_model=vg_model, sweep_impl="pallas", device="cuda"),
        {"B3": N_VG, "B4": N_VG}, {"B3": N_VG}, counters)
    vg_speed_model, vg_speed_kw = vg_speed_config()
    print("VG speed path (hoisted piecewise tables, no kernel):")
    vg_speed, by_path["vg_speed"] = train_path(
        dict(vg_speed_kw, math_model=vg_speed_model), {}, {}, counters)
    vg_schemes = {}
    for scheme, (facade, impl, b3, b4, b3_eval) in VG_SCHEMES.items():
        print(f"VG {scheme} (parity configuration, sweep_impl={impl!r}):")
        vg_schemes[scheme], by_path[f"vg_{scheme}"] = train_path(
            dict(math_model=vg_model, sweep_impl=impl, device="cuda"),
            {"B3": b3, "B4": b4}, {"B3": b3_eval}, counters, facade=facade,
            steps=SCHEME_STEPS, epochs=SCHEME_EPOCHS)

    # the parity path at the CLI's wide widths: B3w/B4w, the specialised
    # pair never
    wide_parity = {}
    for label, which, h, n in WIDE_PARITY:
        print(f"{label}: {which} parity path at hidden ({h}, {h}) "
              "(sweep_impl='pallas', B3w/B4w), 2 × 2 steps:")
        wide_parity[label], by_path[label] = train_path(
            dict(math_model=make_merton_default() if which == "merton"
                 else vg_model, sweep_impl="pallas", device="cuda"),
            {"B3w": n, "B4w": n}, {"B3w": n}, counters, steps=2, epochs=2,
            hidden=h)

    # 4. timings at the paths' shapes
    icdf = icdf_phase()
    step_ms, rate = time_step(trainer, 4, "speed")
    times = time_kernels(op, rollout_inputs(
        trainer.core, trainer.params, TRAIN_BATCH,
        make_generator("cuda", SEED, 5)))
    pstep_ms, prate = time_step(parity, 8, "parity")
    times_mc = {}
    for node_set, into in (("quadrature", times), ("mc", times_mc)):
        args, g = sweep_inputs(HIDDEN, node_set, TRAIN_BATCH, 10)
        # the solver's automatic node block at this batch, 2^24 / B nodes
        block = None if node_set == "quadrature" else 2**24 // TRAIN_BATCH
        into.update(time_sweep(args, g, node_block=block))
        del args, g
    scheme_ms = {scheme: time_step(trainer, 20 + k, scheme, reps=3)[0]
                 for k, (scheme, trainer) in enumerate(schemes.items())}
    vg_speed_kernels = []
    vg_ms = {"parity": time_step(vg_parity, 40, "VG parity")[0],
             "speed": time_step(vg_speed, 41, "VG speed",
                                names=vg_speed_kernels)[0]}
    # the piece select's backward is one_hot(k)ᵀ·ḡ (ops/piecewise.py):
    # PyTorch's gather backward, which accumulates with atomics, must not
    # run on the VG speed path (the plain rollout over piecewise tables)
    gathers = [k for k in vg_speed_kernels if "indexing_backward" in k]
    print(f"VG speed profile: {len(vg_speed_kernels)} device kernels, "
          f"indexing_backward_kernel "
          f"{'present: ' + gathers[0][:80] if gathers else 'absent'}")
    if gathers:
        fail("the piece select's backward ran PyTorch's gather backward")
    vg_ms.update({scheme: time_step(trainer, 42 + k, f"VG {scheme}",
                                    reps=3)[0]
                  for k, (scheme, trainer) in enumerate(vg_schemes.items())})
    times_vg = {}
    for form in ("x_prop", "two_feature"):
        args, g = sweep_inputs(HIDDEN, "quadrature", TRAIN_BATCH, 12,
                               form=form)
        times_vg[form] = time_sweep(args, g)
        del args, g
    # the wide kernels at the CLI's batch, on the Merton and VG node sets
    times_wide = {}
    for h in WIDE_WIDTHS:
        for m, form in ((N_QUAD, "j"), (N_VG_QUAD, "x_prop")):
            args, g = sweep_inputs(h, "quadrature", TRAIN_BATCH, 13, form=form)
            times_wide[(h, m)] = time_sweep(args, g)
            del args, g
            print(f"wide kernels at H={h}, M={m}, B={TRAIN_BATCH}: "
                  + ", ".join(f"{k} {v['ms']:.4f} ms (plain "
                              f"{v['plain_ms']:.3f})"
                              for k, v in times_wide[(h, m)].items()))

    # the wide rollout at the speed path's shapes, and its training step
    times_wide_roll = {}
    for h in WIDE_WIDTHS:
        m, inputs = rollout_case(model, kw, h, N_STEPS, TRAIN_BATCH)
        # the plain backward: three timed calls after the warm-up
        times_wide_roll[h] = time_kernels(
            R.FusedRolloutOp(m, h, n_pieces=PIECES), inputs, plain_reps=3)
        del inputs
        print(f"wide rollout at H={h}, N={N_STEPS}, B={TRAIN_BATCH}: "
              + ", ".join(f"{k}w {v['ms']:.4f} ms (plain {v['plain_ms']:.3f})"
                          for k, v in times_wide_roll[h].items()))
    wide_step_ms = {h: time_step(t, 60 + h, f"speed at hidden ({h}, {h})")[0]
                    for h, t in wide_trainers.items()}
    wide_parity_ms = {label: time_step(wide_parity[label], 70 + k, label,
                                       reps=3)[0]
                      for k, (label, *_) in enumerate(WIDE_PARITY)}

    # 5. the smart-grid MFG model: no kernel on its paths
    mfg = mfg_phases(counters)

    # 6. the experiment CLI, in this process
    with tempfile.TemporaryDirectory() as tmp:
        cli_out = cli_phases(counters, tmp)
    by_path["cli_merton"] = {
        k: sum(v.get(k, 0) for v in cli_out["merton"].values())
        for k in counters}
    by_path["cli_vg"] = {k: sum(v.get(k, 0) for v in cli_out["vg"].values())
                         for k in counters}
    for cmd, width, _ in CLI_WIDE:
        by_path[f"cli_{cmd}_{width}"] = {
            k: cli_out[f"{cmd}_{width}"].get(k, 0) for k in counters}

    # 7. the bench, through the CLI in this process
    bench = bench_phases(counters)
    speed_rate = bench["speed"]["json"]["value"]
    f1 = {"bench_speed_paths_steps_per_s": speed_rate,
          "bench_speed_step_ms": 1e3 * TRAIN_BATCH * N_STEPS / speed_rate,
          "vg_speed_step_ms": vg_ms["speed"],
          "indexing_backward_in_vg_speed": False}
    print(f"bench speed cell (the unfused Merton speed step, plain rollout "
          f"over piecewise tables): {speed_rate:.4g} paths·steps/s, "
          f"{f1['bench_speed_step_ms']:.2f} ms a step at batch "
          f"{TRAIN_BATCH}; VG speed step {vg_ms['speed']:.3f} ms")
    for label, cell in bench.items():
        if label != "seconds":
            by_path[f"bench_{label}"] = {k: cell["launches"].get(k, 0)
                                         for k in counters}

    # 8. one accuracy gate through the port's runner
    print(f"gate {GATE} (3 seeds × 2400 steps, batch 8192):")
    entry = gates.build_registry()[GATE]
    for fn in counters.values():
        fn.launches = 0
    gate = gates.run_entry(GATE, entry)
    by_path[GATE] = {k: fn.launches for k, fn in counters.items()}
    updates = entry["args"]["seeds"] * entry["args"]["steps"]
    # a warm start draws J at each time step of one pass per seed
    warm = (entry["args"]["seeds"] * entry["args"]["model"].N
            if entry["args"].get("warm_y0") else 0)
    want = dict({k: 0 for k in counters}, B1=updates, B2=updates,
                J=updates + warm)
    print(f"gate {GATE}: launches {by_path[GATE]}")
    if not gate["pass_1e-3"]:
        fail(f"gate {GATE} failed: max |Y0 − oracle| {gate['abs_error']}")
    if by_path[GATE] != want:
        fail(f"gate {GATE} launched {by_path[GATE]}, the code implies "
             f"{want}")

    # 9. data parallelism: ranks sharing this card
    dp, dp_paths = dp_phases(counters)
    by_path.update(dp_paths)

    # 10. the opt-in instruments
    item13, tf32 = item13_phases(counters)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    rollout_shape = {"N": N_STEPS, "B": TRAIN_BATCH, "H": HIDDEN, "P": PIECES}
    sources = {
        "B1": ("rollout_fwd", "pallas_rollout.py:311", N_STEPS, rollout_shape),
        "B2": ("rollout_bwd", "pallas_rollout.py:352", N_STEPS, rollout_shape),
        "B3": ("sweep_fwd", "pallas_sweep.py:179", N_QUAD,
               {"M": N_QUAD, "B": TRAIN_BATCH, "H": HIDDEN}),
        "B4": ("sweep_bwd", "pallas_sweep.py:199", N_QUAD,
               {"M": N_QUAD, "B": TRAIN_BATCH, "H": HIDDEN})}
    record = []
    for k, (src, tpu, n, shape) in sources.items():
        b_ms, b_by = bound(k, n, TRAIN_BATCH, HIDDEN, PIECES)
        entry = {
            "name": f"{k} {src}", "route": "cuda",
            "source": f"deepfbsdejsolvers_torch/csrc/{src}.cu",
            "replaces": f"deepfbsdejsolvers_tpu/ops/{tpu}",
            "launches": launches[k],
            "launches_by_path": {path: n[k] for path, n in by_path.items()
                                 if n[k]},
            "max_abs_err": check[k]["max_abs_err"],
            "rel_err": check[k]["rel_err"], "check": "pass",
            "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": shape}
        print(f"{k}: {times[k]['ms']:.4f} ms (plain {times[k]['plain_ms']:.3f}"
              f" ms, bound {b_ms:.4f} ms by {b_by})")
        if k in times_mc:
            mc_ms, mc_by = bound(k, N_MC, TRAIN_BATCH, HIDDEN, PIECES)
            entry["mc5000"] = {
                "ms": times_mc[k]["ms"], "plain_ms": times_mc[k]["plain_ms"],
                "bound_ms": mc_ms, "bound_by": mc_by,
                "plain_node_block": 2**24 // TRAIN_BATCH,
                "shape": {"M": N_MC, "B": TRAIN_BATCH, "H": HIDDEN}}
            print(f"{k} at M={N_MC}: {times_mc[k]['ms']:.3f} ms (plain "
                  f"{times_mc[k]['plain_ms']:.1f} ms, bound {mc_ms:.3f} ms "
                  f"by {mc_by})")
        if k in ("B3", "B4"):
            vg_ms_k, vg_by = bound(k, N_VG_QUAD, TRAIN_BATCH, HIDDEN, PIECES)
            entry["vg_quadrature96"] = {
                form: {"ms": times_vg[form][k]["ms"],
                       "plain_ms": times_vg[form][k]["plain_ms"],
                       "max_abs_err": vg_check[form][k]["max_abs_err"],
                       "rel_err": vg_check[form][k]["rel_err"]}
                for form in times_vg}
            entry["vg_quadrature96"].update(
                bound_ms=vg_ms_k, bound_by=vg_by,
                shape={"M": N_VG_QUAD, "B": TRAIN_BATCH, "H": HIDDEN})
            for form in times_vg:
                print(f"{k} at M={N_VG_QUAD} ({form}): "
                      f"{times_vg[form][k]['ms']:.4f} ms (plain "
                      f"{times_vg[form][k]['plain_ms']:.3f} ms, bound "
                      f"{vg_ms_k:.4f} ms by {vg_by})")
        record.append(entry)
    # the wide kernels: the main row at the merton --nbNeuron 64 path's
    # shapes (its error from the check at them), every width class and
    # both node sets under by_width (errors on the 49 nodes at 2^14 + 37)
    wide_paths = [label for label, *_ in WIDE_PARITY] + [
        f"cli_{cmd}_{width}" for cmd, width, _ in CLI_WIDE]
    for k, src, tpu, fn in (
            ("B3w", "sweep_wide_fwd", "pallas_sweep.py:179", "fwd_kernel"),
            ("B4w", "sweep_wide_bwd", "pallas_sweep.py:199", "bwd_kernel")):
        kind = k[:2]
        by_width = {}
        for h in WIDE_WIDTHS:
            hp = S.wide_class(h)
            err = wide_check[(h, WIDE_SWEEP_CHECKS[0])][kind]
            row = {"HP": hp, "max_abs_err": err["max_abs_err"],
                   "rel_err": err["rel_err"],
                   "ptxas": ptxas.get(f"{src} {fn}<{hp}>"),
                   **occupancy_by[f"{src}<{hp}>"]}
            for m in (N_QUAD, N_VG_QUAD):
                b_ms, b_by = tc_floor(kind, m, TRAIN_BATCH, h)
                fp32_ms, _ = bound(kind, m, TRAIN_BATCH, h, PIECES)
                t = times_wide[(h, m)][kind]
                row[f"M{m}"] = {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                "bound_ms": b_ms, "bound_by": b_by}
                print(f"{k} at H={h} (HP {hp}), M={m}: {t['ms']:.4f} ms "
                      f"(plain {t['plain_ms']:.3f} ms, tensor-core bound "
                      f"{b_ms:.4f} ms by {b_by}; FP32 bound {fp32_ms:.4f} "
                      f"ms)")
            by_width[h] = row
        main_row = by_width[64][f"M{N_QUAD}"]
        main_err = wide_check[(64, ("quadrature", 0, "j", 2**17 + 37))][kind]
        record.append({
            "name": f"{k} {src}", "route": "cuda",
            "source": f"deepfbsdejsolvers_torch/csrc/{src}.cu",
            "replaces": f"deepfbsdejsolvers_tpu/ops/{tpu}",
            "launches": sum(by_path[p][k] for p in wide_paths),
            "launches_by_path": {p: by_path[p][k] for p in wide_paths},
            "max_abs_err": main_err["max_abs_err"],
            "rel_err": main_err["rel_err"], "check": "pass",
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "shape": {"M": N_QUAD, "B": TRAIN_BATCH, "H": 64},
            "by_width": by_width})
        if kind == "B4":
            record[-1]["f64_distances"] = {"H": F64_CHECK[0], "M": N_MC,
                                           "B": F64_CHECK[1][3], **f64}
    # the wide rollout: the main row at hidden 64 (the wide speed path's
    # shapes, its error from the check at 2^17 + 37 paths), every width
    # under by_width (errors from the check at 2^14 + 37)
    wide_paths = [f"speed_{h}" for h in WIDE_TRAIN_WIDTHS]
    for k, src, tpu, fn in (
            ("B1w", "rollout_wide_fwd", "pallas_rollout.py:311", "fwd_kernel"),
            ("B2w", "rollout_wide_bwd", "pallas_rollout.py:352",
             "bwd_kernel")):
        kind = k[:2]
        by_width = {}
        for h in WIDE_WIDTHS:
            hp = R.wide_class(h)
            b_ms, b_by = tc_floor(kind, N_STEPS, TRAIN_BATCH, h)
            fp32_ms, _ = bound(kind, N_STEPS, TRAIN_BATCH, h, PIECES)
            t = times_wide_roll[h][kind]
            by_width[h] = {
                "HP": hp, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "fp32_bound_ms": fp32_ms,
                **wide_roll_check[(h, WIDE_ROLLOUT_CHECKS[0])][kind],
                "ptxas": ptxas.get(f"{src} {fn}<{hp},false>"),
                **occupancy_by[f"{src}<{hp}>"]}
            print(f"{k} at H={h} (HP {hp}): {t['ms']:.4f} ms (plain "
                  f"{t['plain_ms']:.3f} ms, tensor-core bound {b_ms:.4f} ms "
                  f"by {b_by}; FP32 bound {fp32_ms:.4f} ms)")
        main_row = by_width[64]
        main_err = wide_roll_check[(64, WIDE_ROLLOUT_CHECKS[-1])][kind]
        record.append({
            "name": f"{k} {src}", "route": "cuda",
            "source": f"deepfbsdejsolvers_torch/csrc/{src}.cu",
            "replaces": f"deepfbsdejsolvers_tpu/ops/{tpu}",
            "launches": sum(by_path[p][k] for p in wide_paths),
            "launches_by_path": {p: by_path[p][k] for p in wide_paths},
            "max_abs_err": main_err["max_abs_err"],
            "rel_err": main_err["rel_err"], "check": "pass",
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "fp32_bound_ms": main_row["fp32_bound_ms"],
            "shape": {"N": N_STEPS, "B": TRAIN_BATCH, "H": 64, "P": PIECES},
            "by_width": by_width})
        if kind == "B2":
            record[-1]["f64_distances"] = {
                "H": ROLLOUT_F64_CHECK[0], "N": ROLLOUT_F64_CHECK[1],
                "B": ROLLOUT_F64_CHECK[2], **rollout_f64}
    # the icdf jump kernel: its launches on the speed path, and per path
    icdf.update(launches=launches["J"],
                launches_by_path={path: n["J"] for path, n in by_path.items()
                                  if n.get("J")})
    # the head-TF32 instances: each kernel's row at the hidden width it
    # trained at (21 for B1/B2, 64 for B1w/B2w, which also trained at 128),
    # its error from the check there (B1w/B2w: at hidden 64), every timed
    # width under by_width with its ptxas report, and B2's and the wide
    # pair's blocks per SM
    for k, src, h, fn in (
            ("B1", "rollout_fwd", HIDDEN, "fwd_kernel<{},true>"),
            ("B2", "rollout_bwd", HIDDEN, "bwd_kernel<{},true>"),
            ("B1w", "rollout_wide_fwd", 64, "fwd_kernel<{},true>"),
            ("B2w", "rollout_wide_bwd", 64, "bwd_kernel<{},true>")):
        kind = k[:2]
        t = tf32["times"][h][kind]
        err = tf32["check"][h][kind]
        tpu = "pallas_rollout.py:311" if kind == "B1" else \
            "pallas_rollout.py:352"
        by_path = {f"speed_tf32_{w}": tf32["launches"][w][k]
                   for w in TF32_TRAINED if k in tf32["launches"][w]}
        by_width = {w: dict(tf32["times"][w][kind]) for w in TF32_TIMED
                    if (w in R.KERNEL_WIDTHS) == (k in ("B1", "B2"))}
        for w, row in by_width.items():
            # the width a kernel is built for: its own or its class
            built_at = w if k in ("B1", "B2") else R.wide_class(w)
            if k not in ("B1", "B2"):
                row["HP"] = built_at
            row.update(ptxas=ptxas.get(f"{src} {fn.format(built_at)}"),
                       **occupancy_by.get(f"{src}_tf32<{built_at}>", {}))
        record.append({
            "name": f"{k} {src} [head tf32]", "route": "cuda",
            "source": f"deepfbsdejsolvers_torch/csrc/{src}.cu",
            "replaces": f"deepfbsdejsolvers_tpu/ops/{tpu}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err["max_abs_err"], "rel_err": err["rel_err"],
            "check": "pass", "ms": t["ms"][0], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "highest_ms": t["highest_ms"][0],
            "turns_ms": {"tf32": t["ms"], "highest": t["highest_ms"]},
            "shape": {"N": N_STEPS, "B": TRAIN_BATCH, "H": h, "P": PIECES},
            "by_width": by_width})
    record.append(icdf)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": record, "train_step_ms": step_ms,
                      "paths_steps_per_s": rate,
                      "parity_train_step_ms": pstep_ms,
                      "parity_paths_steps_per_s": prate,
                      "scheme_train_step_ms": scheme_ms,
                      "vg_train_step_ms": vg_ms,
                      "wide_train_step_ms": wide_step_ms,
                      "wide_parity_train_step_ms": wide_parity_ms,
                      "f1": f1, "mfg": mfg,
                      "cli": cli_out, "bench": bench, "gate": gate,
                      "dp": dp, "item13": item13}))
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
