"""PyTorch / CUDA port of the deep FBSDE solvers with jumps.

The package mirrors the JAX package module by module (``models``,
``nets``, ``ops``, ``solvers``, ``eval``, ``experiments``, ``parallel``,
``utils``) and
is held against it by the ``tests/test_torch_*.py`` parity tests.  It imports torch, numpy and scipy
only.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the hot loop of Merton global training (the fused hoisted
rollout, forward and backward) runs as hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` on first use (``ops/_build.py``).  The
smart-grid MFG model (``models/mfg_smart_grid.py``, ``solvers/mfg.py``) has
an analytic compensator and reaches no kernel.
"""
