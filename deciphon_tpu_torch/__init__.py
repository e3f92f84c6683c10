"""deciphon_tpu_torch — the deciphon_tpu scan path on PyTorch and CUDA.

A port of ``deciphon_tpu`` to PyTorch with hand-written Hopper (sm_90a)
kernels.  The JAX package stays the reference: this package imports its
jax-free host modules (profiles, the .dtp format, fragment indexing, the
codec and the product writer) and never imports jax itself.

Subpackages:
  ops   - Viterbi recurrence (plain torch + CUDA kernel), table synthesis,
          traceback DP and the scan engine
  cli   - press / scan / info entry points
  csrc  - CUDA C++ kernel sources, built on first use by ops/_build.py
"""

__version__ = "0.1.0"
