"""deciphon_tpu_torch — deciphon_tpu on PyTorch and CUDA.

A port of ``deciphon_tpu`` to PyTorch with hand-written Hopper (sm_90a)
kernels.  The JAX package stays the reference: this package keeps its
own copies of the host modules it needs and imports neither jax nor
anything of ``deciphon_tpu``.

Subpackages:
  models   - alphabets/genetic code, frame-state emissions, HMMER3 reader
             and writer, profile builder, state ids, path codec
  db       - the .dtp tensor database, typeid dispatch, partitioning
  ops      - Viterbi recurrence (plain torch + CUDA kernel), table
             synthesis, traceback DP, f64 oracle and the scan engine
  parallel - device mesh and the profile-sharded scan tiles
  server   - scheduler daemon, REST client, entities, product writer,
             fake scheduler
  native   - ctypes binding of the repo's C++ .hmm tokenizer
  utils    - return codes, logging, config, hashing, progress, math
  cli      - serve / press / scan / info entry points
  csrc     - CUDA C++ kernel sources, built on first use by ops/_build.py
"""

__version__ = "0.1.0"
