"""Hand-written CUDA kernels for the port's compute hot spots.

Port of ``src/repro/kernels``.  Each kernel package ships its CUDA source
under ``csrc/``, a ``kernel.py`` that builds and binds it and holds its
plain PyTorch version, an ``ops.py`` public op and a ``ref.py`` oracle:

- ``fused_fold``      — the fold-phase workhorse: one pass per block
  emitting the grouped pool ``(count, Σx, Σx², Σx³, Σx⁴)`` in fp32;
- ``streaming_stats`` — a facade over ``fused_fold`` with the
  ``(Σx, Σx², n)`` subset.

The reference's ``flash_attention`` and ``ssm_scan`` belong to the LM
workload and are not ported yet.
"""
