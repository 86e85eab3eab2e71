"""Hand-written CUDA kernels for the port's compute hot spots.

Port of ``src/repro/kernels``.  Each kernel package ships its CUDA source
under ``csrc/``, a ``kernel.py`` that builds and binds it and holds its
plain PyTorch version, an ``ops.py`` public op and a ``ref.py`` oracle:

- ``fused_fold``      — the fold-phase workhorse: one pass per block
  emitting the grouped pool ``(count, Σx, Σx², Σx³, Σx⁴)`` in fp32;
- ``streaming_stats`` — a facade over ``fused_fold`` with the
  ``(Σx, Σx², n)`` subset;
- ``flash_attention`` — causal / sliding-window attention forward for the
  LM workload's prefill (``models/attention.py``);
- ``ssm_scan``        — the chunked mamba2 SSD scan from a zero state for
  the LM workload's prefill (``models/ssm.py``).

``_build.py`` compiles each ``csrc/*.cu`` with nvcc at first use and loads
it with ctypes; builds can be started side by side.
"""
