"""RMSNorm and RoPE in one pass each: ``csrc/norm_rope.cu`` is the CUDA
source (two kernels behind a plain C interface), ``ops.py`` its ctypes
binding, the launch shapes and the autograd Functions that
``models/layers.py``'s ``rms_norm`` and ``apply_rope`` call, ``ref.py``
the plain versions (what CPU and meta tensors run, and what the
backwards recompute)."""
