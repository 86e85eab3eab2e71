"""ColoGrid in PyTorch: the port of ``src/repro`` to CUDA on an H100.

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Its entry points run on CUDA unless the caller passes CPU devices.
"""
