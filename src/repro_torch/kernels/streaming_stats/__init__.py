"""Masked streaming stats: a facade over the fused fold.  Port of
``src/repro/kernels/streaming_stats/``."""
