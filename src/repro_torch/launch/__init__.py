"""Launchers.  Port of ``src/repro/launch``: only ``serve`` so far."""
