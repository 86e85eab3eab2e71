"""Serving: batched prefill + cached decode.  Port of ``src/repro/serve``."""

from repro_torch.serve.engine import (  # noqa: F401
    GenerationResult,
    ServeEngine,
    make_serve_step,
)
