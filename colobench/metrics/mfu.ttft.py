"""mfu in the traced prefill calls, in the cells that report
``ttft_p95_ms`` (:func:`colobench.lib.readers.mfu`)."""

from colobench.lib.readers import mfu as read  # noqa: F401
