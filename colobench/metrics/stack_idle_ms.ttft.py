"""stack_idle_ms in the traced prefill calls, in the cells that report
``ttft_p95_ms`` (:func:`colobench.lib.spans.stack_idle_ms`)."""

from colobench.lib.spans import stack_idle_ms as read  # noqa: F401
