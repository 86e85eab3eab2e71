"""other_ms in the traced prefill calls, in the cells that report
``ttft_p95_ms`` (:func:`colobench.lib.readers.other_ms`)."""

from colobench.lib.readers import other_ms as read  # noqa: F401
