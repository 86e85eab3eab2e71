"""launches_per_call in the traced prefill calls, in the cells that report
``ttft_p95_ms`` (:func:`colobench.lib.readers.launches_per_call`)."""

from colobench.lib.readers import launches_per_call as read  # noqa: F401
