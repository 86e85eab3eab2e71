"""idle_share in the traced prefill calls, in the cells that report
``ttft_p95_ms`` (:func:`colobench.lib.readers.idle_share`)."""

from colobench.lib.readers import idle_share as read  # noqa: F401
