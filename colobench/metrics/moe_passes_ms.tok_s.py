"""moe_passes_ms in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.spans.moe_passes_ms`)."""

from colobench.lib.spans import moe_passes_ms as read  # noqa: F401
