"""norm_rope_ms in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.spans.norm_rope_ms`)."""

from colobench.lib.spans import norm_rope_ms as read  # noqa: F401
