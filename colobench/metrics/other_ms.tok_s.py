"""other_ms in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.readers.other_ms`)."""

from colobench.lib.readers import other_ms as read  # noqa: F401
