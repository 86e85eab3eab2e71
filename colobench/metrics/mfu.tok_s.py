"""mfu in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.readers.mfu`)."""

from colobench.lib.readers import mfu as read  # noqa: F401
