"""idle_share in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.readers.idle_share`)."""

from colobench.lib.readers import idle_share as read  # noqa: F401
