"""k2_roofline in the traced prefill calls, in the cells that report
``prefill_tok_s`` (:func:`colobench.lib.readers.k2_roofline`)."""

from colobench.lib.readers import k2_roofline as read  # noqa: F401
