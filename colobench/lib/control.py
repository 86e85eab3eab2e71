"""The control of a prefill cell: the reference in float8 (the precision
below the configurations' bf16) in the program's place, on the requests
a run would check, judged by the same numbers against the float32
reference (the served token is the one the float8 logits put first).
``correct`` has to come out false for it."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from colobench.generators.prefill import Traffic
from colobench.lib.check import Numbers
from colobench.lib.model import family, make_weights, model_config
from colobench.reference.common import Precision


def prefill_control(cell, seed: int, device, requests: int, log=None
                    ) -> Dict[str, float]:
    """The control's numbers on the requests that a run of ``seed`` whose
    window holds ``requests`` requests would check."""
    c = cell.config
    cfg = model_config(c)
    fam = family(c)
    weights = make_weights(cfg, seed, device, fam)
    traffic = Traffic(cell.traffic, cfg.vocab, seed)
    view = fam.layer_view(cfg, weights)
    ref = cell.reference()
    nums = Numbers()
    for i in traffic.sample(requests):
        tokens = torch.as_tensor(traffic.prompt(i), dtype=torch.int64,
                                 device=device)
        diag: List[Dict] = []
        r_logits, r_caches = ref.prefill(c, view, tokens, diag=diag)
        q_logits, q_caches = ref.prefill(c, view, tokens, Precision(fp8=True))
        nums.add(r_logits, r_caches, q_logits, q_caches,
                 q_logits.argmax(-1).tolist(), diag)
        del r_logits, r_caches, q_logits, q_caches
    if log:
        log(f"control: {nums.describe()}")
    del weights, view
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return nums.values()
