"""The numbers that decide ``correct``, each against its limit.

A served prefill is judged on what it returned and on what decode would
read next:

- ``logit_err``: the median over the checked requests of the relative
  distance of the program's last-position logits from the reference's,
  each side's mean over the vocabulary removed (a constant shift changes
  no probability).
- ``cache_med``: over the checked requests, the largest of each
  request's median error over its layers' cache leaves (Mixtral's
  K/V): the relative distance of the program's cache from the
  reference's, of the whole stack's caches that decode would read.
- ``cache_first``: over the checked requests, the largest error of the
  first layer's cache leaves, as many as its family caches, which no
  earlier layer's drift reaches: the precision of the projections
  themselves.
- ``token_mismatch``: the checked requests whose served first token is
  not the greedy choice of the logits the prefill returned (an exact
  comparison: limit 0).  With ``logit_err`` it ties each served token to
  the reference.

Logged, not compared: ``cache_max``, the worst leaf of any layer, where
bf16's drift at the deepest layers reads 0.021-0.027 against float8's
0.065 (under three times: PERF.md); ``token_gap`` (the widest gap by
which a served token's logit lies below the reference's best, in units
of the reference's logit standard deviation): bf16 and float8 runs both
read 0 except on near-ties, and it separates neither; and each
request's error beside the reference's routing at its last token (the
narrowest gap between its second and third router logits, and how near
its slots lie to their experts' capacity).  A sound bf16 program routes
some 6% of last tokens the other way on a near-tie, and those requests
read 0.04-0.12 (PERF.md): the median over the checked requests is what
their error is held to.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence

import torch

F32 = torch.float32


def token_gaps(ref_logits: torch.Tensor, served: Sequence[int]
               ) -> List[float]:
    """Per request: (reference's best - reference's logit of the served
    token) / the reference's standard deviation over the vocabulary."""
    z = ref_logits.to(F32)
    idx = torch.as_tensor(list(served), device=z.device, dtype=torch.int64)
    best = z.max(dim=-1).values
    got = z.gather(1, idx[:, None])[:, 0]
    return ((best - got) / z.std(dim=-1)).tolist()


def logit_errs(prog: torch.Tensor, ref: torch.Tensor) -> List[float]:
    """Per request: |(p - mean p) - (r - mean r)| / |r - mean r|."""
    p, r = prog.to(F32), ref.to(F32)
    p = p - p.mean(-1, keepdim=True)
    r = r - r.mean(-1, keepdim=True)
    return ((p - r).norm(dim=-1) / r.norm(dim=-1)).tolist()


def cache_errs(prog: Iterable[Dict], ref: Iterable[Dict]) -> List[float]:
    """Per layer and leaf: |prog - ref| / |ref|."""
    out = []
    for pl, rl in zip(prog, ref, strict=True):
        if set(pl) != set(rl):
            raise ValueError(f"cache leaves differ: {sorted(pl)} vs "
                             f"{sorted(rl)}")
        for key in sorted(rl):
            p, r = pl[key].to(F32), rl[key].to(F32)
            if p.shape != r.shape:
                raise ValueError(f"cache {key}: {tuple(p.shape)} vs "
                                 f"{tuple(r.shape)}")
            out.append(float((p - r).norm() / r.norm().clamp_min(1e-30)))
    return out


class Numbers:
    """Readings gathered over the checked requests, reduced to the numbers
    compared."""

    def __init__(self):
        self.gaps: List[float] = []
        self.logits: List[float] = []
        self.caches: List[float] = []
        #: each checked call's cache errors: a list a layer, one error a
        #: leaf its family caches, in the leaves' sorted order
        self.cache_by_call: List[List[List[float]]] = []
        self.mismatch = 0
        #: per request: the reference's routing readings at its last token
        #: (the narrowest router margin, the nearest capacity edge)
        self.routing: List[Dict[str, float]] = []

    def add(self, ref_logits, ref_caches, prog_logits, prog_caches, served,
            diag: Optional[List[Dict]] = None):
        self.gaps += token_gaps(ref_logits, served)
        self.logits += logit_errs(prog_logits, ref_logits)
        by_layer = [cache_errs([p], [r])
                    for p, r in zip(prog_caches, ref_caches, strict=True)]
        self.caches += [e for layer in by_layer for e in layer]
        self.cache_by_call.append(by_layer)
        greedy = prog_logits.argmax(dim=-1).tolist()
        self.mismatch += sum(int(a) != int(b) for a, b in zip(served, greedy))
        if diag:
            for b in range(len(served)):
                self.routing.append({
                    "margin": min(d["margin"][b] for d in diag),
                    "edge": min(d["edge"][b] for d in diag),
                    "dropped": max(d["dropped"] for d in diag)})

    def values(self) -> Dict[str, float]:
        if not self.logits:             # nothing came back to check
            return dict.fromkeys(("logit_err", "cache_med", "cache_first",
                                  "token_mismatch", "cache_max"),
                                 float("inf"))
        return {"logit_err": statistics.median(self.logits),
                "cache_med": max(statistics.median(e for layer in call
                                                   for e in layer)
                                 for call in self.cache_by_call),
                "cache_first": max(max(call[0])
                                   for call in self.cache_by_call),
                "token_mismatch": self.mismatch,
                # logged beside them, not compared
                "cache_max": max(self.caches)}

    def describe(self) -> str:
        """Each request's readings, for the log."""
        rows = []
        for j, (e, g) in enumerate(zip(self.logits, self.gaps)):
            r = self.routing[j] if j < len(self.routing) else {}
            rows.append(f"{e:.5f}/{g:.4f}" + (
                f"/m{r['margin']:.4f}/e{r['edge']:.0f}/d{r['dropped']:.4f}"
                if r else ""))
        return (f"per request logit error/token gap[/margin/edge/"
                f"dropped]: {' '.join(rows)}; cache error max "
                f"{max(self.caches, default=None)}")


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number with its limit, in the limits' order; a number without
    a limit is an error."""
    missing = set(limits) - set(values)
    if missing:
        raise ValueError(f"no reading for {sorted(missing)}")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())
