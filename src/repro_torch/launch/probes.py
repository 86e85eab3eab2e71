"""Probe plans for depth-corrected roofline accounting.

Port of ``src/repro/launch/probes.py`` (plain config logic, copied).  In
the reference, XLA's ``cost_analysis`` counts a ``scan`` body once, so
the probes stand in for the unrolled stack.  The port's dry run counts
every op it runs, so a full-depth count is exact; the probes still cut
its cost (a 126-layer cell runs as two or three shallow ones) and check
that the per-layer bodies add up.  Per cell, tiny *probe* variants:

    probe A     — exactly one layer of every distinct block kind
    probe B_k   — one extra layer of kind k

Since all layers of a kind are structurally identical, the per-layer body
cost is exactly ``C(B_k) − C(A)``, and the corrected total is

    C_corrected = C(A) + Σ_k (n_k − n_k^A) · (C(B_k) − C(A))

— every number still comes from a count of the true shapes and mesh.
``tests/test_torch_launch.py`` holds the corrected totals to a
full-depth count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ProbeB:
    label: str
    cfg: ModelConfig
    n_full: int      # layers of this kind in the full config
    n_in_a: int      # layers of this kind in probe A


def make_probe_plan(cfg: ModelConfig) -> Tuple[ModelConfig, List[ProbeB]]:
    """-> (probe_A_cfg, [ProbeB...]); all probes have scan_layers=False."""
    base = dataclasses.replace(cfg, scan_layers=False)

    if cfg.is_encdec:
        a = dataclasses.replace(
            base, n_layers=1,
            encoder=dataclasses.replace(cfg.encoder, n_layers=1))
        b_enc = ProbeB(
            "enc", dataclasses.replace(
                base, n_layers=1,
                encoder=dataclasses.replace(cfg.encoder, n_layers=2)),
            cfg.encoder.n_layers, 1)
        b_dec = ProbeB(
            "dec", dataclasses.replace(
                base, n_layers=2,
                encoder=dataclasses.replace(cfg.encoder, n_layers=1)),
            cfg.n_layers, 1)
        return a, [b_enc, b_dec]

    kinds = cfg.layer_kinds()

    if "attn_shared" in kinds:  # zamba-style hybrid
        n_shared = sum(1 for k in kinds if k == "attn_shared")
        n_ssm = len(kinds) - n_shared
        a = dataclasses.replace(
            base, n_layers=2, block_pattern=("ssm", "attn_shared"))
        b_ssm = ProbeB(
            "ssm", dataclasses.replace(
                base, n_layers=3,
                block_pattern=("ssm", "ssm", "attn_shared")),
            n_ssm, 1)
        b_sh = ProbeB(
            "attn_shared", dataclasses.replace(
                base, n_layers=3,
                block_pattern=("ssm", "attn_shared", "attn_shared")),
            n_shared, 1)
        return a, [b_ssm, b_sh]

    if cfg.moe is not None and cfg.moe.first_k_dense > 0:  # deepseek
        k = cfg.moe.first_k_dense
        a = dataclasses.replace(
            base, n_layers=2,
            moe=dataclasses.replace(cfg.moe, first_k_dense=1))
        b_dense = ProbeB(
            "dense", dataclasses.replace(
                base, n_layers=3,
                moe=dataclasses.replace(cfg.moe, first_k_dense=2)),
            k, 1)
        b_moe = ProbeB(
            "moe", dataclasses.replace(
                base, n_layers=3,
                moe=dataclasses.replace(cfg.moe, first_k_dense=1)),
            cfg.n_layers - k, 1)
        return a, [b_dense, b_moe]

    # uniform stacks (dense GQA, uniform MoE, rwkv)
    a = dataclasses.replace(base, n_layers=1)
    b = ProbeB("layer", dataclasses.replace(base, n_layers=2),
               cfg.n_layers, 1)
    return a, [b]


def corrected(
    a: Dict[str, float],
    bs: List[Tuple[ProbeB, Dict[str, float]]],
    keys: Tuple[str, ...] = ("flops", "bytes", "wire_bytes"),
) -> Dict[str, float]:
    out = dict(a)
    for key in keys:
        val = a.get(key, 0.0)
        for probe, m in bs:
            body = m.get(key, 0.0) - a.get(key, 0.0)
            val += (probe.n_full - probe.n_in_a) * body
        out[key] = val
    return out
