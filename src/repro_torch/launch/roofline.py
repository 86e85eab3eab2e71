"""Roofline terms from a dry run's counts, with H100 constants.

Port of ``src/repro/launch/roofline.py``.  Three terms per (arch x shape
x mesh), in seconds:

    compute    = FLOPs_per_rank / PEAK_FLOPS_BF16
    memory     = bytes_per_rank / HBM_BW
    collective = intra-node wire bytes / NVLINK_BW
                 + cross-node wire bytes / IB_BW

FLOPs and bytes are one rank's work: the dry run counts the ops each
rank runs on its local shards (``launch/dryrun.py``).  Wire bytes are the
collectives' output bytes times the reference's ring factors
{all-reduce: 2, all-gather / reduce-scatter / all-to-all: 1}, split into
the bytes of groups that stay inside one 8-GPU node and those that cross
nodes (the reference's ICI/DCN split).

H100 SXM constants, per GPU, from NVIDIA's H100 Tensor Core GPU data
sheet (dense rates, no sparsity) and NVIDIA's DGX H100 system
description: 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB of memory, NVLink 4
at 450 GB/s each way inside an 8-GPU node, one 400 Gb/s (50 GB/s)
InfiniBand NDR port per GPU across nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9
IB_BW = 50e9
GPUS_PER_NODE = 8

COLLECTIVE_FACTOR = {
    "all_reduce": 2.0,
    "all_gather": 1.0,
    "reduce_scatter": 1.0,
    "all_to_all": 1.0,
}


def crosses_nodes(ranks) -> bool:
    """Whether a group of global ranks spans more than one node (ranks
    ``8n .. 8n + 7`` share node ``n``)."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def compute_fraction(self) -> float:
        """Useful-compute time over the binding term."""
        return self.compute_s / max(self.bound_s, 1e-30)


def derive_terms(flops: float, bytes_accessed: float, wire_bytes: float,
                 cross_node_bytes: float = 0.0) -> RooflineTerms:
    """``wire_bytes`` is the total; ``cross_node_bytes`` the part of it
    whose groups span nodes, which moves at the InfiniBand rate."""
    intra = wire_bytes - cross_node_bytes
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=bytes_accessed / HBM_BW,
        collective_s=intra / NVLINK_BW + cross_node_bytes / IB_BW,
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        wire_bytes_per_device=wire_bytes,
    )


def model_flops(cfg, shape_spec, n_tokens: Optional[int] = None) -> float:
    """6·N·D (training) / 2·N·D (inference forward), N = active params."""
    n_active = cfg.active_param_count()
    if n_tokens is None:
        n_tokens = shape_spec.global_batch * (
            1 if shape_spec.kind == "decode" else shape_spec.seq_len)
    mult = 6.0 if shape_spec.kind == "train" else 2.0
    return mult * n_active * n_tokens
