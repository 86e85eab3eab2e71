"""Synthetic imaging population served from the colocation grid.

Port of ``src/repro/data/pipeline.py``, the imaging half only: the paper's
T1 population with the Table-3 age/sex strata.  For one seed it draws
exactly the reference's numbers.  Token corpora and the colocated training
dataset belong to the LM workload and are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.regions import HierarchicalSplitPolicy
from repro_torch.core.table import ColumnFamily, ColumnSpec, TensorTable


#: Table 3 of the paper: (age_lo, age_hi, female_count, male_count)
PAPER_STRATA = (
    (4.0, 20.0, 1157, 698),
    (20.0, 40.0, 651, 648),
    (40.0, 60.0, 230, 280),
    (60.0, 98.0, 332, 494),
)


def population_covariates(rng: np.random.Generator, scale: float = 1.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``(ages float32, sexes int8)`` per Table 3, in upload order — the
    first draws :func:`synthetic_image_population` takes from ``rng``."""
    rows = []
    for lo, hi, f_cnt, m_cnt in PAPER_STRATA:
        for sex, cnt in ((1, f_cnt), (0, m_cnt)):
            n = max(int(round(cnt * scale)), 1)
            ages = rng.uniform(lo, hi, n).astype(np.float32)
            rows.extend((a, sex) for a in ages)
    n = len(rows)
    ages = np.array([r[0] for r in rows], np.float32)
    sexes = np.array([r[1] for r in rows], np.int8)
    order = rng.permutation(n)
    return ages[order], sexes[order]


def image_population_table(payload_shape: Tuple[int, ...]) -> TensorTable:
    """The empty population table: ``img:data`` volumes beside the
    ``idx`` family (logical size, age, sex), split by logical bytes."""
    return TensorTable(
        "t1_population",
        [
            ColumnFamily("img", (ColumnSpec("data", payload_shape, np.float32),)),
            ColumnFamily("idx", (
                ColumnSpec("size", (), np.int64),
                ColumnSpec("age", (), np.float32),
                ColumnSpec("sex", (), np.int8),
            )),
        ],
        split_policy=HierarchicalSplitPolicy(max_region_bytes=1 << 31),
    )


def synthetic_image_population(
    payload_shape: Tuple[int, ...] = (16, 16, 16),
    scale: float = 1.0,
    seed: int = 0,
) -> TensorTable:
    """The paper's study population per Table 3 strata (4,490 subjects;
    the paper's 5,153 figure counts *images* — some subjects have repeat
    scans), with logical sizes drawn from [SizeSmall, SizeBig] = [6, 20] MB.
    ``scale`` < 1 shrinks each stratum proportionally for CI-speed runs."""
    rng = np.random.default_rng(seed)
    ages, sexes = population_covariates(rng, scale)
    n = len(ages)
    table = image_population_table(payload_shape)
    data = rng.normal(0.0, 1.0, (n,) + payload_shape).astype(np.float32)
    # age covariate leaks into the volumes so subset averages differ measurably
    data += ages[:, None, None, None] / 100.0
    sizes = rng.integers(6_000_000, 20_000_001, n)
    table.upload(
        [f"sub{i:06d}" for i in range(n)],
        {"img": {"data": data},
         "idx": {"size": sizes, "age": ages, "sex": sexes}},
    )
    return table
