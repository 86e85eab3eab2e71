"""Synthetic datasets for the port.  Port of ``src/repro/data``."""

from repro_torch.data.pipeline import (
    PAPER_STRATA,
    ColocatedTokenDataset,
    image_population_table,
    population_covariates,
    synthetic_image_population,
    synthetic_token_table,
)

__all__ = [
    "PAPER_STRATA",
    "ColocatedTokenDataset",
    "image_population_table",
    "population_covariates",
    "synthetic_image_population",
    "synthetic_token_table",
]
