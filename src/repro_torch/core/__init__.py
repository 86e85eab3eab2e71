"""ColoGrid core — the paper's contribution as a composable PyTorch library.

Port of ``src/repro/core``: every module, the sketch programs, the
concurrent frontend and the discrete-event simulator included.

The subpackage mirrors HadoopBase-MIP's backend (Bao et al., 2017):

- :mod:`repro_torch.core.table`       — HBase-analogue columnar ``TensorTable``.
- :mod:`repro_torch.core.regions`     — region abstraction + split policies.
- :mod:`repro_torch.core.balancer`    — data-allocation strategies (HBase-default
  balanced, the paper's greedy ``#CPU x MIPS`` balancer, SGE central store).
- :mod:`repro_torch.core.placement`   — region->device placement realized as
  per-owner layouts + per-device task schedules.
- :mod:`repro_torch.core.mapreduce`   — MapReduce engine over the owner devices.
- :mod:`repro_torch.core.chunk_model` — the paper's eq. (1)-(8) wall/resource-time
  model and the chunk-size (eta) optimizer.
- :mod:`repro_torch.core.stats`       — summary-statistic MapReduce programs
  and the mergeable sketches (count-min, HyperLogLog, dyadic quantiles).
- :mod:`repro_torch.core.query`       — index-family predicate pushdown vs naive scan.
- :mod:`repro_torch.core.plan`        — :class:`GridQuery`, lazy scan→filter→map→
  reduce job plans with region pruning, projection pushdown, program fusion.
- :mod:`repro_torch.core.scheduler`   — grid scheduler: rounds, stragglers, failures.
- :mod:`repro_torch.core.simulator`   — discrete-event cluster simulator (the
  paper's Hadoop vs SGE orderings).
- :mod:`repro_torch.core.blockstore`  — :class:`BlockStore`, content-addressed
  copy-on-write per-region device blocks shared across epochs and plans.
- :mod:`repro_torch.core.grid`        — :class:`GridSession`, the five-verb facade
  (upload / retrieve / remove / rebalance / run) with mutation epochs,
  incremental placement, and a compiled-plan cache.
- :mod:`repro_torch.core.frontend`    — :class:`GridFrontend`, concurrent query
  serving with single-flight coalescing and batched ticks.
"""

from repro_torch.core.table import TensorTable, ColumnFamily, ColumnSpec
from repro_torch.core.regions import (
    Region,
    RegionSet,
    ConstantSizeSplitPolicy,
    HierarchicalSplitPolicy,
)
from repro_torch.core.balancer import (
    NodeSpec,
    assign_new_regions,
    balanced_allocation,
    greedy_allocation,
    central_allocation,
    rebalance,
    allocation_imbalance,
)
from repro_torch.core.placement import Placement
from repro_torch.core.chunk_model import (
    ChunkModelParams,
    ChunkModel,
    PAPER_PARAMS,
    TPU_V5E_PARAMS,
    H100_PARAMS,
    h100_chunk_params,
)
from repro_torch.core.mapreduce import MapReduceEngine, MapReduceProgram
from repro_torch.core.stats import (
    CountProgram,
    MeanProgram,
    VarianceProgram,
    MomentsProgram,
    HistogramProgram,
    FusedProgram,
    GroupedProgram,
    GroupedResult,
    CountMinProgram,
    HyperLogLogProgram,
    QuantileSketchProgram,
)
from repro_torch.core.query import indexed_query, naive_query, QueryStats
from repro_torch.core.plan import GridQuery, prefix_range
from repro_torch.core.blockstore import BlockStore, DeviceBlock, LRUCache
from repro_torch.core.grid import GridSession, RunReport, SessionMetrics
from repro_torch.core.frontend import (
    FrontendOverloadedError,
    FrontendStats,
    GridFrontend,
    QueryTimeoutError,
)

__all__ = [
    "GridSession", "RunReport", "SessionMetrics",
    "GridFrontend", "FrontendStats",
    "FrontendOverloadedError", "QueryTimeoutError",
    "TensorTable", "ColumnFamily", "ColumnSpec",
    "Region", "RegionSet", "ConstantSizeSplitPolicy", "HierarchicalSplitPolicy",
    "NodeSpec", "assign_new_regions", "balanced_allocation",
    "greedy_allocation", "central_allocation",
    "rebalance", "allocation_imbalance",
    "Placement",
    "ChunkModelParams", "ChunkModel", "PAPER_PARAMS", "TPU_V5E_PARAMS",
    "H100_PARAMS", "h100_chunk_params",
    "MapReduceEngine", "MapReduceProgram",
    "CountProgram", "MeanProgram", "VarianceProgram", "MomentsProgram",
    "HistogramProgram", "FusedProgram", "GroupedProgram", "GroupedResult",
    "CountMinProgram", "HyperLogLogProgram", "QuantileSketchProgram",
    "indexed_query", "naive_query", "QueryStats",
    "GridQuery", "prefix_range",
    "BlockStore", "DeviceBlock", "LRUCache",
]
