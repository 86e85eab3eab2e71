"""The paper's chunk-size model — eq. (1)-(8) of §2.2, faithfully.

Port of ``src/repro/core/chunk_model.py`` (host-only, copied).  It adds
:data:`SMEM_BYTES` and :func:`h100_chunk_params` beside the TPU constants.

Predicts wall-clock time (what the user experiences) and resource time
(Σ busy time across nodes) for a MapReduce summary-statistic job as a function
of the map-task chunk size η (images per map task), and finds the optimal η
inside the validity window

    η ∈ [ max(#img·SizeSmall/mem, #img/core),  mem/SizeBig ]          (paper §2.2)

(lower bound: one map round across all cores + reduce-phase memory; upper
bound: a chunk must fit in one machine's memory).

Two parameterizations ship:

- :data:`PAPER_PARAMS` — the paper's cluster (§2.4: 70 MB/s network, 100/65
  MB/s disk R/W, 224 cores, SizeBig/Small/Gen = 20/6/21 MB, 5,153 images,
  ``avgANTS(η) = 0.4η + 5`` s).  With these constants the model reproduces the
  reported optimum η* in [50, 60] and the Fig. 4C/D trends.
- :data:`TPU_V5E_PARAMS` — the TPU translation: disk→HBM (819 GB/s), network→
  ICI (~50 GB/s/link), machine→chip (16 GB HBM); the compute kernel is
  memory-bound streaming mean rather than ANTS.  This drives ColoGrid's chunk
  auto-tuner at runtime.

Notes on constants the paper leaves implicit:

- ``alpha`` (unbuffered-map-output ratio) is never given a value; we default
  to 0.25, which places the predicted optimum at η*≈59, inside the reported
  [50, 60] band (any α∈[0,0.6] keeps η*∈[56,63] — the model is flat there).
- ``mem`` is set to 3.2 GB so that the upper bound mem/SizeBig equals the 160
  the paper assesses (their "4 GB per job" is a scheduler grant, not the
  model's machine memory).
- ``wt_init + wt_end`` (MapReduce job setup/teardown) defaults to 30 s, the
  Hadoop-typical overhead visible as the Fig. 3 intercept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

MB = 1e6
GB = 1e9

#: Per-core VMEM of the TPU translation (~16 MB of on-chip vector memory
#: feeding the compute units).  The fused fold kernel sizes its grouped
#: accumulator pool against a fraction of this — the G threshold above
#: which the reference engine falls back to the XLA fold (see
#: ``repro.kernels.fused_fold.ops.max_groups_for_vmem``).
VMEM_BYTES = 16 * MB

#: Dynamic shared memory one thread block may claim on an NVIDIA H100
#: (232,448 bytes of the SM's 256 KB, per NVIDIA's Hopper documentation).  The
#: CUDA fused fold keeps its per-group accumulators there, so this bounds
#: the G above which the engine folds with plain PyTorch instead (see
#: ``repro_torch.kernels.fused_fold.ops.max_groups_for_smem``).
SMEM_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class ChunkModelParams:
    """Table 2 of the paper, as a value type.  Sizes in bytes, rates in B/s."""

    n_img: int                    # #img
    size_big: float               # SizeBig  — max input file size (worst case)
    size_small: float             # SizeSmall — min input file size (η bounds)
    size_gen: float               # SizeGen  — max intermediate/output size
    bandwidth: float              # cluster network bandwidth
    v_disc_r: float               # local disk read B/s
    v_disc_w: float               # local disk write B/s
    mem: float                    # memory of one machine
    core: int                     # total CPU cores of the cluster
    alpha: float = 0.25           # unbuffered ratio of map outputs (spilled)
    beta: float = 0.9             # rack-local (network-loaded) map-task ratio
    wt_init: float = 15.0         # job initialization (s)
    wt_end: float = 15.0          # job conclusion (s)
    # avg_fn(η) — seconds to average η images on one core.  The paper's
    # empirical worst case for ANTS AverageImages is 0.4η + 5.
    avg_fn: Callable[[float], float] = lambda eta: 0.4 * eta + 5.0

    # -- helper functions of Table 2 ------------------------------------

    def disc_r(self, x: float) -> float:
        return x / self.v_disc_r

    def disc_w(self, x: float) -> float:
        return x / self.v_disc_w

    def bdw(self, x: float) -> float:
        return x / self.bandwidth


class ChunkModel:
    """Evaluates eq. (1)-(8) and optimizes η."""

    def __init__(self, params: ChunkModelParams):
        self.p = params

    # ------------------------------------------------------------------
    # validity window (§2.2)
    # ------------------------------------------------------------------

    def eta_bounds(self) -> Tuple[int, int]:
        p = self.p
        lo = max(p.n_img * p.size_small / p.mem, p.n_img / p.core)
        hi = p.mem / p.size_big
        lo_i, hi_i = int(math.ceil(lo)), int(math.floor(hi))
        if lo_i > hi_i:
            raise ValueError(
                f"empty η window [{lo:.1f}, {hi:.1f}] — cluster cannot run "
                f"this dataset in one wave; add nodes or memory"
            )
        return lo_i, hi_i

    # ------------------------------------------------------------------
    # wall-clock time, eq. (1)-(4)
    # ------------------------------------------------------------------

    def wall_time(self, eta: int) -> Dict[str, float]:
        p = self.p
        n_job = p.n_img // eta                       # ⌊#img/η⌋ as in the paper

        # eq. (2): the longest map task (worst case: all-big-image chunk;
        # read local, possibly network-loaded, write intermediate, compute)
        wt_map = (
            p.disc_r(p.size_big * eta)
            + p.bdw(p.size_big * eta)
            + p.disc_w(p.size_big * eta)
            + p.avg_fn(eta)
        )
        # eq. (3): worst-case shuffle — unbuffered outputs from disk, over
        # the wire, spilled at the reducer
        wt_shuffle = (
            p.disc_r(p.size_gen)
            + p.bdw(p.alpha * n_job * p.size_gen)
            + p.disc_w(n_job * p.size_gen)
        )
        # eq. (4): reduce = average the #job intermediates + final I/O
        wt_reduce = p.avg_fn(n_job) + p.disc_r(p.size_gen) + p.disc_w(p.size_gen)

        total = p.wt_init + wt_map + wt_shuffle + wt_reduce + p.wt_end
        return {
            "init": p.wt_init, "map": wt_map, "shuffle": wt_shuffle,
            "reduce": wt_reduce, "end": p.wt_end, "total": total,
        }

    # ------------------------------------------------------------------
    # resource time, eq. (5)-(8)
    # ------------------------------------------------------------------

    def resource_time(self, eta: int) -> Dict[str, float]:
        p = self.p
        n_job = p.n_img // eta

        # eq. (6): every image read+written once somewhere, the β rack-local
        # fraction also crossing the network, plus all map computations
        rt_map = (
            p.disc_r(p.n_img * p.size_big)
            + p.disc_w(p.n_img * p.size_big)
            + p.bdw(p.beta * n_job * eta * p.size_big)
            + n_job * p.avg_fn(eta)
        )
        # eq. (7): spills on both sides + full intermediate transfer + sink
        rt_shuffle = (
            p.alpha * n_job * (p.disc_w(p.size_gen) + p.disc_r(p.size_gen))
            + p.bdw(n_job * p.size_gen)
            + p.disc_w(n_job * p.size_gen)
        )
        # eq. (8) == eq. (4)
        rt_reduce = p.avg_fn(n_job) + p.disc_r(p.size_gen) + p.disc_w(p.size_gen)

        total = rt_map + rt_shuffle + rt_reduce
        return {
            "map": rt_map, "shuffle": rt_shuffle, "reduce": rt_reduce,
            "total": total,
        }

    # ------------------------------------------------------------------
    # optimizer
    # ------------------------------------------------------------------

    def optimal_eta(
        self,
        metric: str = "wall",
        step: int = 1,
        bounds: Optional[Tuple[int, int]] = None,
    ) -> Tuple[int, float]:
        """argmin over the validity window; returns ``(η*, predicted_time)``."""
        lo, hi = bounds if bounds is not None else self.eta_bounds()
        fn = self.wall_time if metric == "wall" else self.resource_time
        best_eta, best_t = lo, float("inf")
        for eta in range(lo, hi + 1, step):
            t = fn(eta)["total"]
            if t < best_t:
                best_eta, best_t = eta, t
        return best_eta, best_t

    def sweep(self, etas) -> Dict[int, Dict[str, float]]:
        return {
            int(e): {
                "wall": self.wall_time(int(e))["total"],
                "resource": self.resource_time(int(e))["total"],
            }
            for e in etas
        }


# ----------------------------------------------------------------------
# Shipped parameterizations
# ----------------------------------------------------------------------

#: The paper's cluster (§2.4) — reproduces Fig. 4C/D and η* ∈ [50, 60].
PAPER_PARAMS = ChunkModelParams(
    n_img=5153,
    size_big=20 * MB,
    size_small=6 * MB,
    size_gen=21 * MB,
    bandwidth=70 * MB,
    v_disc_r=100 * MB,
    v_disc_w=65 * MB,
    mem=3.2 * GB,                 # makes mem/SizeBig = 160, the paper's bound
    core=224,
)


def tpu_chunk_params(
    n_img: int,
    row_bytes: float,
    n_devices: int,
    hbm_bytes: float = 16 * GB,
    hbm_bw: float = 819e9,
    ici_bw: float = 50e9,
    flops: float = 197e12,
    disk_bw_r: Optional[float] = None,
    disk_bw_w: Optional[float] = None,
) -> ChunkModelParams:
    """TPU v5e translation of Table 2 (see DESIGN.md §2).

    disk → HBM, network → ICI, machine → chip.  The per-chunk compute is a
    memory-bound streaming mean: ``avg(η) ≈ η·row_bytes / HBM_bw`` plus a
    fixed kernel-dispatch overhead; the MXU term is negligible for adds.

    The spill term: ``alpha`` (the paper's unbuffered-output ratio) is the
    fraction of the dataset that does NOT fit in the fleet's stats budget
    (``mem × n_devices``) — 0 exactly when everything is resident, which is
    what the old hard-coded ``alpha=0.0`` silently assumed.  When the
    spilled fraction is nonzero, reads/writes of spilled data go to real
    disk, so ``v_disc_r/w`` become the harmonic blend of HBM and disk
    bandwidth weighted by the spilled fraction (``disk_bw_r/w`` default to
    HBM speed for backwards compatibility, i.e. an infinitely fast spill
    device).
    """
    dispatch = 5e-6  # per-chunk kernel launch/loop overhead (s)

    def avg_fn(eta: float) -> float:
        return eta * row_bytes / hbm_bw + dispatch

    mem = hbm_bytes * 0.5         # stats may only claim half of HBM
    dataset = float(n_img) * float(row_bytes)
    capacity = mem * n_devices
    spilled = 0.0 if dataset <= 0 else max(0.0, 1.0 - capacity / dataset)

    def _blend(disk_bw: Optional[float]) -> float:
        if disk_bw is None or spilled <= 0.0:
            return hbm_bw
        return 1.0 / ((1.0 - spilled) / hbm_bw + spilled / disk_bw)

    return ChunkModelParams(
        n_img=n_img,
        size_big=row_bytes,
        size_small=row_bytes,
        size_gen=row_bytes,
        bandwidth=ici_bw,
        v_disc_r=_blend(disk_bw_r),
        v_disc_w=_blend(disk_bw_w if disk_bw_w is not None else disk_bw_r),
        mem=mem,
        core=n_devices,
        alpha=spilled,            # real spill term: the non-resident fraction
        beta=0.0,                 # colocated: no network loads in map
        wt_init=1e-3,             # dispatch, not a JVM job launch
        wt_end=1e-3,
        avg_fn=avg_fn,
    )


# ----------------------------------------------------------------------
# Tier-placement cost oracle (BlockStore device → host → disk chain)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TierCostModel:
    """Cost oracle for the BlockStore's tier chain: should an evicted
    payload be demoted to the next tier, or dropped and re-derived later?

    Three re-acquisition paths compete, all in seconds per access:

    - **disk read** — ``nbytes / disk_bw_r`` (an mmap'd ``.npy`` page-in);
      paying ``nbytes / disk_bw_w`` once up front to write the spill file;
    - **re-fetch** — re-reading the content from the backing table, which
      in the paper's grid crosses the storage fabric: ``nbytes /
      refetch_bw`` (the paper's 70 MB/s cluster network by default);
    - **re-fold** — for partials: stream the whole source block again at
      ``fold_bw`` plus a dispatch overhead (and re-acquire the block first
      if it, too, was evicted).

    Rates default to the paper's cluster (§2.4) for the fabric and a
    commodity local SSD for spill; sessions built from
    :func:`tpu_chunk_params` pass their own.
    """

    disk_bw_r: float = 300 * MB    # local spill-file read (mmap page-in)
    disk_bw_w: float = 200 * MB    # local spill-file write
    refetch_bw: float = 70 * MB    # backing-table re-read (paper's network)
    fold_bw: float = 819e9         # fold streaming rate (HBM-bound compute)
    fold_overhead: float = 5e-6    # per-fold kernel dispatch (s)
    # fault-adjusted re-fetch: on a lossy fabric a table re-read is not
    # one transfer but an expected-attempts multiple of it (a capped
    # geometric: each attempt independently fails with this probability
    # and is retried up to ``max_refetch_attempts`` times), plus the
    # retry policy's mean backoff between attempts.  Defaults keep the
    # fault-free arithmetic bit-identical.
    refetch_fault_rate: float = 0.0   # per-attempt failure probability
    retry_backoff_s: float = 0.0      # mean sleep between attempts (s)
    max_refetch_attempts: int = 3

    def disk_read_s(self, nbytes: int) -> float:
        return nbytes / self.disk_bw_r

    def disk_write_s(self, nbytes: int) -> float:
        return nbytes / self.disk_bw_w

    def refetch_s(self, nbytes: int) -> float:
        return nbytes / self.refetch_bw

    def expected_attempts(self) -> float:
        """Mean number of table-read attempts under the fault rate: the
        expectation of a geometric capped at ``max_refetch_attempts``,
        ``(1 - p^k) / (1 - p)``.  Exactly 1.0 when the rate is zero."""
        p = min(max(self.refetch_fault_rate, 0.0), 0.999999)
        if p <= 0.0:
            return 1.0
        return (1.0 - p ** self.max_refetch_attempts) / (1.0 - p)

    def expected_refetch_s(self, nbytes: int) -> float:
        """Fault-adjusted cost of re-deriving content from the table:
        expected attempts × transfer time, plus the backoff slept between
        the extra attempts.  Collapses to :meth:`refetch_s` fault-free."""
        n = self.expected_attempts()
        return n * self.refetch_s(nbytes) + (n - 1.0) * self.retry_backoff_s

    def refold_s(self, block_nbytes: int) -> float:
        """Re-deriving a lost partial: worst case re-acquires the source
        block over the fabric, then streams it through the fold."""
        return (self.expected_refetch_s(block_nbytes)
                + block_nbytes / self.fold_bw + self.fold_overhead)

    def should_spill_block(self, nbytes: int) -> bool:
        """Spill a host payload iff the write amortizes within two future
        accesses — i.e. ``write + read <= 2 × expected refetch``.  With
        default rates local disk beats the storage fabric, so blocks
        spill; a deployment whose table is faster than its scratch disk
        drops the payload and re-gathers instead.  A non-zero
        ``refetch_fault_rate`` inflates the re-fetch side, biasing
        placement toward the (checksummed, locally verifiable) spill
        tier exactly when the fabric is unreliable."""
        if nbytes <= 0:
            return False
        return (self.disk_write_s(nbytes) + self.disk_read_s(nbytes)
                <= 2.0 * self.expected_refetch_s(nbytes))

    def should_spill_partial(self, partial_nbytes: int,
                             block_nbytes: int) -> bool:
        """Spill an evicted partial iff its disk round-trip undercuts
        re-folding the source block (partials are tiny accumulators, so
        this is almost always a win)."""
        if partial_nbytes <= 0:
            return False
        return (self.disk_write_s(partial_nbytes)
                + self.disk_read_s(partial_nbytes)
                <= self.refold_s(max(block_nbytes, partial_nbytes)))

    @classmethod
    def from_params(cls, params: ChunkModelParams,
                    disk_bw_r: float = 300 * MB,
                    disk_bw_w: float = 200 * MB) -> "TierCostModel":
        """Derive the oracle from a chunk-model parameterization: the
        table re-read crosses ``params.bandwidth`` (network for the
        paper's cluster, ICI for the TPU translation); folds stream at the
        model's read rate."""
        return cls(disk_bw_r=disk_bw_r, disk_bw_w=disk_bw_w,
                   refetch_bw=params.bandwidth, fold_bw=params.v_disc_r)


#: A representative TPU parameterization (5,153 rows of 20 MB on 256 chips).
TPU_V5E_PARAMS = tpu_chunk_params(n_img=5153, row_bytes=20 * MB, n_devices=256)


def h100_chunk_params(
    n_img: int,
    row_bytes: float,
    n_devices: int,
    hbm_bytes: float = 80 * GB,
    hbm_bw: float = 3.35e12,
    nvlink_bw: float = 450e9,
    disk_bw_r: Optional[float] = None,
    disk_bw_w: Optional[float] = None,
) -> ChunkModelParams:
    """NVIDIA H100 SXM translation of Table 2, from spec-sheet constants
    (NVIDIA's H100 data sheet: 80 GB HBM3 at 3.35 TB/s, NVLink 900 GB/s
    total, i.e. 450 GB/s each way).  These are published peaks, not
    measurements; the mapping is the TPU one with HBM and NVLink in place
    of the v5e's HBM and ICI."""
    return tpu_chunk_params(
        n_img=n_img, row_bytes=row_bytes, n_devices=n_devices,
        hbm_bytes=hbm_bytes, hbm_bw=hbm_bw, ici_bw=nvlink_bw,
        disk_bw_r=disk_bw_r, disk_bw_w=disk_bw_w)


#: The paper's population on one H100 (4,490 subjects of one 91x109x91
#: float32 MNI152 2 mm volume each), spec-sheet constants.
H100_PARAMS = h100_chunk_params(n_img=4490, row_bytes=91 * 109 * 91 * 4,
                                n_devices=1)
