"""GridQuery — lazy scan→filter→map→reduce job plans over the grid.

Port of ``src/repro/core/plan.py`` (host-only, copied).

The paper's criterion (3) is a rowkey/table scheme for *rapid* NoSQL query;
eager one-shot calls (``indexed_query``, ``GridSession.run_where``) could push
the predicate into the gather but still visited every region.  ``GridQuery``
makes the query a *plan*: nothing is scanned, gathered, or compiled until
``.collect()``/``.stats()``, which gives the planner room for three pushdowns
before any bytes move:

1. **Region pruning** — a rowkey prefix/range resolves against the region
   start keys (:meth:`RegionSet.prune`, two bisects), so regions outside the
   scan range are never scanned and their device blocks never gathered.
   ``QueryStats.regions_scanned``/``regions_pruned`` report the efficacy.
2. **Projection pushdown** — only the selected columns enter the device
   layout; index families are read exclusively by the predicate (and the
   ``group_by`` key column).
3. **Program fusion** — every ``.map(program)`` statistic joins one
   :class:`~repro_torch.core.stats.FusedProgram`, so mean+variance+histogram run in
   a single engine pass over a single gather, sharing one compiled
   executable per block shape and one result-cache entry.  Members that
   declare shared accumulators (``requires()``) are CSE'd: count and the
   raw power sums fold once per chunk, however many statistics project from
   them.  With ``.select([c1, c2])`` the fused stack folds over EACH
   selected column; with ``.group_by(key)`` every block folds group-keyed
   partials (segment-summed by group id) and results come back per group.

Build plans through :meth:`GridSession.scan`::

    q = (session.scan(prefix=b"site-a/")
                .select("img:data")
                .where(age_sex_predicate(20, 40, 1), ["age", "sex"])
                .map(MeanProgram())
                .map(VarianceProgram())
                .reduce())
    (mean, var), report = q.collect()
    print(report.query.regions_pruned, "regions never touched")

Builder methods are pure — each returns a new plan, so a scan can be reused
as the base of several queries.  Results are memoized per (η, epoch) on the
plan object; across plan objects the session's content-addressed result and
partial caches make an equivalent re-execution fold zero payload rows.
"""

from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple, Union,
)

from repro_torch.core.mapreduce import MapReduceProgram
from repro_torch.core.query import Predicate
from repro_torch.core.table import RowKey, _as_key

if TYPE_CHECKING:  # import cycle: grid builds plans, plans execute on grid
    from repro_torch.core.grid import GridSession, RunReport


def prefix_range(prefix: RowKey) -> Tuple[bytes, Optional[bytes]]:
    """The half-open rowkey range ``[start, stop)`` matching a key prefix.

    ``stop`` is the prefix with its last non-``0xff`` byte incremented
    (trailing ``0xff`` bytes stripped first — ``b"a\\xff"`` rolls over to
    ``b"b"``); an empty or all-``0xff`` prefix has no upper bound (None,
    the keyspace's +inf sentinel).
    """
    p = _as_key(prefix)
    trimmed = p.rstrip(b"\xff")
    if not trimmed:
        return p, None
    stop = trimmed[:-1] + bytes([trimmed[-1] + 1])
    return p, stop


ColumnRef = Union[str, Tuple[str, str]]


def _parse_column(col: ColumnRef) -> Tuple[str, str]:
    """Accept ``"family:qualifier"`` or ``(family, qualifier)``."""
    if isinstance(col, str):
        fam, sep, qual = col.partition(":")
        if not sep or not fam or not qual:
            raise ValueError(
                f"column {col!r} must be 'family:qualifier' or a tuple")
        return fam, qual
    fam, qual = col
    return str(fam), str(qual)


@dataclasses.dataclass
class GridQuery:
    """One lazy scan→select→where→map→reduce plan bound to a session.

    Immutable by convention: builder methods return a *new* plan (the memo
    is dropped), so plans compose and fork freely.  Execution happens only
    in :meth:`collect`/:meth:`stats`, via the session's planner, which owns
    the pushdowns and the compiled-plan cache.
    """

    session: "GridSession"
    start: Optional[bytes] = None          # scan range, half-open
    stop: Optional[bytes] = None
    prefix: Optional[bytes] = None         # provenance only; folded into range
    columns: Tuple[Tuple[str, str], ...] = ()   # projection; () = payload col
    predicate: Optional[Predicate] = None
    index_qualifiers: Tuple[str, ...] = ()
    programs: Tuple[MapReduceProgram, ...] = ()
    # stratification columns: tuple of (family, qualifier), in key order
    group_key: Optional[Tuple[Tuple[str, str], ...]] = None
    # (eta, epoch) -> (results, report); dropped by every builder call
    _memo: Dict[Tuple[int, int], Tuple[Any, "RunReport"]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------------
    # builders (each returns a fresh plan)
    # ------------------------------------------------------------------

    def _fork(self, **changes) -> "GridQuery":
        changes.setdefault("_memo", {})
        return dataclasses.replace(self, **changes)

    def select(self, *columns) -> "GridQuery":
        """Projection pushdown: only these columns enter the layout.

        Accepts ``"family:qualifier"`` strings, ``(family, qualifier)``
        tuples, or a *list* of either to select several columns at once
        (``select(["img:data", "idx:age"])`` ≡ ``select("img:data",
        "idx:age")``).  Compute plans (any ``.map``) fold every mapped
        program over EACH selected column in one pass; plain ``.collect()``
        retrieves every selected column.  Default (no ``select``) is the
        session's payload column.
        """
        cols = []
        for c in columns:
            if isinstance(c, list):
                cols.extend(_parse_column(x) for x in c)
            else:
                cols.append(_parse_column(c))
        return self._fork(columns=tuple(cols))

    def group_by(self, column) -> "GridQuery":
        """Stratify every mapped statistic by one or more scalar key columns.

        ``column`` is a single column ref (e.g. ``"idx:site"``) or a *list*
        of refs for a composite key (``group_by(["idx:site",
        "idx:scanner"])``).  Key columns are read like index columns — a
        few bytes per row, never the payload.  Execution densifies the
        (combined) key to one dense group id per selected row, the
        per-block folds segment-sum group-keyed partials in the same single
        pass, and results come back as one
        :class:`~repro_torch.core.stats.GroupedResult` per computed column.
        Single-column keys label groups with scalar key values; composite
        keys with tuples, ordered lexicographically by the listed columns
        (so ``["idx:site", "idx:scanner"]`` and ``["idx:scanner",
        "idx:site"]`` are distinct groupings with distinct cache
        identities).
        """
        if self.group_key is not None:
            raise ValueError("plan already grouped; pass the composite key "
                             "as one group_by([...]) list instead")
        cols = column if isinstance(column, list) else [column]
        if not cols:
            raise ValueError("group_by needs at least one key column")
        parsed = tuple(_parse_column(c) for c in cols)
        if len(set(parsed)) != len(parsed):
            raise ValueError(f"duplicate group_by key columns in {parsed}")
        return self._fork(group_key=parsed)

    def where(self, predicate: Predicate,
              index_qualifiers: Sequence[str]) -> "GridQuery":
        """Filter pushdown: ``predicate`` over the index family only."""
        if self.predicate is not None:
            raise ValueError("plan already has a predicate; compose them "
                             "into one callable instead")
        return self._fork(predicate=predicate,
                          index_qualifiers=tuple(index_qualifiers))

    def map(self, program: MapReduceProgram) -> "GridQuery":
        """Add a statistic; all mapped programs fuse into ONE engine pass."""
        return self._fork(programs=self.programs + (program,))

    def reduce(self) -> "GridQuery":
        """Finalize the plan (the programs are monoid folds, so the reduce
        is implied by their ``merge``/``finalize``; kept for call-site
        symmetry with the paper's map→reduce verbs).  Still lazy."""
        if not self.programs:
            raise ValueError("reduce() needs at least one map(program)")
        return self

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def collect(self, eta: Optional[int] = None) -> Tuple[Any, "RunReport"]:
        """Compile + execute the plan; returns ``(results, RunReport)``.

        With programs, ``results`` follows map order (a bare value for a
        single program, a tuple for a fused set); grouped plans wrap each
        column's results in a :class:`~repro_torch.core.stats.GroupedResult`, and
        multi-column compute plans return ``{"fam:qual": per-column
        results}``.  Without programs this is a pruned retrieve:
        ``results = (rowkeys, {"fam:qual": values})``.
        """
        eta_key = int(eta or self.session.default_eta)
        memo_key = (eta_key, self.session.epoch)
        if memo_key not in self._memo:
            self._memo.clear()      # stale epochs/etas have no consumers
            self._memo[memo_key] = self.session._execute_plan(self, eta=eta)
        return self._memo[memo_key]

    def stats(self, eta: Optional[int] = None) -> "RunReport":
        """Execute (memoized) and return just the accounting report."""
        _, report = self.collect(eta=eta)
        return report

    def explain(self) -> str:
        """Describe the physical plan WITHOUT moving bytes or compiling."""
        regions = self.session.table.regions
        pruned = regions.prune(self.start, self.stop)
        lo, hi = self.session.table.row_range(self.start, self.stop)
        cols = self.resolved_columns()
        lines = [
            f"GridQuery(epoch={self.session.epoch})",
            f"  scan    [{self.start!r}, {self.stop!r}) -> rows {lo}:{hi}, "
            f"regions {len(pruned)}/{len(regions)} "
            f"({len(regions) - len(pruned)} pruned)",
            f"  select  {', '.join(f'{f}:{q}' for f, q in cols)}",
            f"  where   {self.predicate!r} over idx{list(self.index_qualifiers)}"
            if self.predicate is not None else "  where   -",
            f"  group   "
            f"{', '.join(f'{f}:{q}' for f, q in self.group_key)}"
            if self.group_key is not None else "  group   -",
            f"  map     {len(self.programs)} program(s) fused: "
            f"{[type(p).__name__ for p in self.programs]}"
            f"{' x ' + str(len(cols)) + ' columns' if len(cols) > 1 else ''}"
            if self.programs else "  map     - (retrieve)",
        ]
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # planner-facing helpers
    # ------------------------------------------------------------------

    def signature(self) -> Tuple:
        """Hashable identity of the plan's semantics — scan range,
        projection, predicate, fused program stack, grouping.  The
        frontend's single-flight registry keys on ``(signature, epoch)``
        to collapse concurrent identical queries into one execution.

        Predicates are callables compared by identity: two plans share a
        signature only when they share the predicate *object* (forks of
        one base scan, or one module-level predicate reused across
        clients) — exactly the repeat-query shape coalescing targets.
        The signature tuple holds a reference to the predicate, so an
        entry retained in a registry keeps its identity stable.
        """
        return (
            self.start, self.stop, self.resolved_columns(),
            self.predicate, self.index_qualifiers,
            tuple(p.cache_key() for p in self.programs),
            self.group_key,
        )

    def batch_signature(self) -> Tuple:
        """The plan signature *minus the program stack*.  Plans sharing
        this scan the same rows of the same columns under the same
        grouping, so their programs can fuse into one device pass per
        scheduler tick; results split back per plan by program count."""
        return (
            self.start, self.stop, self.resolved_columns(),
            self.predicate, self.index_qualifiers, self.group_key,
        )

    def resolved_columns(self) -> Tuple[Tuple[str, str], ...]:
        if self.columns:
            return self.columns
        return ((self.session.payload_family, self.session.payload_qualifier),)

    def compute_columns(self) -> Tuple[Tuple[str, str], ...]:
        """The columns a compute plan folds over (≥1; duplicates rejected —
        each column carries its own program stack in the one pass)."""
        cols = self.resolved_columns()
        if len(set(cols)) != len(cols):
            raise ValueError(f"duplicate compute columns in {cols}")
        return cols

    def compute_column(self) -> Tuple[str, str]:
        """Back-compat accessor for single-column compute plans."""
        cols = self.compute_columns()
        if len(cols) != 1:
            raise ValueError(
                f"compute plans fold over exactly one column, got {cols}")
        return cols[0]
