"""Deterministic fault injection + retry/backoff for the whole grid stack.

Port of ``src/repro/core/faults.py`` (host-only, copied).

The paper's premise is that the Hadoop/HBase substrate gives colocation
*plus* fault tolerance on a heterogeneous grid — tasks re-execute, region
servers fail over, corrupted files are re-read from replicas.  Our JAX
reproduction has no substrate underneath it, so this module supplies the
two halves the substrate provided:

1. :class:`FaultInjector` — a seeded, deterministic chaos harness.  A
   fault *plan* is a list of :class:`FaultRule`\\ s over named **sites**
   (the points where the stack touches something that can fail):

   ========================  ====================================================
   site                      where it fires
   ========================  ====================================================
   ``device_put``            :meth:`GridSession._put_block` host→device commits
   ``gather``                table reads feeding a block fetch
   ``fold``                  :meth:`MapReduceEngine.fold_block` dispatch
   ``spill_write``           BlockStore spill-file writes (blocks + partials)
   ``spill_read``            BlockStore spill-file reads (mmap / ``.npz``)
   ``dispatch``              :class:`GridFrontend` query-group dispatch
   ========================  ====================================================

   and **kinds**: ``transient`` (raises :class:`TransientFaultError` —
   retryable), ``device_lost`` (raises :class:`DeviceLostError` and marks
   the device permanently dead: every later fire against it re-raises),
   ``corrupt`` / ``truncate`` / ``delete`` (mangle the spill file at
   ``path`` — the CRC manifest detects it on read), and ``delay`` (a
   straggler sleep).  Rules fire by per-invocation probability (from one
   seeded PRNG, so a (seed, call-sequence) pair replays exactly) or at
   pinned invocation indices (``after``/``times``), and every fire is
   counted per site and kind.

2. :class:`RetryPolicy` — bounded attempts with exponential backoff and
   *deterministic* jitter (hash of (seed, key, attempt), not wall clock),
   so two runs of the same schedule sleep the same amounts and tests can
   assert exact retry counts.

Recovery semantics the rest of the stack builds on these primitives:
transient faults retry in place; permanent device loss quarantines the
owner and re-homes its regions through the balancer; lost or corrupt
spill files are dropped and losslessly re-derived from the table; the
frontend caps retries by the query deadline and surfaces the whole
attempt history as :class:`QueryFaultedError.chain`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Set, Tuple

# ----------------------------------------------------------------------
# sites and kinds
# ----------------------------------------------------------------------

SITE_DEVICE_PUT = "device_put"
SITE_GATHER = "gather"
SITE_FOLD = "fold"
SITE_SPILL_WRITE = "spill_write"
SITE_SPILL_READ = "spill_read"
SITE_DISPATCH = "dispatch"

SITES = frozenset({
    SITE_DEVICE_PUT, SITE_GATHER, SITE_FOLD,
    SITE_SPILL_WRITE, SITE_SPILL_READ, SITE_DISPATCH,
})

KIND_TRANSIENT = "transient"
KIND_DEVICE_LOST = "device_lost"
KIND_CORRUPT = "corrupt"
KIND_TRUNCATE = "truncate"
KIND_DELETE = "delete"
KIND_DELAY = "delay"

KINDS = frozenset({
    KIND_TRANSIENT, KIND_DEVICE_LOST, KIND_CORRUPT, KIND_TRUNCATE,
    KIND_DELETE, KIND_DELAY,
})

#: file-mangling kinds only make sense where a spill file is in play
_FILE_KINDS = frozenset({KIND_CORRUPT, KIND_TRUNCATE, KIND_DELETE})
_FILE_SITES = frozenset({SITE_SPILL_WRITE, SITE_SPILL_READ})


# ----------------------------------------------------------------------
# exceptions
# ----------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base class for injected (and detected) faults."""


class TransientFaultError(FaultError):
    """A retryable failure: the operation may succeed if repeated."""


class DeviceLostError(FaultError):
    """Permanent loss of one owner device; never retried in place —
    the session quarantines the device and re-homes its regions."""

    def __init__(self, device: Optional[int], message: str = ""):
        super().__init__(
            message or f"device {device} lost (permanent)")
        self.device = device


class SpillCorruptionError(FaultError):
    """A spill file failed its CRC manifest check (or vanished)."""

    def __init__(self, path: str, reason: str = "checksum mismatch"):
        super().__init__(f"corrupt spill file {path}: {reason}")
        self.path = path


class QueryFaultedError(RuntimeError):
    """A frontend query exhausted its retries (or hit an open circuit
    breaker).  ``chain`` carries the per-attempt fault history, oldest
    first, so callers can see *what* kept failing."""

    def __init__(self, message: str,
                 chain: Sequence[BaseException | str] = ()):
        super().__init__(message)
        self.chain: Tuple = tuple(chain)

    def describe(self) -> str:
        steps = "; ".join(
            e if isinstance(e, str) else f"{type(e).__name__}: {e}"
            for e in self.chain)
        return f"{self}: [{steps}]" if self.chain else str(self)


# ----------------------------------------------------------------------
# fault rules / injector
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault plan.

    A rule is eligible on an invocation of its ``site`` when the site's
    call count exceeds ``after``, the rule has fired fewer than ``times``
    times, and (for device-scoped rules) the context device matches; an
    eligible rule then fires with probability ``p`` drawn from the
    injector's single seeded PRNG.  ``p=1.0, after=N, times=1`` pins a
    fault to exactly the (N+1)-th invocation — the deterministic form the
    acceptance walks use for one-shot events like a permanent device
    loss.
    """

    site: str
    kind: str
    p: float = 1.0                 # per-eligible-invocation probability
    after: int = 0                 # skip the first `after` site calls
    times: Optional[int] = None    # max fires (None = unlimited)
    device: Optional[int] = None   # only fire for this device index
    delay_s: float = 0.0           # sleep length for kind="delay"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in _FILE_KINDS and self.site not in _FILE_SITES:
            raise ValueError(
                f"kind {self.kind!r} needs a spill site, got {self.site!r}")
        if self.kind == KIND_DEVICE_LOST and self.site in _FILE_SITES:
            raise ValueError("device_lost has no meaning at a spill site")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")


def _mangle_file(path: Optional[str], kind: str) -> bool:
    """Apply one file fault in place; False when there is nothing to hit
    (no path / file already gone) so the rule does not count a fire."""
    if not path or not os.path.exists(path):
        return False
    try:
        if kind == KIND_DELETE:
            os.unlink(path)
            return True
        size = os.path.getsize(path)
        if size == 0:
            return False
        if kind == KIND_TRUNCATE:
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
            return True
        # corrupt: XOR a span in the middle so headers usually survive
        # and the CRC — not a parse error — is what catches it
        with open(path, "r+b") as f:
            f.seek(size // 2)
            buf = f.read(min(8, size - size // 2))
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in buf))
        return True
    except OSError:
        return False


class FaultInjector:
    """Seeded, thread-safe fault firing over a plan of rules.

    Every instrumented operation calls :meth:`fire` with its site and
    context; matching rules raise, sleep, or mangle the spill file.  A
    permanent device loss is *sticky*: the device enters
    :attr:`lost_devices` and every later ``device_put``/``fold`` fire
    against it raises :class:`DeviceLostError` immediately, whatever the
    plan says — that is what "permanent" means.

    Determinism: one PRNG seeded at construction drives every
    probability draw under one lock, so a single-threaded run replays
    bit-for-bit from (seed, plan, call sequence).

    ``on_fire(site, kind)`` is an optional observer — the session wires
    it to the ``faults_injected`` stats counter.
    """

    def __init__(self, rules: Iterable[FaultRule] = (), seed: int = 0):
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self._rng = random.Random(int(seed))
        self._lock = threading.Lock()
        self._site_calls: Dict[str, int] = {}
        self._rule_fires: Dict[int, int] = {}
        self.counts: Dict[str, int] = {}       # "site:kind" -> fires
        self.faults_injected = 0
        self.lost_devices: Set[int] = set()
        self.on_fire: Optional[Callable[[str, str], None]] = None

    # ------------------------------------------------------------------

    def _record(self, site: str, kind: str) -> None:
        self.faults_injected += 1
        k = f"{site}:{kind}"
        self.counts[k] = self.counts.get(k, 0) + 1

    def site_calls(self, site: str) -> int:
        with self._lock:
            return self._site_calls.get(site, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def fire(self, site: str, *, device: Optional[int] = None,
             path: Optional[str] = None) -> None:
        """One instrumented operation passed this site; maybe fault it.

        Raising kinds (transient, device loss) propagate to the caller,
        which owns the retry/quarantine response.  File kinds mangle
        ``path`` in place and return normally — the CRC manifest turns
        them into detected corruption at read time.  ``delay`` sleeps
        outside the lock.
        """
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        fired = []
        sticky_lost = False
        with self._lock:
            n = self._site_calls.get(site, 0) + 1
            self._site_calls[site] = n
            if (device is not None and device in self.lost_devices
                    and site in (SITE_DEVICE_PUT, SITE_FOLD)):
                sticky_lost = True
                self._record(site, KIND_DEVICE_LOST)
            else:
                for i, r in enumerate(self.rules):
                    if r.site != site:
                        continue
                    if r.device is not None and r.device != device:
                        continue
                    if n <= r.after:
                        continue
                    if (r.times is not None
                            and self._rule_fires.get(i, 0) >= r.times):
                        continue
                    if r.p < 1.0 and self._rng.random() >= r.p:
                        continue
                    if r.kind in _FILE_KINDS:
                        # only counts when there was a file to hit
                        if not _mangle_file(path, r.kind):
                            continue
                    self._rule_fires[i] = self._rule_fires.get(i, 0) + 1
                    self._record(site, r.kind)
                    if r.kind == KIND_DEVICE_LOST and device is not None:
                        self.lost_devices.add(device)
                    fired.append(r)
        observer = self.on_fire
        if observer is not None:
            if sticky_lost:
                observer(site, KIND_DEVICE_LOST)
            for r in fired:
                observer(site, r.kind)
        if sticky_lost:
            raise DeviceLostError(device)
        # non-raising kinds first (a delay plus a transient on the same
        # call should still sleep), then raise the most severe
        raise_kind: Optional[FaultRule] = None
        for r in fired:
            if r.kind == KIND_DELAY:
                time.sleep(r.delay_s)
            elif r.kind in (KIND_TRANSIENT, KIND_DEVICE_LOST):
                if raise_kind is None or r.kind == KIND_DEVICE_LOST:
                    raise_kind = r
        if raise_kind is not None:
            if raise_kind.kind == KIND_DEVICE_LOST:
                raise DeviceLostError(device)
            raise TransientFaultError(
                f"injected transient fault at {site}"
                + (f" (device {device})" if device is not None else ""))


# ----------------------------------------------------------------------
# retry policy
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic jitter.

    ``delay_s(attempt, key)`` grows ``base_delay_s * multiplier**attempt``
    and perturbs it by up to ±``jitter`` — the perturbation is a hash of
    ``(seed, key, attempt)``, not a clock or a shared PRNG, so concurrent
    retriers de-synchronize (no thundering herd on the shared table)
    while any single schedule replays exactly.
    """

    max_attempts: int = 3
    base_delay_s: float = 1e-3
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def delay_s(self, attempt: int, key: str = "") -> float:
        base = self.base_delay_s * (self.multiplier ** attempt)
        if self.jitter <= 0.0:
            return base
        h = hashlib.blake2b(f"{self.seed}:{key}:{attempt}".encode(),
                            digest_size=8).digest()
        frac = int.from_bytes(h, "little") / float(1 << 64)   # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def call(self, fn: Callable[[], "object"], *, key: str = "",
             retry_on: Tuple[type, ...] = (TransientFaultError,),
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             sleep: Callable[[float], None] = time.sleep):
        """Run ``fn``, retrying on ``retry_on`` up to ``max_attempts``
        total attempts; ``on_retry(exc, attempt)`` observes each retry
        (the stack wires it to the ``retries`` counters).  The final
        failure propagates unwrapped — callers distinguish exhausted
        transients from permanent faults by exception type."""
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)
                sleep(self.delay_s(attempt - 1, key))
