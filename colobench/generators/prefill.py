"""Prefill cells: requests arrive in an open loop on a schedule drawn from
the seed, and one server sends each, in order of arrival, to
``ServeEngine.generate(prompt, 1)`` (the engine's prefill over
``LM.prefill``, its caches grown to the engine's capacity, the first
token on the host).  The engine takes a batch of equal-length prompts
only, so each call serves one request.  A request's time to first token
runs from its arrival to its token on the host, its wait in the queue
included.

Traffic file (``kind: prefill``):

- ``lengths``: a lognormal law of prompt lengths (``median``, ``sigma``,
  clipped to ``[min, max]``, rounded up to a ``multiple``), taken as its
  ``points`` quantiles at (j + 1/2) / points;
- ``arrivals``: Poisson arrivals at ``rate_per_s``, taken as the same
  number of quantiles of the exponential law, scaled to the rate's mean
  gap exactly;
- ``check_requests``: requests compared with the reference after the
  window.

Every seed gets the same lengths and gaps: round ``r`` (requests
``r * points ..``) takes a permutation of each drawn from the seed, or
from the file's ``schedule_seed`` where it has one (a fixed schedule,
replayed alike by every run: where the order of arrivals moves the
metric, as a tail's queueing does), so every window holds each length
in near-equal share.  Prompt ids are uniform over the vocabulary, drawn
from the seed; each length has ``POOL`` prompts, taken in turn.  Every request that arrives before the window closes is served;
the window ends with the last of them.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from colobench.lib import device as dev
from colobench.lib import stats
from colobench.lib.check import Numbers, judge, passed
from colobench.lib.model import family, make_weights, model_config
from colobench.lib.trace import CALL, Reading, span, traced

#: distinct prompts drawn for each length
POOL = 4


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2**64 - 1), *keys])


def quantile_lengths(law: Dict) -> List[int]:
    """The ``points`` quantiles of the lognormal law, clipped and rounded
    up to the multiple, in ascending order."""
    n, m = law["points"], law["multiple"]
    out = []
    for j in range(n):
        z = statistics.NormalDist().inv_cdf((j + 0.5) / n)
        L = law["median"] * math.exp(law["sigma"] * z)
        L = min(max(L, law["min"]), law["max"])
        out.append(int(-(-math.ceil(L) // m) * m))
    return out


def quantile_gaps(rate: float, n: int) -> List[float]:
    """``n`` quantiles of the exponential law of mean ``1 / rate``, scaled
    so that their mean is ``1 / rate`` exactly."""
    g = [-math.log(1.0 - (j + 0.5) / n) for j in range(n)]
    scale = n / (rate * sum(g))
    return [x * scale for x in g]


class Traffic:
    """The requests of one seed: request ``i``'s length, arrival and
    prompt."""

    def __init__(self, t: Dict, vocab: int, seed: int):
        self.lengths = quantile_lengths(t["lengths"])
        self.n = len(self.lengths)
        self.rate = t["arrivals"]["rate_per_s"]
        self.gaps = quantile_gaps(self.rate, self.n)
        self.seed = seed
        # a fixed schedule replays the same order in every run
        self.schedule_seed = t.get("schedule_seed", seed)
        self.check_requests = t["check_requests"]
        self.vocab = vocab
        self._rounds: Dict[int, Tuple[List[int], List[float]]] = {}
        self._arrivals = [0.0]
        self._prompts: Dict[Tuple[int, int], np.ndarray] = {}

    def _round(self, r: int) -> Tuple[List[int], List[float]]:
        if r not in self._rounds:
            rng = _rng(self.schedule_seed, 0, r)
            self._rounds[r] = (
                [self.lengths[j] for j in rng.permutation(self.n)],
                [self.gaps[j] for j in rng.permutation(self.n)])
        return self._rounds[r]

    def length(self, i: int) -> int:
        return self._round(i // self.n)[0][i % self.n]

    def arrival(self, i: int) -> float:
        """Seconds from the window's start to request ``i``'s arrival (the
        first arrives at 0)."""
        while len(self._arrivals) <= i:
            k = len(self._arrivals)
            j = k - 1               # the gap that follows request k - 1
            self._arrivals.append(self._arrivals[-1]
                                  + self._round(j // self.n)[1][j % self.n])
        return self._arrivals[i]

    def arrived_by(self, seconds: float) -> int:
        """The number of requests that arrive within ``seconds``."""
        i = 0
        while self.arrival(i) < seconds:
            i += 1
        return i

    def prompt_of(self, L: int, k: int) -> np.ndarray:
        """The ``k``-th prompt of length ``L``, ``[1, L]``."""
        key = (L, k % POOL)
        if key not in self._prompts:
            self._prompts[key] = _rng(self.seed, 1, L, k % POOL).integers(
                0, self.vocab, (1, L), dtype=np.int32)
        return self._prompts[key]

    def prompt(self, i: int) -> np.ndarray:
        return self.prompt_of(self.length(i), i // self.n)

    def sample(self, n_requests: int) -> List[int]:
        """``check_requests`` distinct requests of the first
        ``n_requests``, drawn from the seed, one of them of the longest
        length among those."""
        rng = _rng(self.seed, 2)
        top = max(self.length(i) for i in range(n_requests))
        longest = [i for i in range(n_requests) if self.length(i) == top]
        first = int(rng.choice(longest))
        rest = [i for i in range(n_requests) if i != first]
        k = min(self.check_requests - 1, len(rest))
        return sorted([first] + [int(x) for x in
                                 rng.choice(rest, k, replace=False)])


class _Capture:
    """The engine's model, keeping the prefill outputs of the requests
    that the check will read."""

    def __init__(self, model):
        self.inner = model
        self.keep = False
        self.kept: Optional[Tuple] = None

    def prefill(self, params, tokens):
        logits, caches = self.inner.prefill(params, tokens)
        if self.keep:
            self.kept = (logits, caches)
        return logits, caches

    def __getattr__(self, name):
        return getattr(self.inner, name)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        log) -> Dict:
    from repro_torch.serve.engine import ServeEngine

    c, t = cell.config, cell.traffic
    cfg = model_config(c)
    fam = family(c)
    times: Dict[str, float] = {}
    ts = time.perf_counter()
    weights = make_weights(cfg, seed, device, fam)
    traffic = Traffic(t, cfg.vocab, seed)
    # caches grown to the longest prompt and its one new token, as a
    # deployment sizes them for its traffic
    engine = ServeEngine(cfg, weights, capacity=max(traffic.lengths) + 1,
                         batch_size=1, device=device)
    cap = _Capture(engine.model)
    engine.model = cap
    dev.sync(device)
    times["weights_and_engine"] = time.perf_counter() - ts

    def call(p):
        return int(engine.generate(p, 1).tokens[0, 0])

    ts = time.perf_counter()
    for L in sorted(set(traffic.lengths)):      # every shape once
        call(traffic.prompt_of(L, 0))
    times["warmup"] = time.perf_counter() - ts
    # the traced stretch is the first round; the window holds every
    # request that arrives before it closes
    n_req = traffic.n if trace else max(traffic.n,
                                        traffic.arrived_by(seconds))
    sample = traffic.sample(n_req)
    gc.collect()
    dev.reset_peak(device)

    served: Dict[int, int] = {}
    kept: Dict[int, Tuple] = {}
    done: List[Tuple[float, float, float, int]] = []

    def serve_all():
        start = time.perf_counter()
        for i in range(n_req):
            due = start + traffic.arrival(i)
            while time.perf_counter() < due:   # a spin: no sleep between
                pass                            # calls clocks the core down
            cap.keep = i in sample
            p = traffic.prompt(i)
            a = time.perf_counter()
            with span(CALL):
                served[i] = call(p)
            done.append((due, a, time.perf_counter(), traffic.length(i)))
            if cap.keep:
                kept[i], cap.kept, cap.keep = cap.kept, None, False
        return start

    setup_s = time.perf_counter() - t0
    gc_s: List[float] = []
    gc_at: Dict[str, float] = {}

    def gc_clock(phase, info):
        if phase == "start":
            gc_at["t"] = time.perf_counter()
        elif "t" in gc_at:
            gc_s.append(time.perf_counter() - gc_at.pop("t"))

    gc.callbacks.append(gc_clock)
    reading = None
    if trace:
        tr = traced(serve_all, lambda: dev.sync(device))
        reading = Reading(tr, c, fam, [(1, L) for *_, L in done], "prefill")
        log(f"traced stretch: {len(done)} requests, {len(tr.records)} "
            f"device records, window {tr.window_s:.6f} s, busy "
            f"{tr.busy_s:.6f} s")
        start = done[0][0]
    else:
        start = serve_all()
    gc.callbacks.remove(gc_clock)
    peak = dev.peak_bytes(device)
    window_s = done[-1][2] - start
    ttft = [e - due for due, _, e, _ in done]
    queued = [a - due for due, a, _, _ in done]
    busy = sum(e - a for _, a, e, _ in done)
    log(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in times.items())}); "
        f"window {window_s:.3f} s, {len(done)} requests at "
        f"{traffic.rate} a second, server busy {busy / window_s:.4f} of it, "
        f"queue wait median {statistics.median(queued):.4f} s max "
        f"{max(queued):.4f} s, memory peak {peak} bytes; "
        f"{len(gc_s)} garbage collections, {sum(gc_s):.4f} s")

    # the program's state goes before the reference runs; the weights are
    # the benchmark's input and stay
    del engine, cap
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference()
    view = fam.layer_view(cfg, weights)
    nums = Numbers()
    tc = time.perf_counter()
    for i in sorted(kept):
        logits, caches = kept.pop(i)
        diag: List[Dict] = []
        tokens = torch.as_tensor(traffic.prompt(i), dtype=torch.int64,
                                 device=device)
        r_logits, r_caches = ref.prefill(c, view, tokens, diag=diag)
        nums.add(r_logits, r_caches, logits,
                 fam.cache_view(cfg, caches, tokens.shape[1]), [served[i]],
                 diag)
        del logits, caches, r_logits, r_caches
    values = nums.values()
    checks = judge(values, cell.limits)
    ok = passed(checks)
    log(f"check: {len(sample)} requests ({sample}), "
        f"{time.perf_counter() - tc:.3f} s; {nums.describe()}; {values}")

    out = {"correct": ok, "attempted": len(done),
           "failed": 0 if ok else len(sample), "checks": checks,
           "values": values,
           "peak": peak, "setup_s": setup_s, "reading": reading}
    out["e2e"] = {
        "prefill_tok_s": stats.rate(sum(L for *_, L in done), window_s),
        "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
        "setup_s": setup_s}
    return out
