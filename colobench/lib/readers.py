"""The per-layer quantities of a traced prefill stretch.  Each metric file
(``colobench/metrics/<name>.py``) reads one of these; a quantity that
moves different end-to-end metrics in different cells has one file per
metric it moves (``mfu.ttft``, ``mfu.tok_s``).  Each returns None when
the trace holds nothing for it."""

from __future__ import annotations

from colobench.lib import kernels, work
from colobench.lib.trace import CALL


def _prefill(r) -> bool:
    return r.kind == "prefill" and bool(r.calls) and bool(r.trace.records)


def launches_per_call(r):
    """Device records (kernels, copies and sets) a prefill call: the
    launches that the engine and the model stack issue from the host for
    one request."""
    if not _prefill(r):
        return None
    return len(r.trace.records) / len(r.calls)


def other_ms(r):
    """Device milliseconds a call in kernels that are neither cuBLAS GEMMs,
    K2, K3 nor copies: the model stack's elementwise, norm, routing,
    dispatch and gather work."""
    if not _prefill(r):
        return None
    return 1e3 * r.trace.seconds_by_family().get("other", 0.0) / len(r.calls)


def matmul_ms(r):
    """Device milliseconds a call in cuBLAS's GEMMs (the projections, the
    router and the experts)."""
    if not _prefill(r):
        return None
    s = r.trace.seconds_by_family().get("matmul", 0.0)
    return 1e3 * s / len(r.calls) if s > 0 else None


def k2_roofline(r):
    """K2's share of its roofline: the least time its calls need at the
    card's peaks (bf16 operations of the causal, windowed pairs; q, k and
    v read and o written once) over the device time of K2's kernels."""
    if not _prefill(r):
        return None
    spent = sum(e - s for n, s, e in r.trace.records
                if kernels.family(n) == "k2")
    if spent <= 0:
        return None
    c = r.config
    per_call = r.family.attention_layers(c)
    least = sum(per_call * work.least_seconds(*work.k2_work(
        B, c["n_heads"], c["n_kv_heads"], S, work.head_dim(c),
        c.get("sliding_window") or 0)) for B, S in r.calls)
    return 100.0 * least / spent


def idle_share(r):
    """The share of the calls' time in which no operation ran on the
    device: 1 - the union of the device records within each call's host
    span over the spans' length.  The wait between calls for the next
    arrival is left out: it is the load's, not the host's."""
    if not _prefill(r):
        return None
    spans = r.trace.spans(CALL)
    length = sum(e - s for s, e in spans)
    if length <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_within(spans) / length)


def mfu(r):
    """Model FLOPs of the traced calls over the time they took (their host
    spans, the wait for arrivals left out) at the card's bf16 peak: 2 a
    weight a token through the layers, the head at each prompt's last
    position, and attention's score and value products (causal,
    windowed)."""
    if not _prefill(r):
        return None
    spent = sum(e - s for s, e in r.trace.spans(CALL))
    if spent <= 0:
        return None
    flops = sum(work.prefill_model_flops(r.config, r.family, B, S)
                for B, S in r.calls)
    return 100.0 * flops / (spent * work.PEAK_BF16_FLOPS)
