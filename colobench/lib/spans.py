"""The per-layer quantities that read the program's own spans.

The program (``repro_torch``) names the layers of its prefill path as
profiler ranges while a profiler records (``repro_torch.tracing.span``;
the list is in ``repro_torch/serve/engine.py``'s docstring): names that
start with ``serve.``, ``model.``, ``attn.`` or ``moe.``.  They reach a
reader as ``Trace.host`` (each range's name, start and end on the
profiler's clock, the clock of the device records) and ``Trace.ranges``
(the device seconds of the kernels that the profiler links, by
correlation id, to the ops inside each named range, summed by name).
A metric file (``colobench/metrics/<name>.py``) imports one function of
this module as ``read``.  Each returns None when the trace holds no
program span, as a program without them gives, or no device record.

Two kinds of quantity:

- **Idle under a layer** (``*_idle_ms``): every stretch inside a
  request's ``serve.generate`` span in which no operation ran on the
  device, split over the innermost program spans it overlaps, summed by
  layer and divided by the calls.  Innermost means the program's: an
  ``aten::`` op inside ``moe.dispatch`` charges ``moe.dispatch``.  The
  four layers split the request's whole idle: ``serve.generate``'s own
  time (outside its children) is the engine's.
- **Device time launched under a layer** (``*_passes_ms``,
  ``norm_rope_ms``): the named entries of ``Trace.ranges`` divided by
  the calls.  This charges a kernel to the span that launched it, not
  the span open while it ran: when the host runs ahead of the card the
  two differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from colobench.lib.readers import _prefill
from colobench.lib.stats import gaps

#: the prefixes of the program's span names
PROGRAM = ("serve.", "model.", "attn.", "moe.")
#: the span of one request; every other span of the request nests in it
REQUEST = "serve.generate"
#: K2's host wrapper and launch
K2 = "attn.k2"

Span = Tuple[str, float, float]


def program_spans(trace) -> List[Span]:
    """The program's spans inside the stretch, by start."""
    lo, hi = trace.window
    return sorted(((n, s, e) for n, s, e in trace.host
                   if n.startswith(PROGRAM) and s >= lo and e <= hi),
                  key=lambda x: (x[1], -x[2]))


def innermost(spans: List[Span], lo: float, hi: float
              ) -> List[Tuple[float, float, Optional[str]]]:
    """``[lo, hi]`` cut into ``(start, end, name)`` pieces, each under
    one innermost span of the nested ``spans`` (sorted by start, longer
    first at a tie); None where none is open."""
    out: List[Tuple[float, float, Optional[str]]] = []
    open_: List[Tuple[float, str]] = []      # (end, name), outermost first
    at = lo

    def upto(t: float) -> None:
        nonlocal at
        t = min(t, hi)
        if t > at:
            out.append((at, t, open_[-1][1] if open_ else None))
            at = t

    for name, s, e in spans:
        while open_ and open_[-1][0] <= s:
            upto(open_[-1][0])
            open_.pop()
        upto(s)
        open_.append((e, name))
    while open_:
        upto(open_[-1][0])
        open_.pop()
    upto(hi)
    return out


def idle_by_span(trace) -> Dict[str, float]:
    """Device-idle seconds inside every request, by the innermost program
    span over each idle stretch (a stretch across several spans split by
    overlap)."""
    spans = program_spans(trace)
    busy = sorted((s, e) for _, s, e in trace.records)
    out: Dict[str, float] = {}
    for name, lo, hi in spans:
        if name != REQUEST:
            continue
        pieces = innermost([x for x in spans if x[1] >= lo and x[2] <= hi],
                           lo, hi)
        idle = gaps([(s, e) for s, e in busy if e > lo and s < hi], lo, hi)
        i = 0
        for a, b in idle:
            while i < len(pieces) and pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                s, e, who = pieces[j]   # who: never None, inside REQUEST
                out[who] = out.get(who, 0.0) + min(b, e) - max(a, s)
                j += 1
    return out


def layer(name: str) -> str:
    """The layer of a program span among the four that split a request's
    idle: ``engine`` (``serve.*``), ``moe`` (``moe.*``), ``k2``
    (``attn.k2``) or ``stack`` (``model.*`` and the other ``attn.*``)."""
    if name.startswith("serve."):
        return "engine"
    if name.startswith("moe."):
        return "moe"
    return "k2" if name == K2 else "stack"


def _readable(r) -> bool:
    return _prefill(r) and any(n.startswith(PROGRAM)
                               for n, _, _ in r.trace.host)


def _idle_ms(r, which: str) -> Optional[float]:
    if not _readable(r):
        return None
    by = idle_by_span(r.trace)
    return 1e3 * sum(v for n, v in by.items()
                     if layer(n) == which) / len(r.calls)


def engine_idle_ms(r) -> Optional[float]:
    """Device-idle ms a call under the engine's spans (``serve.*``:
    ``generate``'s own Python, the upload, the caches' padding, the
    sampling)."""
    return _idle_ms(r, "engine")


def stack_idle_ms(r) -> Optional[float]:
    """Device-idle ms a call under the model stack's spans (``model.*``
    and ``attn.*`` but K2's: embedding, blocks, norms, projections,
    RoPE, head)."""
    return _idle_ms(r, "stack")


def moe_idle_ms(r) -> Optional[float]:
    """Device-idle ms a call under the MoE layer's spans (``moe.*``)."""
    return _idle_ms(r, "moe")


def k2_idle_ms(r) -> Optional[float]:
    """Device-idle ms a call under K2's host wrapper (``attn.k2``)."""
    return _idle_ms(r, "k2")


def _ranges_ms(r, names) -> Optional[float]:
    if not _readable(r):
        return None
    return 1e3 * sum(r.trace.ranges.get(n, 0.0) for n in names) / len(
        r.calls)


#: the MoE layer's passes outside the expert products: routing (with the
#: small router product), the sort and scatter, SwiGLU, the gathers
MOE_PASSES = ("moe.route", "moe.dispatch", "moe.swiglu", "moe.combine")
#: the norms and RoPE
NORM_ROPE = ("model.norm", "attn.rope")


def moe_passes_ms(r) -> Optional[float]:
    """Device ms a call launched under :data:`MOE_PASSES`."""
    return _ranges_ms(r, MOE_PASSES)


def norm_rope_ms(r) -> Optional[float]:
    """Device ms a call launched under :data:`NORM_ROPE`."""
    return _ranges_ms(r, NORM_ROPE)
