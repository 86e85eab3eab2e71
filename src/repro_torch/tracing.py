"""Named host ranges on the port's paths, recorded only while a
``torch.profiler`` records.

It has no counterpart in ``src/repro``, whose paths mark nothing.
:func:`span` returns ``torch.profiler.record_function(name)``
while a profiler is recording and one shared no-op context otherwise, so
a path that is not traced pays one check a span and allocates nothing.
The profiler being on is the switch: there is no flag, no environment
variable and no synchronisation.  A recorded span carries its name, its
start and end on the profiler's clock (the clock of the device records
it traces) and its nesting; the profiler links each kernel launched
inside it to it by correlation id.  Names are fixed strings, never ids or
shapes, so that a reader can sum a span by name; the serving engine's
module docstring lists the spans of the prefill path.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

#: the context every span returns while no profiler records (stateless,
#: so one instance serves nested and concurrent spans alike)
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: the profiler range ``name`` while a
    ``torch.profiler`` records, else a shared no-op."""
    if _recording():
        return record_function(name)
    return _OFF
