"""Named host ranges on the port's paths, recorded only while a
``torch.profiler`` records.

It has no counterpart in ``src/repro``, whose paths mark nothing.
:func:`span` returns ``torch.profiler.record_function(name)``
while a profiler is recording and one shared no-op context otherwise, so
a path that is not traced pays one check a span and allocates nothing.
The profiler being on is the switch: there is no flag, no environment
variable and no synchronisation.  A recorded span carries its name, its
start and end on the profiler's clock (the clock of the device records
it traces) and its nesting; the profiler links to it, by correlation id,
each kernel that an op inside it launches.  A kernel launched through
``ctypes`` has no op of its own, so its wrapper opens a :func:`launch`
range around the call.  Names are fixed strings, never ids or shapes, so
that a reader can sum a span by name; the serving engine's module
docstring lists the spans of the prefill path.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
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


def launch(name: str):
    """A context manager around a kernel launched from outside PyTorch's
    ops (a ``ctypes`` call): while a ``torch.profiler`` records, an
    op-level range ``name``, else the shared no-op.  The profiler links a
    kernel to the innermost op open at its launch, never to a
    :func:`span` (a user range), so without this range such a kernel
    belongs to no span and a span's device time leaves it out."""
    if _recording():
        return _RecordFunctionFast(name)
    return _OFF
