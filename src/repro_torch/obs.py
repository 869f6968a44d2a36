"""The port's observability: one registry of counters, and spans.

``COUNTS`` is the observability contract of the port's hot path.
``launch:<kernel>`` is bumped by a wrapper exactly where it launches its
CUDA kernel, ``plain:<kernel>`` where a CPU tensor takes the plain torch
version, and ``build`` once per library compiled by this process.

A span names a stretch of the training path at a layer boundary:
``with obs.span("rt.ssm.conv"):``. Names start with ``rt.`` and form a
small fixed set. While ``torch.profiler`` runs, a span is a profiler
range of its name and bounds on the host's timeline, on the
kernels' clock, so a trace can put each kernel's device time down to the
span that launched it. With no profiler running, a span is one check of a
module-level flag and a shared null context: no allocation, no clock read,
no tensor.

The range is ``torch._C._profiler._RecordFunctionFast``, a ``FUNCTION``-
scope record, and not the public ``torch.profiler.record_function``: that
one is a user annotation, which the profiler also draws on the device's
timeline as a range over the kernels launched inside it, so a trace would
list every span as a device operation and count its stretch as busy. The
symbol is private to torch; ``tests/test_torch_obs.py`` checks that it is
there and records on the host's timeline only, so a torch release that
moves it fails there. Where it is missing, spans record nothing and the
port runs as before.
"""

from __future__ import annotations

import contextlib
from collections import Counter

from torch.autograd import profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # a torch without it: spans are off
    _RecordFunctionFast = None

COUNTS: Counter = Counter()


def counts() -> dict[str, int]:
    """Snapshot of every counter."""
    return dict(COUNTS)


def reset_counts() -> None:
    COUNTS.clear()


_NULL = contextlib.nullcontext()


def span(name: str):
    """A context around one stretch of work (see the module's docstring)."""
    if not _profiler._is_profiler_enabled or _RecordFunctionFast is None:
        return _NULL
    return _RecordFunctionFast(name)
