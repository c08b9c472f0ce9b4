"""Tracing (port of ``fetal_mri_segmentation_tpu/utils/profiling.py::
trace`` on ``torch.profiler``), and the spans the port records inside
itself while a profiler runs.

``trace(logdir)`` profiles everything inside the context, host and device,
and writes one Chrome-trace JSON file under ``logdir`` (loadable in
Perfetto, ``chrome://tracing`` or TensorBoard's profile plugin), and beside
it the port's span records of the same stretch (``*.spans.json``, the list
:func:`span_records` returns): what ``python -m
fetal_mri_segmentation_tpu_torch.train --profile LOGDIR`` needs. A profiled
run is slower and its trace grows with the steps, so profile a short run.

``span(name)`` marks one step of the port (``window.model``,
``ingest.read``, ``train.backward``, ...). With no ``torch.profiler``
session running it is one shared no-op context: no range, no event, no
clock read. While one runs, a span opens the profiler range
``fetal.<name>`` (a ``RecordFunction``, as ``record_function`` opens, at
about a sixth of its host cost), so it sits in the profiler's trace on
the clock of the device operations, and keeps a record:

- ``name``, ``request``, ``span`` (its serial number) and ``parent`` (the
  serial of the span it nests in on its thread, or None);
- ``start_ns`` / ``end_ns``: epoch ns, the clock the profiler's events
  report; ``host_ms`` between them.

A span takes no device time itself: a CUDA event pair would time the
stream from the span's start to its end, idle included, which is the
host's enqueue and not the layer's work wherever the host is slower than
the card. :func:`span_device_ms` gives each span name the device time of
the operations launched inside it, from the events of a finished
profiler session (``tools/profile_torch_serving.py`` and
``profile_torch_training.py`` print it).

Request ids count up from 0 in the process. The outermost span of a
request takes the next id and the spans nested in it on the same thread
carry it. Where a request crosses a stage or a thread, the id travels
explicitly: :func:`tag` marks an object (a preprocessed volume, a
dispatched label map) with the current request, :func:`request_of` reads
it back, and ``span(name, request=...)`` joins it. So one case, from its
NIfTI read through the sliding window to its queued write, is one id.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler
from torch.utils.weak import WeakIdKeyDictionary

PREFIX = "fetal."
# the host op autograd's engine opens around each backward node it runs
BACKWARD_OP = "autograd::engine::evaluate_function"
# finished records kept; the oldest go first beyond it
MAX_RECORDS = 1 << 16

_LOCK = threading.Lock()
_RECORDS: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_TAGS = WeakIdKeyDictionary()
_LOCAL = threading.local()
_requests = itertools.count()
_serials = itertools.count()


def _on() -> bool:
    # a module-level flag that torch.profiler sets on start and clears on
    # stop, for every thread
    return bool(getattr(_profiler, "_is_profiler_enabled", False))


def _open_spans() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Off:
    """The span while no profiler runs."""

    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "request", "parent", "serial", "range", "start_ns")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = _open_spans()
        parent = stack[-1] if stack else None
        if self.request is None:
            self.request = (parent.request if parent is not None
                            else next(_requests))
        self.parent = None if parent is None else parent.serial
        self.serial = next(_serials)
        stack.append(self)
        self.range = _RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.range.__exit__(*exc)
        _open_spans().pop()
        with _LOCK:
            _RECORDS.append((self.name, self.request, self.serial,
                             self.parent, self.start_ns, end_ns))
        return False


def span(name: str, request=None):
    """A context that records step ``name`` of the port while a
    ``torch.profiler`` session runs (the module docstring), under
    ``request`` when given, else the request of the span it nests in, else
    the next id; a shared no-op otherwise. The context's ``request`` is the
    id it records under (None when off)."""
    if not _on():
        return _OFF
    return _Span(name, request)


def tag(obj):
    """``obj``, marked with the request of the innermost span open on this
    thread (while a profiler runs), so a later stage or thread joins it."""
    stack = getattr(_LOCAL, "stack", None)
    if _on() and stack:
        try:
            _TAGS[obj] = stack[-1].request
        except TypeError:  # no weak reference to it: left untagged
            pass
    return obj


def request_of(obj):
    """The request :func:`tag` marked ``obj`` with, or None."""
    if not _on():
        return None
    try:
        return _TAGS.get(obj)
    except TypeError:
        return None


def span_records() -> list:
    """The finished spans, oldest first, as dicts (the module
    docstring)."""
    with _LOCK:
        records = list(_RECORDS)
    return [{"name": name, "request": request, "span": serial,
             "parent": parent, "start_ns": start, "end_ns": end,
             "host_ms": (end - start) / 1e6}
            for name, request, serial, parent, start, end in records]


def reset_spans() -> None:
    """Forget every finished span."""
    with _LOCK:
        _RECORDS.clear()


def span_device_ms(events) -> dict:
    """Per span name, the device ms of the operations launched while a
    span of that name was open: on the launching thread, or, for a thread
    that opens no span or that runs autograd's backward (whose own spans,
    ``norm.backward``, nest in the step's spans on the thread that called
    ``backward``), on any thread. Nested spans each count the operation;
    the key None sums the operations launched outside every span.
    ``events``: a finished ``torch.profiler`` session's
    ``prof.profiler.kineto_results.events()`` with host and device
    activities."""
    spans, launches, device = collections.defaultdict(list), {}, []
    backward = set()
    for e in events:
        name, start = e.name(), e.start_ns()
        if e.device_type() != torch.autograd.DeviceType.CPU:
            # a range also shows on the device's timeline: no device work
            if not (name.startswith(PREFIX) or e.is_user_annotation()):
                device.append((e.duration_ns(), e.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans[e.start_thread_id()].append(
                (start, start + e.duration_ns(), name[len(PREFIX):]))
            continue
        if name.startswith(BACKWARD_OP):
            backward.add(e.start_thread_id())
        if e.linked_correlation_id() == 0:
            # a host op the profiler links device operations to
            launches[e.correlation_id()] = (e.start_thread_id(), start)
    out = collections.defaultdict(float)
    for dur, corr in device:
        owners = set()
        if corr in launches:
            thread, at = launches[corr]
            own = spans.get(thread) and thread not in backward
            for th in ([thread] if own else spans):
                owners |= {n for a, b, n in spans[th] if a <= at <= b}
        for name in owners or [None]:
            out[name] += dur / 1e6
    return dict(out)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context into ``logdir``; yields the
    path of the trace file, which is written when the context ends,
    together with the spans of the context beside it (the same name,
    ``.spans.json`` in place of ``.pt.trace.json``)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    stem = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}")
    path = stem + ".pt.trace.json"
    reset_spans()
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield path
    finally:
        profiler.stop()
        profiler.export_chrome_trace(path)
        with open(stem + ".spans.json", "w") as f:
            json.dump(span_records(), f)
