"""The traced run's record: a ``torch.profiler`` stretch, read from the
profiler's own events.

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets) inside the stretch, so overlapping operations count once;
  ``window_s``: the stretch's wall span on the host's clock, between two
  synchronizes.
- ``range_s``: per range name, the device seconds of the operations
  launched while a ``record_function`` range of that name was open on the
  launching thread, found through the profiler's link from each device
  operation to the host op that launched it.
- ``breakdown``: the device operations that took the most time, and the
  longest idle gaps of the device, each named after the innermost host
  range or op open on the main thread at the gap's middle.

Ranges come from the benchmark's files alone: ``Stretch`` opens
``pb.stretch``, ``module_ranges`` puts ``pb.<name>`` around modules of
chosen classes with forward hooks, and the traffic modules name their own
host steps.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch.autograd.profiler import record_function

PREFIX = "pb."


def _start_end(e):
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    if hasattr(e, "end_ns"):
        return start, e.end_ns()
    dur = (e.duration_ns() if hasattr(e, "duration_ns")
           else e.duration_us() * 1000)
    return start, start + dur


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


class Stretch:
    """``with Stretch(host) as s:`` profiles the block; ``s.record()``
    after. ``host=False`` records the device alone, which adds the least
    host time (the busy share and the device operations are read there);
    ``host=True`` records the host's ops and ranges too (the ranges' device
    time and the idle gaps' names). The block starts and ends with a
    synchronize, and ``window_s`` is its host-clock span. The traffic runs
    one short stretch first and drops it: the profiler's first stretch in
    a process pays its own start-up."""

    def __init__(self, host: bool):
        self.host = host

    def __enter__(self):
        cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
        if self.host or not cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.range = record_function(PREFIX + "stretch")
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.range.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        self.events = list(self.prof.profiler.kineto_results.events())
        return False

    def record(self) -> dict:
        """``busy_s``, ``device_ops`` (the 10 that took most time) and,
        with ``host``, ``range_s`` and ``idle_gaps``."""
        dev, cpu, ranges = [], [], defaultdict(list)
        # record_function ranges also show on the device's timeline; they
        # are no device work
        notes = {e.name() for e in self.events if not _is_device(e)
                 and getattr(e, "is_user_annotation", lambda: False)()}
        stretch = None
        for e in self.events:
            name = e.name()
            s, t = _start_end(e)
            if _is_device(e):
                if (name in notes or name.startswith(PREFIX) or getattr(
                        e, "is_user_annotation", lambda: False)()):
                    continue
                dev.append((s, t, name, e.linked_correlation_id()))
                continue
            # host ops that launch device work are the ones the profiler
            # links device operations to (their own link is 0)
            corr = (e.correlation_id() if e.linked_correlation_id() == 0
                    else 0)
            cpu.append((s, t, name, e.start_thread_id(), corr))
            if name == PREFIX + "stretch":
                stretch = (s, t, e.start_thread_id())
            elif name.startswith(PREFIX):
                ranges[name].append((e.start_thread_id(), s, t))
        merged = []
        for s, t, _, _ in sorted(dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        by_name = defaultdict(float)
        for s, t, n, _ in dev:
            by_name[n] += (t - s) / 1e9
        rec = {"busy_s": sum(t - s for s, t in merged) / 1e9,
               "device_ops": [[n, v] for n, v in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:10]]}
        if self.host and stretch is not None:
            rec["range_s"] = _ranges(dev, cpu, ranges)
            rec["idle_gaps"] = _gaps(cpu, merged, stretch)
        return rec


def _ranges(dev, cpu, ranges) -> Dict[str, float]:
    """Per range name, the device seconds of the operations launched while
    a range of that name was open on the launching thread."""
    launch = {c: (th, s) for s, _, _, th, c in cpu if c}
    index = {}
    for name, spans in ranges.items():
        per = defaultdict(list)
        for th, s, t in spans:
            per[th].append((s, t))
        index[name] = {th: sorted(v) for th, v in per.items()}
    out = {name: 0.0 for name in ranges}
    for s, t, _, corr in dev:
        if corr not in launch:
            continue
        th, at = launch[corr]
        for name, per in index.items():
            spans = per.get(th)
            if not spans:
                continue
            # ranges of one name never nest: the last one opened before
            # the launch is the only one that can hold it
            i = bisect.bisect_right(spans, (at, float("inf"))) - 1
            if i >= 0 and at <= spans[i][1]:
                out[name] += (t - s) / 1e9
    return out


def _gaps(cpu, merged, stretch) -> list:
    """The 10 longest spans of the stretch in which the device ran
    nothing, each named after the innermost host range or op open on the
    main thread at its middle."""
    lo, hi, tid = stretch
    gaps, at = [], lo
    for s, t in merged:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    main = [c for c in cpu if c[3] == tid and c[2] != PREFIX + "stretch"]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = None
        for s, t, n, _, _ in main:
            if s <= mid <= t and (inner is None or s >= inner[0]):
                inner = (s, n)
        named.append([inner[1] if inner else "host (no op)", (b - a) / 1e9])
    return named


def two_stretches(work, k: int, model=None, classes=None) -> dict:
    """``work(n)`` runs n items. A dropped warm-up stretch of 2, a device
    stretch of ``k`` (``window_s``, ``busy_s``, the device operations),
    then a host stretch of ``k`` with ``module_ranges(model, classes)``
    (``range_s``, the idle gaps' names)."""
    with Stretch(host=False):
        work(2)
    with Stretch(host=False) as a:
        work(k)
    ra = a.record()
    ranges = (module_ranges(model, classes) if model is not None
              else contextlib.nullcontext())
    with Stretch(host=True) as b, ranges:
        work(k)
    rb = b.record()
    return {"window_s": a.window_s, "busy_s": ra["busy_s"],
            "range_s": rb.get("range_s", {}),
            "breakdown": {"device_ops": ra["device_ops"],
                          "idle_gaps": rb.get("idle_gaps", [])}}


class module_ranges:
    """Within the block, a ``pb.<name>`` range around the forward of every
    module of ``model`` whose class name maps to ``name`` in ``classes``."""

    def __init__(self, model: torch.nn.Module, classes: Dict[str, str]):
        self.model, self.classes, self.handles = model, classes, []

    def __enter__(self):
        for m in self.model.modules():
            name = self.classes.get(type(m).__name__)
            if name is None:
                continue

            def pre(mod, args, _name=PREFIX + name):
                rf = record_function(_name)
                rf.__enter__()
                mod.__dict__.setdefault("_pb_open", []).append(rf)

            def post(mod, args, out):
                mod.__dict__["_pb_open"].pop().__exit__(None, None, None)

            self.handles += [m.register_forward_pre_hook(pre),
                             m.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        return False


def ranged(name: str, enabled: bool):
    """A ``pb.<name>`` range when ``enabled``, else a no-op context."""
    return (record_function(PREFIX + name) if enabled
            else contextlib.nullcontext())


def sum_ranges(rec: dict, names: Iterable[str]) -> float:
    return sum(rec["range_s"].get(PREFIX + n, 0.0) for n in names)
