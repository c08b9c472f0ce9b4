"""The program's own spans, as the per-layer metrics of ``program_span``
read them: the records ``fetal_mri_segmentation_tpu_torch.utils.profiling``
keeps while a ``torch.profiler`` session runs (``span_records()``), grouped
by request (one case or one train step).

The traced run (``profiling.two_stretches``) profiles a dropped warm-up
stretch of ``WARMUP`` requests, the device-only stretch of ``rec["items"]``
and the host stretch of as many. Request ids count up from 0 in the
process, and nothing records outside a profiler, so the device-only
stretch's requests are the ``WARMUP``-th to the ``WARMUP + items - 1``-th
id in order. A reading is the median over those requests of each
request's host ms summed over the named spans; there is none (None)
unless exactly ``WARMUP + 2 * items`` requests were recorded and every
kept request has every named span, and none where the program keeps no
spans (``span_records`` missing).

This file imports nothing of the benchmark, so the tests load it by path.
"""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Iterable, List, Optional

# the warm-up stretch that profiling.two_stretches profiles and drops
WARMUP = 2


def program_records() -> Optional[list]:
    """The program's finished spans, or None where it keeps none."""
    try:
        from fetal_mri_segmentation_tpu_torch.utils.profiling import (
            span_records)
    except ImportError:
        return None
    return span_records()


def per_request(items: int, names: Iterable[str],
                records: Optional[list] = None) -> Optional[List[float]]:
    """Per request of the device-only stretch, in order, the host ms
    summed over its spans named in ``names``; None as the module
    docstring says."""
    if records is None:
        records = program_records()
    if records is None:
        return None
    names = set(names)
    groups = defaultdict(list)
    for r in records:
        groups[r["request"]].append(r)
    if len(groups) != WARMUP + 2 * items:
        return None
    out = []
    for request in sorted(groups)[WARMUP:WARMUP + items]:
        mine = [r for r in groups[request] if r["name"] in names]
        if {r["name"] for r in mine} != names:
            return None
        out.append(float(sum(r["host_ms"] for r in mine)))
    return out


def median(rec: dict, names: Iterable[str],
           records: Optional[list] = None) -> Optional[float]:
    """The median over the device-only stretch's requests of their host
    ms summed over ``names``, for the traced run's record ``rec``."""
    values = per_request(int(rec["items"]), names, records)
    return None if values is None else statistics.median(values)
