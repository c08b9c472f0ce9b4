"""Median host ms per case of inference/predict.py::preprocess_case, timed
by a wrapper the traced run puts around that module attribute."""

import statistics


def read(rec):
    times = rec.get("host_ms", {}).get("preprocess_case")
    if rec.get("kind") != "ingest" or not times:
        return None
    return statistics.median(times)
