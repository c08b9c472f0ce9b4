"""Cases per second over the device-only profiled stretch, on the host's
clock: its cases over its wall span (window_s, between two synchronizes).
For the serving cells whose window's serve_cases_per_s follows the
host's speed too closely to hold a bound: the rate stays in view here,
beside serve_case_p95_ms."""


def read(rec):
    if rec.get("kind") != "serve" or rec["window_s"] <= 0:
        return None
    return rec["items"] / rec["window_s"]
