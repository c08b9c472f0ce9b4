"""conv_roofline.serve's reader, in the serving cells whose window rate follows
the host's speed too closely to hold a bound, so that there it moves
serve_case_p95_ms instead of serve_cases_per_s."""

import os

from perfbench.harness import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "conv_roofline.serve.py"),
                   "pb_metric_conv_roofline_serve").read
