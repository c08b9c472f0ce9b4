"""Median host ms per case of the program's swin.encoder spans (the Swin
encoder's enqueue, patch embedding through the hidden states' norms,
summed over the case's patch batches), over the device-only stretch's
cases. Read from the program's own records (perfbench/spans.py).

A span is host wall time, and a launch blocks while the card's launch
queue is full. So it reads the host's enqueue cost only while the card
waits on the host (device_idle.serve high); in a device-bound cell it
reads mostly the card draining the queue, and moves with the device's
speed. There it is an upper bound of the enqueue, which shows itself once
the enqueue grows past the device time and the cell turns host-bound."""

from perfbench import spans


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return spans.median(rec, ["swin.encoder"])
