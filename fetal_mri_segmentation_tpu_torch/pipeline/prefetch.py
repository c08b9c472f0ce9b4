"""Background prefetch: host batch assembly and the host-to-device copy
overlap the train step (port of
``fetal_mri_segmentation_tpu/pipeline/prefetch.py``).

A daemon thread keeps a bounded queue of ready batches; :func:`to_device`
stages each array in pinned host memory and issues a non-blocking copy, so
the transfer is in flight while the previous step computes.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class _Stop:
    pass


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and a non-blocking
    copy when ``device`` is a CUDA device, as it is on the CPU."""
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def prefetch(generator: Iterator, size: int = 2,
             device_put: Optional[Callable] = None) -> Iterator:
    """Wrap an iterator with a bounded background-producer queue.

    ``device_put``: applied to each item in the producer thread (e.g.
    moving the arrays with :func:`to_device`), so transfers are issued
    ahead of consumption. A producer error is raised to the consumer; a
    consumer that stops early stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop_flag = threading.Event()

    def put_checking_stop(item) -> bool:
        # re-check the stop flag so an abandoned consumer never leaves the
        # producer blocked on a full queue holding device buffers
        while not stop_flag.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in generator:
                if stop_flag.is_set():
                    return
                if device_put is not None:
                    item = device_put(item)
                if not put_checking_stop(item):
                    return
        except Exception as e:  # surface producer errors to the consumer
            put_checking_stop(e)
        finally:
            put_checking_stop(_Stop())

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    try:
        while True:
            item = q.get()
            if isinstance(item, _Stop):
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop_flag.set()
