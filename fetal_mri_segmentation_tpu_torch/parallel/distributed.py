"""Joining the processes of a multi-GPU run, and sliding-window inference
with the patch grid sharded over them (port of
``fetal_mri_segmentation_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` once per host and
then sees every device from one process. The port runs one process per
device: a launcher (``torchrun``, or ``train.py``'s own
``torch.multiprocessing.spawn``) starts them and tells each its place
through the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``), and :func:`initialize_distributed` joins
them with ``torch.distributed.init_process_group``: NCCL between cards,
gloo on the CPU.

:func:`make_sharded_predictor` shards a sliding-window predictor's patch
grid over a mesh: each rank predicts a contiguous chunk of the patch
batches into an accumulator of its own, one all-reduce of the accumulators
merges them (overlap-add is order-free addition; the Gaussian weight field
depends on the geometry alone and is fixed on the host already), and every
rank returns the whole probability map, as the JAX ``out_specs=P()``.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.ops import cuda_lib
from fetal_mri_segmentation_tpu_torch.utils.device import resolve_device


def _local_rank_and_world() -> tuple:
    world = int(os.environ.get("WORLD_SIZE", 1))
    return (int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def local_device(device="cuda", share_devices: bool = False) -> torch.device:
    """The device of this process: ``device`` itself when it is the CPU or
    names a card, else the card of this process's ``LOCAL_RANK``.

    A rank that finds no card of its own raises. ``share_devices`` lets
    ranks beyond the number of cards wrap around and share one instead: a
    way to check the multi-rank path on a machine with fewer cards (the
    process group is then gloo, since NCCL refuses two ranks on one card);
    it brings no speed."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local, _ = _local_rank_and_world()
    count = torch.cuda.device_count()
    if local >= count:
        if not share_devices:
            raise RuntimeError(
                f"the rank with LOCAL_RANK={local} finds no CUDA device of "
                f"its own ({count} visible): start one process per card")
        local %= count
    return torch.device("cuda", local)


def default_backend(device="cuda") -> str:
    """NCCL where every local rank has a card of its own, gloo on the CPU
    and where ranks share a card."""
    if resolve_device(device).type != "cuda":
        return "gloo"
    _, local_world = _local_rank_and_world()
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device="cuda",
                           share_devices: bool = False,
                           timeout_s: float = 600.0) -> None:
    """Join this process to the run's process group (a no-op for a single
    process, and where a group is up already).

    With no arguments everything comes from the launcher's environment;
    without a launcher (no ``WORLD_SIZE``) there is one process and nothing
    to join. ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name the rendezvous explicitly, as the JAX function's
    do. ``backend``: "nccl" or "gloo"; None picks :func:`default_backend`
    for ``device``. A group of one (``WORLD_SIZE=1`` under a launcher) is
    still made, so the same collectives run on one card."""
    if num_processes is not None and num_processes <= 1:
        return
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        return
    if dist.is_initialized():
        return
    dev = local_device(device, share_devices)
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or default_backend(device),
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def shutdown_distributed() -> None:
    """Leave the process group, where one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port of this machine that is free now (the rendezvous of ranks
    started here)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_environment(rank: int, world: int, port: int) -> dict:
    """What a launcher tells rank ``rank`` of ``world`` ranks of this
    machine that meet at ``port``."""
    return dict(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))


def start_ranks(fn: Callable, world: int, args: tuple = ()):
    """Start ``world`` processes of ``fn(rank, *args)``
    (``torch.multiprocessing.spawn``) without waiting for them; finish with
    :func:`join_ranks`."""
    import torch.multiprocessing as mp

    return mp.spawn(fn, nprocs=world, join=False, args=args)


def join_ranks(ctx, timeout_s: Optional[float] = None) -> None:
    """Wait for the ranks :func:`start_ranks` started. A rank's non-zero
    exit raises, and so does the time limit; no rank outlives this call."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {len(ctx.processes)} ranks did not "
                                   f"finish within {timeout_s:g} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def run_ranks(fn: Callable, world: int, args: tuple = (),
              timeout_s: Optional[float] = None) -> None:
    """Start ``world`` processes of ``fn(rank, *args)`` and wait for them
    (:func:`start_ranks`, :func:`join_ranks`)."""
    join_ranks(start_ranks(fn, world, args), timeout_s)


def build_kernels_before_ranks(config, device) -> None:
    """Compile the kernel library before any rank starts, so that two ranks
    never race on ``nvcc``: each then finds it built."""
    if resolve_device(device).type == "cuda" and (
            config.use_pallas_conv or config.use_pallas_dec0):
        cuda_lib.build()


def make_sharded_predictor(predictor: SlidingWindowPredictor,
                           mesh) -> SlidingWindowPredictor:
    """``predictor`` with its patch grid sharded over ``mesh`` (a
    ``DataMesh``, or any mesh with ``group``, ``rank`` and ``size``): rank
    r predicts the r-th contiguous chunk of the patch batches, and every
    rank calls it with the same volume and gets the whole probability map.
    The math is the single-device predictor's up to the order of the
    overlap-add's sums. Sets the predictor's ``share`` and ``group`` in
    place and returns it."""
    n = predictor.n_batches
    chunk = -(-n // mesh.size)
    predictor.share = range(min(mesh.rank * chunk, n),
                            min((mesh.rank + 1) * chunk, n))
    predictor.group = mesh.group if mesh.size > 1 else None
    return predictor
