"""Profiling helpers for the port's device pipeline.

Port of ``pyfastani_tpu/utils/profiling.py``.  `trace` wraps
``torch.profiler`` so any section of a pipeline can be captured and read
in a Chrome-trace viewer (``chrome://tracing``, Perfetto) or TensorBoard:

    from pyfastani_tpu_torch.utils.profiling import device_time_ms, trace

    with trace("ani-trace") as prof:
        session.query_many(genomes)
    print(device_time_ms(prof))

CUDA activity is traced when a GPU is present.  The device runs behind
the host, so time a block that ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["device_time_ms", "timed", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when available) and write its Chrome trace into ``log_dir``; yields
    the profiler, whose ``key_averages()`` give time by operation."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def device_time_ms(prof) -> float:
    """Milliseconds of device work (kernels and copies) in a finished
    profile: the device-side events only, since the host operations that
    launch them carry the same time again."""
    from torch.autograd import DeviceType

    return sum(
        e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ) / 1e3


@contextlib.contextmanager
def timed(label: str, sink=None):
    """Wall-clock a block; append ``(label, seconds)`` to ``sink`` if given."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if sink is not None:
            sink.append((label, dt))
