"""
Tracing and phase timing (counterpart of ``gpim_tpu/utils/profiling.py``).

- ``trace(logdir)``: torch.profiler over the enclosed block, host and CUDA
  activities, exported as a Chrome trace into ``logdir`` (TensorBoard's
  profiler plugin and Perfetto read it).
- ``Timer``: the reconstructors' phase timer.

PyTorch returns before the device finishes, so a phase on a CUDA device
synchronises before it reads the clock, at both ends. The first call of a
phase includes one-time costs (kernel build, library handles, allocator
warm-up) and is kept apart from warm calls.
"""

import contextlib
import os
import socket
import tempfile
import time

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block (CPU operators, and CUDA kernels where a
    card is present) and write it to ``logdir`` (default:
    ``gpim_tpu_torch_trace`` in the temporary directory) as
    ``<host>_<pid>.<ms>.pt.trace.json``, the name TensorBoard's profiler
    plugin looks for; yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gpim_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "%s_%d.%d.pt.trace.json" % (
        socket.gethostname(), os.getpid(), time.time_ns() // 1_000_000)))


class Timer:
    """Accumulates named phase durations; distinguishes the first call of a
    phase from warm calls."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name, device=None):
        """Time the enclosed block; pass the CUDA device it runs on so the
        clock waits for the device's work."""
        sync = device is not None and torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            rec = self.phases.setdefault(
                name, {"first_s": None, "warm_s": [], "calls": 0})
            if rec["first_s"] is None:
                rec["first_s"] = dt
            else:
                rec["warm_s"].append(dt)
            rec["calls"] += 1

    def summary(self):
        """{phase: {first_s, warm_mean_s, calls}}."""
        out = {}
        for name, rec in self.phases.items():
            warm = rec["warm_s"]
            out[name] = {
                "first_s": round(rec["first_s"], 4),
                "warm_mean_s": round(sum(warm) / len(warm), 4) if warm
                else None,
                "calls": rec["calls"],
            }
        return out
