"""
Phase timing for the reconstructors (counterpart of ``Timer`` in
``gpim_tpu/utils/profiling.py``).

PyTorch returns before the device finishes, so a phase on a CUDA device
synchronises before it reads the clock, at both ends. The first call of a
phase includes one-time costs (kernel build, library handles, allocator
warm-up) and is kept apart from warm calls.
"""

import contextlib
import time

import torch

__all__ = ["Timer"]


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
