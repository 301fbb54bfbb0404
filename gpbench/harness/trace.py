"""
The traced window: ``torch.profiler`` (host and CUDA activities) around a
block, with the events kept in memory and reduced to what the per-layer
metrics read; and the device window: CUDA activities alone around the
whole measured window, reduced to the card's busy time for an end-to-end
metric whose source is ``device_trace``.

The card is synchronised and left idle ``EDGE_S`` at both edges of the
profiler's window: the profiler keeps a kernel's event only where its
device timestamps, placed on the host's clock, fall inside the window,
and on an H100 they were seen up to 4.3 ms before their own launch call.
The idle edges are outside the block's window (``window_s``), which runs
from the block's start to the synchronisation after it.
"""

import bisect
import contextlib
import time

import torch

__all__ = ["EDGE_S", "traced", "device_window", "reduce_events",
           "busy_intervals"]

EDGE_S = 0.05
_TOP = 10
_NO_OP = "host python between operators"


class Trace:
    """What a traced block left: ``window_s``, ``busy_s`` (seconds in which
    a device operation ran, the union of their intervals), ``ops``
    {device op name: (seconds, count)}, ``launches`` (device operations:
    kernels, copies, fills), ``device_ops`` and ``idle_gaps`` (the
    breakdown's lists, each at most ten [name, seconds])."""

    def __init__(self):
        self.window_s = self.busy_s = 0.0
        self.launches = 0
        self.ops = {}
        self.device_ops = self.idle_gaps = []

    def finish(self):
        """Read the recorded events into this trace (see :func:`traced`)."""
        return self


@contextlib.contextmanager
def traced():
    """Profile the enclosed block on the card; yields a :class:`Trace`
    whose ``window_s`` is set when the block ends and the rest by its
    ``finish()``, which the caller calls once its own window has closed:
    reading the events of a campaign takes tens of seconds."""
    from torch.profiler import ProfilerActivity, profile
    out = Trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out.window_s = time.perf_counter() - t0
        time.sleep(EDGE_S)
    out.finish = lambda: reduce_events(prof.events(), out)


@contextlib.contextmanager
def device_window():
    """Record the device operations of the enclosed block, and no host
    operations; yields a :class:`Trace` whose ``window_s``, ``busy_s``
    and ``launches`` are filled when the block ends. The profiler starts,
    and the card idles ``EDGE_S``, before the block: a caller that starts
    its clock inside the block counts neither."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = Trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out.window_s = time.perf_counter() - t0
        time.sleep(EDGE_S)
    spans = []
    for e in prof.profiler.kineto_results.events():
        note = getattr(e, "is_user_annotation", None)
        if e.device_type() == DeviceType.CUDA and not (note and note()):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns()))
    out.launches = len(spans)
    busy_ns, _ = busy_intervals(spans)
    out.busy_s = busy_ns * 1e-9


def busy_intervals(spans):
    """(the length of the union of the intervals ``spans`` [(start, end),
    ...], the gaps between them [(end, next start), ...]), in the spans'
    unit."""
    busy, gaps = 0, []
    cur_s = cur_t = None
    for s, t in sorted(spans):
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    return busy, gaps


def reduce_events(events, out):
    """Fill ``out`` from the profiler's events."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    ops = {}
    for s, t, name in dev:
        sec, n = ops.get(name, (0.0, 0))
        ops[name] = (sec + (t - s) * 1e-6, n + 1)
    out.ops = ops
    out.launches = len(dev)
    out.device_ops = [[k, v[0]] for k, v in sorted(
        ops.items(), key=lambda kv: -kv[1][0])[:_TOP]]
    busy_us, gaps = busy_intervals([(s, t) for s, t, _ in dev])
    out.busy_s = busy_us * 1e-6
    out.idle_gaps = _label_gaps(gaps, host)
    return out


def _label_gaps(gaps, host):
    """Idle seconds between device operations, summed by the innermost
    host operation that ran at each gap's midpoint; the ten largest."""
    host.sort()
    starts = [h[0] for h in host]
    by_name = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name, best = _NO_OP, None
        # the host ops that started before the midpoint; the innermost
        # (shortest) of those still running is what the host was doing
        i = bisect.bisect_right(starts, mid)
        for s, t, n in host[max(0, i - 64):i]:
            if t >= mid and (best is None or t - s < best):
                name, best = n, t - s
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(),
                                       key=lambda kv: -kv[1])[:_TOP]]
