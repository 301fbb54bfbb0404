"""
Tracing inside the program, and the profiler's export (counterpart of
``gpim_tpu/utils/profiling.py``).

- ``span(name, **attrs)``: a context manager around one phase of the
  program. Off, the default, it checks one module-level reference and
  returns a shared no-op context: no clock, no torch call. On (inside
  :func:`spans`), it records ``Span(id, parent, name, start_ns, end_ns,
  attrs)`` in memory, its times from ``time.perf_counter_ns()``, its parent
  the innermost span still open; and where a torch profiler is recording,
  it also opens a ``record_function`` range of the same name, so the span
  sits in the profiler's trace on the device events' clock, over the
  operators and kernels it launched.
- ``wait(site, n=1)``: the same, around a place where the host waits for
  the card: a read of a device tensor (``.cpu()``, ``.item()``, ``float``,
  ``.tolist()``) or a pageable upload (``torch.as_tensor`` of a numpy
  array onto the card), which waits for the stream. On, it counts ``n``
  waits at ``site`` and records the span ``wait.<site>``. The sites are
  counted, not the CUDA calls, so the counts are the same on the CPU.
- ``spans()``: switches the recorder on for its block and yields the
  :class:`Recorder` (``spans``, ``counts``, ``summary()``).
- ``trace(logdir)``: torch.profiler over the enclosed block, host and CUDA
  activities, with the recorder on, exported as a Chrome trace into
  ``logdir`` (TensorBoard's profiler plugin and Perfetto read it).

No span synchronises, records a CUDA event or launches anything: a span
that should cover device work ends after a read that already waits for
it. The first call of a phase includes one-time costs (kernel build,
library handles, allocator warm-up); :meth:`Recorder.summary` keeps it
apart from the warm calls.
"""

import collections
import contextlib
import os
import socket
import tempfile
import time

import torch

__all__ = ["Span", "Recorder", "span", "wait", "spans", "trace"]

# The profiler keeps a CUDA kernel's event only if its device timestamps,
# placed on the host's clock, fall inside the window; on an H100 they sat
# up to 4.3 ms before the kernel's own launch call, so a kernel launched
# within a few ms of the window's start could land before it and be
# dropped. The card idles this long, synchronised, after the window opens
# and before it closes.
EDGE_S = 0.05

Span = collections.namedtuple(
    "Span", ["id", "parent", "name", "start_ns", "end_ns", "attrs"])

_OFF = contextlib.nullcontext()
_REC = None          # the recorder spans go to; None while tracing is off


class Recorder:
    """What one :func:`spans` block recorded: ``spans``, a list of
    :class:`Span` in the order they opened (ids are list positions; a span
    still open is None), and ``counts`` {site: host waits}."""

    def __init__(self):
        self.spans = []
        self.counts = {}
        self._open = []

    def summary(self):
        """{span name: {calls, first_s, warm_s}}: the first call's seconds
        and the mean of the others' (None after one call)."""
        secs = {}
        for s in self.spans:
            if s is not None:
                secs.setdefault(s.name, []).append(
                    (s.end_ns - s.start_ns) * 1e-9)
        return {name: {"calls": len(d), "first_s": d[0],
                       "warm_s": sum(d[1:]) / (len(d) - 1) if d[1:] else None}
                for name, d in secs.items()}


class _Open:
    """One span of a recorder while it is open."""

    __slots__ = ("rec", "name", "attrs", "cpu", "id", "parent", "t0", "c0",
                 "rf")

    def __init__(self, rec, name, attrs, cpu):
        self.rec, self.name, self.attrs, self.cpu = rec, name, attrs, cpu

    def __enter__(self):
        rec = self.rec
        self.id = len(rec.spans)
        rec.spans.append(None)
        self.parent = rec._open[-1] if rec._open else None
        rec._open.append(self.id)
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.cpu:
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.cpu:
            self.attrs["cpu_ns"] = time.thread_time_ns() - self.c0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._open.pop()
        rec.spans[self.id] = Span(self.id, self.parent, self.name, self.t0,
                                  t1, self.attrs)
        return False


def span(name, cpu=False, **attrs):
    """A span named ``name`` around the ``with`` block; ``attrs`` are kept
    with it, and with ``cpu`` the calling thread's CPU seconds in the span,
    as ``attrs["cpu_ns"]``. Off, a shared no-op context (``as`` gives
    None); on, the open span (``as`` gives it, its ``attrs`` writable)."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs, cpu)


def wait(site, n=1):
    """A span ``wait.<site>`` around a block in which the host waits for
    the card ``n`` times (device reads or pageable uploads), counted at
    ``site``; off, the shared no-op context."""
    rec = _REC
    if rec is None:
        return _OFF
    rec.counts[site] = rec.counts.get(site, 0) + n
    return _Open(rec, "wait." + site, {}, False)


@contextlib.contextmanager
def spans():
    """Switch the recorder on for the enclosed block; yields the
    :class:`Recorder` that holds what the block recorded. A block inside
    another records into its own recorder."""
    global _REC
    prev, _REC = _REC, Recorder()
    try:
        yield _REC
    finally:
        _REC = prev


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block (CPU operators, and CUDA kernels where a
    card is present) with the recorder on (a new one, unless one is on
    already), and write it to ``logdir`` (default: ``gpim_tpu_torch_trace``
    in the temporary directory) as ``<host>_<pid>.<ms>.pt.trace.json``, the
    name TensorBoard's profiler plugin looks for; yields ``logdir``. The
    program's spans appear as user annotations over the operators they
    ran. On a card, the window opens on an idle card and stays open
    ``EDGE_S`` before the block and after its last kernel, so that the
    trace holds every kernel the block ran."""
    from torch.profiler import ProfilerActivity, profile
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "gpim_tpu_torch_trace")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        if _REC is None:
            stack.enter_context(spans())
        with profile(activities=activities) as prof:
            if cuda:
                time.sleep(EDGE_S)
            yield logdir
            if cuda:
                torch.cuda.synchronize()
                time.sleep(EDGE_S)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "%s_%d.%d.pt.trace.json" % (
        socket.gethostname(), os.getpid(), time.time_ns() // 1_000_000)))
