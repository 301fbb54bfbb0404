#!/usr/bin/env python3
"""
A benchmark cell with the program's span recorder on, and the per-layer
metrics that read its spans and wait counts:

    python3 tools/span_report.py --workload bo25_ei --seed 7 --seconds 51 \\
        --trace 1 [--recorder 0|1|2] [--out FILE]

from the repository's root, on the card. It runs the cell as
``gpbench/run.py`` does (``gpbench.harness.bench.run_cell``: the same
set-up, window, traced first job and check) with these additions, made by
wrapping the harness's ``make_loop``, ``Run`` and ``trace.reduce_events``
in this process:

- the recorder (:func:`gpim_tpu_torch.utils.profiling.spans`) is on for
  the warm-up job and for each job of the window, and each job's spans
  and wait counts are kept with its record (``spans``, ``counts``), with
  its process and main-thread CPU seconds; the warm-up's spans are kept
  on the run (``warmup_spans``), beside the seconds of the warm-up's
  first import of the program and of its job (``warmup_parts``). ``--recorder 0`` leaves it off, which is
  ``gpbench/run.py`` itself; ``--recorder 2`` leaves it off in every
  other job (the odd ones), so that the jobs' clocks compare the
  recorder on and off within one process;
- the traced job's profiler events keep the program's annotations (its
  spans, on the device events' clock) as ``Trace.spans``, and the idle
  seconds between device operations are summed by the innermost program
  span at each gap's midpoint (``idle_gaps_by_span``) and by every span
  open there (``idle_in_span``);
- the readers in :data:`READERS` read them, each returning None where it
  finds nothing to read.

The last line of standard output is the harness's result line with
``span_metrics`` (each reader's value that is not None), ``span_breakdown``
(``idle_gaps_by_span``, the traced job's idle seconds and the wait counts
by site) and ``jobs`` (each job's clock, steps, CPU seconds, wait count
and seconds by span name) added; ``--out`` appends it to a file as well.
"""

import argparse
import contextlib
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

__all__ = ["READERS", "SPANNED", "run_spanned", "main"]

# the program's span names start with these (torch.optim's own
# record_function ranges are left out)
PROGRAM_PREFIXES = ("recon.", "engine.", "adam.", "predict.", "bo.", "ski.",
                    "wait.")
_OUTSIDE = "outside program spans"
_TOP = 10


# --------------------------------------------------------------------------
# The readers
# --------------------------------------------------------------------------

def _spanned(jobs):
    """The jobs that carry the recorder's spans (none with it off)."""
    return [j for j in jobs if j.get("spans")]


def _seconds(s):
    return (s.end_ns - s.start_ns) * 1e-9


def _per_step_ms(run, select):
    """The seconds of the spans ``select(spans)`` yields, summed over the
    campaigns outside the traced one, in ms over their steps."""
    jobs = _spanned(run.plain_jobs)
    steps = sum(j["steps"] for j in jobs)
    if not steps:
        return None
    return 1e3 * sum(_seconds(s) for j in jobs
                     for s in select(j["spans"])) / steps


def _named(*names):
    return lambda spans: (s for s in spans if s is not None
                          and s.name in names)


def bo_refit_ms_per_step(run):
    """The refits, trailing ones too (``engine.train``)."""
    return _per_step_ms(run, _named("engine.train"))


def bo_rank_ms_per_step(run):
    """The prediction and ranking (``engine.predict``, ``bo.rank``)."""
    return _per_step_ms(run, _named("engine.predict", "bo.rank"))


_STEP_CALLS = ("engine.train", "engine.predict", "bo.rank", "bo.measure")


def _host_loop(spans):
    """Each ``bo.step`` less its children that call into the engine,
    rank or measure (as negative spans)."""
    steps = {s.id for s in spans if s is not None and s.name == "bo.step"}
    for s in spans:
        if s is None:
            continue
        if s.id in steps:
            yield s
        elif s.parent in steps and s.name in _STEP_CALLS:
            yield s._replace(start_ns=s.end_ns, end_ns=s.start_ns)


def bo_host_loop_ms_per_step(run):
    return _per_step_ms(run, _host_loop)


def bo_measure_ms_per_step(run):
    """The instrument's calls (``bo.measure``), the rest of a step."""
    return _per_step_ms(run, _named("bo.measure"))


def syncs_per_step_bo(run):
    jobs = _spanned(run.plain_jobs)
    steps = sum(j["steps"] for j in jobs)
    if not steps:
        return None
    return sum(sum(j["counts"].values()) for j in jobs) / steps


def syncs_per_job_recon(run):
    jobs = _spanned(run.plain_jobs)
    if not jobs:
        return None
    return sum(sum(j["counts"].values()) for j in jobs) / len(jobs)


def idle_in_refit_pct_bo(run):
    tr = run.trace
    idle = getattr(tr, "idle_in_span", None)
    if not idle or not tr.idle_s:
        return None
    return 100.0 * idle.get("engine.train", 0.0) / tr.idle_s


def first_step_s(run):
    """The process's first Adam step, in the warm-up job."""
    for s in getattr(run, "warmup_spans", None) or ():
        if s is not None and s.name == "adam.step":
            return _seconds(s)
    return None


READERS = {
    "bo_refit_ms_per_step": bo_refit_ms_per_step,
    "bo_rank_ms_per_step": bo_rank_ms_per_step,
    "bo_host_loop_ms_per_step": bo_host_loop_ms_per_step,
    "bo_measure_ms_per_step": bo_measure_ms_per_step,
    "syncs_per_step.bo": syncs_per_step_bo,
    "idle_in_refit_pct.bo": idle_in_refit_pct_bo,
    "syncs_per_job.recon": syncs_per_job_recon,
    "first_step_s": first_step_s,
}

# the readers of each loop
SPANNED = {
    "campaign": ("bo_refit_ms_per_step", "bo_rank_ms_per_step",
                 "bo_host_loop_ms_per_step", "bo_measure_ms_per_step",
                 "syncs_per_step.bo", "idle_in_refit_pct.bo",
                 "first_step_s"),
    "recon": ("syncs_per_job.recon", "first_step_s"),
}


# --------------------------------------------------------------------------
# The additions to the harness
# --------------------------------------------------------------------------

class SpannedLoop:
    """A cell's loop with the recorder on around the warm-up and each
    job, or with ``every`` 2 every other job; ``warmup_spans`` holds the
    warm-up's spans."""

    def __init__(self, loop, every=1):
        self.loop, self.every = loop, every
        self.warmup_spans = self.warmup_parts = None
        self.jobs = 0

    def make_job(self, *args):
        return self.loop.make_job(*args)

    def warmup(self, job):
        t0 = time.perf_counter()
        # the loop's own first import of the program, timed apart
        from gpim_tpu_torch.utils import profiling
        t1 = time.perf_counter()
        with profiling.spans() as rec:
            self.loop.warmup(job)
        self.warmup_spans = rec.spans
        self.warmup_parts = {"import_program_s": t1 - t0,
                             "job_s": time.perf_counter() - t1,
                             "spans": rec.summary()}

    def run_job(self, job):
        from gpim_tpu_torch.utils import profiling
        on = self.jobs % self.every == 0
        self.jobs += 1
        p0, t0 = time.process_time(), time.thread_time()
        with profiling.spans() if on else contextlib.nullcontext() as rec:
            out = self.loop.run_job(job)
        out.update(proc_cpu_s=time.process_time() - p0,
                   thread_cpu_s=time.thread_time() - t0, recorder=on)
        if on:
            out.update(spans=rec.spans, counts=rec.counts)
        return out

    def judge(self, *args):
        return self.loop.judge(*args)

    def control(self, *args):
        return self.loop.control(*args)


def _stacks(intervals, points):
    """For each of the sorted ``points``, the names of the properly nested
    ``intervals`` [(start, end, name)], sorted by start and then by
    longest first, that contain it, outermost first."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(tuple(iv[2] for iv in stack))
    return out


def reduce_with_spans(events, out, reduce):
    """``reduce`` (``gpbench.harness.trace.reduce_events``), then the
    program's annotations as ``out.spans`` [(start_us, end_us, name)],
    and the idle seconds between device operations by the innermost span
    at each gap's midpoint (``idle_gaps_by_span``, the ten largest) and by
    every span open there (``idle_in_span``); ``idle_s`` their total."""
    from torch.autograd import DeviceType
    from gpbench.harness import trace
    events = list(events)
    reduce(events, out)
    dev, spans = [], []
    for e in events:
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            if e.device_type == DeviceType.CPU and \
                    e.name.startswith(PROGRAM_PREFIXES):
                spans.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
    out.spans = sorted(spans, key=lambda iv: (iv[0], -iv[1]))
    _, gaps = trace.busy_intervals(dev)
    gaps.sort(key=lambda g: g[0] + g[1])
    by_inner, by_any, idle = {}, {}, 0.0
    for (a, b), names in zip(gaps, _stacks(
            out.spans, [0.5 * (a + b) for a, b in gaps])):
        sec = (b - a) * 1e-6
        idle += sec
        inner = names[-1] if names else _OUTSIDE
        by_inner[inner] = by_inner.get(inner, 0.0) + sec
        for n in set(names):
            by_any[n] = by_any.get(n, 0.0) + sec
    out.idle_s = idle
    out.idle_in_span = by_any
    out.idle_gaps_by_span = [[k, v] for k, v in sorted(
        by_inner.items(), key=lambda kv: -kv[1])[:_TOP]]
    return out


@contextlib.contextmanager
def _additions(recorder, holder):
    """The harness with the additions above, for the enclosed block;
    ``holder["run"]`` gets the run's :class:`gpbench.harness.bench.Run`
    and ``holder["loop"]`` its loop."""
    from gpbench.harness import bench, trace
    make_loop, run_cls, reduce = bench.make_loop, bench.Run, \
        trace.reduce_events

    def spanned_loop(config, mix, device):
        loop = make_loop(config, mix, device)
        holder["loop"] = SpannedLoop(loop, recorder) if recorder else loop
        return holder["loop"]

    class KeptRun(run_cls):
        def __init__(self, *args):
            super().__init__(*args)
            holder["run"] = self

    bench.make_loop, bench.Run = spanned_loop, KeptRun
    trace.reduce_events = lambda events, out: reduce_with_spans(
        events, out, reduce)
    try:
        yield
    finally:
        bench.make_loop, bench.Run, trace.reduce_events = \
            make_loop, run_cls, reduce


def _job_summary(rec):
    out = {"clock_s": rec["clock_s"], "steps": rec.get("steps"),
           "recorder": rec.get("recorder", False)}
    for k in ("proc_cpu_s", "thread_cpu_s", "train_s", "predict_s"):
        if k in rec:
            out[k] = rec[k]
    if rec.get("spans"):
        secs, cpu = {}, {}
        for s in rec["spans"]:
            if s is None:
                continue
            secs[s.name] = secs.get(s.name, 0.0) + _seconds(s)
            if "cpu_ns" in s.attrs:
                cpu[s.name] = cpu.get(s.name, 0.0) + s.attrs["cpu_ns"] * 1e-9
        out.update(span_s=secs, span_thread_cpu_s=cpu,
                   waits=sum(rec["counts"].values()), counts=rec["counts"])
    return out


def run_spanned(workload, seed, seconds, trace, device, recorder=1,
                mix=None, config=None, t_start=None):
    """One run of the cell (``gpbench.harness.bench.run_cell``) with the
    additions, the recorder on in every ``recorder``-th job (0: never);
    returns (result line dict, the run, the numbers compared, the
    failures)."""
    from gpbench.harness import bench
    spec = bench.load_spec()
    holder = {}
    with _additions(recorder, holder):
        result, checks, failures = bench.run_cell(
            spec, workload, seed, seconds, trace, device,
            time.perf_counter() if t_start is None else t_start,
            mix=mix, config=config)
    run = holder["run"]
    run.warmup_spans = getattr(holder["loop"], "warmup_spans", None)
    values = {}
    for name in SPANNED[run.mix["loop"]]:
        v = READERS[name](run) if run.jobs else None
        if v is not None:
            values[name] = float(v)
    result["span_metrics"] = values
    counts = {}
    for j in _spanned(run.plain_jobs):
        for k, v in j["counts"].items():
            counts[k] = counts.get(k, 0) + v
    result["span_breakdown"] = {
        "idle_gaps_by_span": getattr(run.trace, "idle_gaps_by_span", None),
        "idle_s": getattr(run.trace, "idle_s", None),
        "waits_by_site": counts}
    result["jobs"] = [_job_summary(j) for j in run.jobs]
    result["warmup_parts"] = getattr(holder["loop"], "warmup_parts", None)
    return result, run, checks, failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--recorder", type=int, choices=(0, 1, 2), default=1)
    p.add_argument("--out")
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "gpbench", "cache",
                                       sub)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    torch.cuda.init()
    result, _, checks, failures = run_spanned(
        args.workload, args.seed, args.seconds, args.trace,
        torch.device("cuda"), args.recorder, t_start=T_START)
    for line in failures:
        print(line, file=sys.stderr)
    result["args"] = vars(args)
    result["power_limit"] = _power_limit()
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


def _power_limit():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
