"""
One run of one benchmark cell: set-up, the measured window, the check of
the answers against the plain reference, and the result line.

Everything a cell needs is found by name (:mod:`gpbench.harness.find`),
from ``BENCHMARK.json`` down: the configuration's file, which names the
program's entry points and its reference (``reference/<name>.py``); the
traffic mix (``traffic/<traffic>.json``, read by
:mod:`gpbench.harness.traffic`), which names its loop
(``loops/<loop>.py``, a class ``Loop``); the limits of the numbers
compared (``limits/<workload>.json``); and one reader a metric
(``metrics/<metric>.py``, a function ``read(run)`` returning the value, or
None where it finds nothing to read).
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpim_tpu")

__all__ = ["load_spec", "cell", "make_loop", "Run", "run_cell", "main"]


def load_spec(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(spec, workload):
    """(workload entry, configuration, traffic mix, limits) of one cell."""
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    cfg = {x["name"]: x for x in spec["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    return (w, config, _json("traffic", w["traffic"] + ".json"),
            _json("limits", workload + ".json"))


def metrics_for(spec, workload, kind):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that this
    cell reports."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def read_metric(name, run):
    """The value of metric ``name`` by its reader, or None."""
    from gpbench.harness import find
    return find.load("metrics", name).read(run)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run measured, as the metric readers see it: ``jobs`` (the
    records of the jobs that completed), ``plain_jobs`` (those outside the
    traced part), ``trace`` (:class:`gpbench.harness.trace.Trace` of the
    traced part, or None), ``traced`` (the traced job's record),
    ``window_trace`` (the device operations of the whole window, where an
    end-to-end metric of the cell reads the device trace, or None),
    ``setup_s``, ``window_peak_bytes``, and the cell's ``config`` and
    ``mix``."""

    def __init__(self, config, mix):
        self.config, self.mix = config, mix
        self.jobs = []
        self.trace = self.traced = self.window_trace = None
        self.setup_s = None
        self.window_peak_bytes = None

    @property
    def plain_jobs(self):
        return [j for j in self.jobs if j is not self.traced] or self.jobs


def make_loop(config, mix, device):
    """The loop that the traffic mix names, for this configuration."""
    from gpbench.harness import find
    return find.load("loops", mix["loop"]).Loop(config, mix, device)


def run_cell(spec, workload, seed, seconds, trace, device, t_start,
             mix=None, config=None):
    """Run one cell once; returns (result dict, the numbers compared as
    {name: (value, limit)}, the failed jobs' errors). ``mix`` and
    ``config`` replace the cell's traffic mix and configuration (the tests
    run small ones on the CPU)."""
    import torch
    from gpbench.harness import traffic
    w, cell_config, cell_mix, limits = cell(spec, workload)
    mix = cell_mix if mix is None else mix
    config = cell_config if config is None else config
    cuda = device.type == "cuda"
    loop = make_loop(config, mix, device)

    # set-up: the kernel library from its build directory, one short job
    # at the cell's own shapes
    t_warm = time.perf_counter()
    loop.warmup(loop.make_job(seed, traffic.WARMUP, 0))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = Run(config, mix)
    # an end-to-end metric read from the device trace: the card's
    # operations over the whole window, recorded from before its clock
    # starts to after all its work has ended
    window = contextlib.ExitStack()
    t_trace = time.perf_counter()
    if cuda and not trace and any(
            m["source"] == "device_trace"
            for m in metrics_for(spec, workload, "end_to_end")):
        from gpbench.harness.trace import device_window
        run.window_trace = window.enter_context(device_window())
    t_window = time.perf_counter()
    run.setup_s = t_window - t_start
    run.setup_parts = {"to_warmup_s": t_warm - t_start,
                       "warmup_s": t_trace - t_warm,
                       "device_trace_start_s": t_window - t_trace}

    failures, records = [], []
    with window:
        while not records or time.perf_counter() - t_window < seconds:
            index = len(records)
            job = loop.make_job(seed, traffic.WINDOW, index)
            try:
                if trace and cuda and index == 0:
                    from gpbench.harness.trace import traced
                    with traced() as tr:
                        rec = loop.run_job(job)
                    run.trace, run.traced = tr, rec
                else:
                    rec = loop.run_job(job)
            except (RuntimeError, ValueError) as exc:  # torch.linalg's too
                failures.append("job %d: %s: %s" % (
                    index, type(exc).__name__, exc))
                rec = None
            records.append(rec)
        if cuda:
            torch.cuda.synchronize()
            run.window_peak_bytes = torch.cuda.max_memory_allocated()
        t_closed = time.perf_counter()
    run.jobs = [r for r in records if r is not None]
    t_window_read = time.perf_counter()
    if run.trace is not None:
        run.trace.finish()
    t_read = time.perf_counter()

    # the metrics, read before the reference runs
    kind = "per_layer" if trace else "end_to_end"
    values = {}
    if run.jobs:
        for m in metrics_for(spec, workload, kind):
            v = read_metric(m["name"], run)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    # the check: a sample of the jobs drawn from the seed, once the
    # program's state is freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = traffic.job_rng(seed, traffic.SAMPLE, 0)
    picks = rng.choice(len(records), replace=False,
                       size=min(int(mix.get("check_jobs", 1)), len(records)))
    checks = {}
    for i in sorted(picks.tolist()):
        if records[i] is None:
            continue
        numbers = loop.judge(loop.make_job(seed, traffic.WINDOW, i),
                             records[i], device)
        for name, v in numbers.items():
            old = checks.get(name, (-1.0, None))[0]
            checks[name] = (max(old, v), float(limits.get(name, 0.0)))
    run.after_window = {"window_trace_read_s": t_window_read - t_closed,
                        "window_device_ops": (run.window_trace.launches
                                              if run.window_trace else 0),
                        "trace_read_s": t_read - t_window_read,
                        "check_s": time.perf_counter() - t_read}
    correct = (not failures and bool(checks)
               and all(v <= lim for v, lim in checks.values()))

    result = {"correct": bool(correct), "attempted": len(records),
              "failed": len(failures), "metrics": values,
              "setup_parts": run.setup_parts,
              "after_window": run.after_window,
              "job_clocks": [r["clock_s"] for r in run.jobs]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": peak}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in sorted(checks.items())}
    return result, checks, failures


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec()
    w = {x["name"]: x for x in spec["workloads"]}.get(args.workload)
    if w is None:
        print("unknown workload %r" % args.workload, file=sys.stderr)
        return 2
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print("this cell needs %d CUDA device(s); found %d" % (
            w["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    torch.cuda.init()
    t_cuda = time.perf_counter()
    result, checks, failures = run_cell(
        spec, args.workload, args.seed, args.seconds, args.trace,
        torch.device("cuda"), t_start)
    result["setup_parts"].update(import_torch_s=t_torch - t_start,
                                 cuda_init_s=t_cuda - t_torch)
    bad = forbidden_modules()
    if bad:
        print("modules the benchmark may not load: %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for line in failures:
        print(line, file=sys.stderr)
    print("setup: %s" % json.dumps(result.pop("setup_parts")),
          file=sys.stderr)
    print("after the window: %s" % json.dumps(result.pop("after_window")),
          file=sys.stderr)
    print("job clocks (s): %s" % json.dumps(result.pop("job_clocks")),
          file=sys.stderr)
    for name, (v, lim) in sorted(checks.items()):
        print("check %s %r limit %r" % (name, v, lim), file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
