#!/usr/bin/env python3
"""
Which CUDA kernel events a ``torch.profiler`` trace of the flagship loses,
on one CUDA card.

    python3 tools/trace_repro.py [--rounds N]

It builds the flagship (the 128x128 spiral, exact RBF, float32) at
``STEPS`` training steps, a new model a run, runs it twice untraced, then
traces it ``--rounds`` times with each window, the windows taking turns,
each run written as a Chrome trace and read back:

- ``parent``: ``torch.profiler.profile`` entered and exited around the
  block with nothing before or after, as ``utils.profiling.trace`` opened
  it before its repair: the control that shows the loss;
- ``trace``: ``gpim_tpu_torch.utils.profiling.trace`` as it is now.

The block is ``model.run()`` and a synchronisation. For every run the
record holds the kernels the run launched (K1, K2, K3 by the wrappers'
counters), the kernel events the trace holds (all of them, and K1/K2/K3),
the CUDA launch calls whose kernel event is missing (matched by CUPTI's
correlation id) and where the missing events sit in the longest trace's
kernel sequence: at its head, its tail or in the middle; and, in
microseconds, the first launch call and the first kernel after the
window's start, the window's end after the last kernel's, and the least
and the median of each kernel's start less its launch call's (negative:
the kernel's timestamp, placed on the host's clock, lies before its own
launch). Prints one line a run and a summary by window, and writes the
record to ``build/trace_repro/report.json``.
"""

import argparse
import contextlib
import difflib
import glob
import json
import os
import shutil
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10                 # training steps a traced run
KERNEL_KEYS = (("sqdist_kernel", "sqdist"),
               ("masked_system_kernel", "masked_system"),
               ("rbf_bwd_kernel", "rbf_bwd_reductions"))
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


@contextlib.contextmanager
def _window_parent(logdir):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "run.pt.trace.json"))


@contextlib.contextmanager
def _window_trace(logdir):
    from gpim_tpu_torch.utils.profiling import trace
    with trace(logdir):
        yield


VARIANTS = {"parent": _window_parent, "trace": _window_trace}


def log(msg):
    print(msg, flush=True)


def _short(name):
    for key, short in KERNEL_KEYS:
        if key in name:
            return short
    return name[:48]


def read_trace(logdir):
    """(the kernel events' short names in time order, the launch calls'
    correlation ids with no kernel event, the count of launch calls)."""
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError("%d trace files in %s" % (len(files), logdir))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    by_corr = {e.get("args", {}).get("correlation"): e for e in kernels}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and e.get("name") in LAUNCH_CALLS),
                      key=lambda e: e["ts"])
    lost = [e for e in launches
            if e.get("args", {}).get("correlation") not in by_corr]
    start = min(e["ts"] for e in events
                if e.get("name") == "Iteration Start: PyTorch Profiler")
    end = max(e["ts"] for e in events
              if e.get("name") == "Record Window End")
    # the kernels' start less their launch calls' (negative: the kernel's
    # clock runs behind the host's), and the block's edges against the
    # window's, all in microseconds
    lead = [by_corr[c]["ts"] - e["ts"] for e in launches
            for c in [e.get("args", {}).get("correlation")] if c in by_corr]
    times = {
        "first_launch_after_start": launches[0]["ts"] - start,
        "first_kernel_after_start": kernels[0]["ts"] - start,
        "window_end_after_last_kernel": end - max(
            e["ts"] + e.get("dur", 0) for e in kernels),
        "kernel_after_launch_min": min(lead),
        "kernel_after_launch_median": sorted(lead)[len(lead) // 2],
        "lost_launches_after_start": [e["ts"] - start for e in lost],
    }
    return ([_short(e["name"]) for e in kernels],
            [e["args"]["correlation"] for e in lost], len(launches), times)


def _where(missing, n):
    """'head', 'tail', 'middle' or 'none' for the missing positions of a
    sequence of length n."""
    if not missing:
        return "none"
    head = missing == list(range(len(missing)))
    tail = missing == list(range(n - len(missing), n))
    return "head" if head else "tail" if tail else "middle"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, _ROOT)
    import torch
    from gpim_tpu_torch import reconstructor, utils
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch.ops import gram_kernels as gk
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the reproduction needs one")
    log("[trace_repro] %s, torch %s" % (torch.cuda.get_device_name(0),
                                        torch.__version__))
    R = _data.spiral_scan()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)

    def model():
        # a new model a run: run() trains on from the model's parameters
        return reconstructor(X, R, X_full, kernel="RBF", precision="single",
                             iterations=STEPS, verbose=0)

    # K2 and K3 each Adam step; K1 for the training Gram and once a
    # 4096-point test chunk
    expected = {"sqdist": 1 + -(-X_full[0].size // 4096),
                "masked_system": STEPS, "rbf_bwd_reductions": STEPS}
    for _ in range(2):
        model().run()
    runs = []
    for r in range(args.rounds):
        for v in VARIANTS:
            logdir = tempfile.mkdtemp(prefix="trace_repro_")
            try:
                m = model()
                torch.cuda.synchronize()
                for _, k in KERNEL_KEYS:
                    getattr(gk, k).launches = 0
                with VARIANTS[v](logdir):
                    m.run()
                    torch.cuda.synchronize()
                launched = {k: getattr(gk, k).launches
                            for _, k in KERNEL_KEYS}
                names, lost, n_calls, times = read_trace(logdir)
            finally:
                shutil.rmtree(logdir, ignore_errors=True)
            found = {short: names.count(short) for _, short in KERNEL_KEYS}
            runs.append({"round": r, "variant": v, "names": names,
                         "lost_correlations": lost, "launch_calls": n_calls,
                         "us": times,
                         "found": found, "launched": launched})
    ref = max((run["names"] for run in runs), key=len)
    summary = {}
    for run in runs:
        sm = difflib.SequenceMatcher(None, ref, run["names"], autojunk=False)
        missing = [i for tag, i1, i2, _, _ in sm.get_opcodes()
                   if tag in ("delete", "replace") for i in range(i1, i2)]
        run.update(missing=missing, where=_where(missing, len(ref)),
                   complete=run["found"] == run["launched"]
                   and run["launched"] == expected)
        names = run.pop("names")
        run["kernel_events"] = len(names)
        log(
            "[trace_repro] round %2d %-6s kernel events %d of %d, K1/K2/K3 "
            "%s (launched %s), launch calls with no kernel event %d, "
            "missing positions %s (%s); us %s" % (
                run["round"], run["variant"], len(names), len(ref),
                run["found"], run["launched"], len(run["lost_correlations"]),
                run["missing"][:24], run["where"], json.dumps({
                    k: v if isinstance(v, list) else round(v, 1)
                    for k, v in run["us"].items()})))
        s = summary.setdefault(run["variant"], {
            "runs": 0, "complete": 0, "where": {}, "events_lost": 0})
        s["runs"] += 1
        s["complete"] += run["complete"]
        s["where"][run["where"]] = s["where"].get(run["where"], 0) + 1
        s["events_lost"] += len(run["missing"])
    log("[trace_repro] longest trace: %d kernel events" % len(ref))
    log("[trace_repro] summary " + json.dumps(summary))
    out = os.path.join(_ROOT, "build", "trace_repro")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump({"reference_events": len(ref), "summary": summary,
                   "runs": runs}, f, indent=1)


if __name__ == "__main__":
    main()
