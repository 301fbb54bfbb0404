#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` for the program, for its
control and for planted faults on many seeds in one process, to set a
cell's limits:

    python3 gpbench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--faults half_rows ...] [--out FILE]

For each seed the window's first job is run through the program at the
cell's sizes and judged by the float64 reference. For each control seed
the reference, one precision below the configuration's, takes the
program's place and is judged the same way, and so is the program with
each fault of :mod:`gpbench.harness.faults` planted. Prints a JSON line a
reading and, last, the largest reading of the program and the smallest of
the control and of each fault for each number. Needs the card; the
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    import torch
    from gpbench.harness import bench, faults, traffic
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[],
                   help="faults of gpbench.harness.faults, each planted "
                   "in the program on every control seed")
    p.add_argument("--precision", help="run the program, and take the "
                   "control, at this precision instead of the "
                   "configuration's (a look at a cause)")
    p.add_argument("--jitter", type=float, help="with --precision, the "
                   "jitter that the program and the reference take in "
                   "it (the program's default for that precision)")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    _, config, mix, _ = bench.cell(bench.load_spec(), args.workload)
    if args.precision:
        config = dict(config, precision=args.precision)
    if args.jitter is not None:
        config = dict(config, jitter=dict.fromkeys(config["jitter"],
                                                   args.jitter))
    loop = bench.make_loop(config, mix, device)
    loop.warmup(loop.make_job(0, traffic.WARMUP, 0))
    lines = []
    runs = [("program", s) for s in args.seeds] + [
        ("control", s) for s in args.control_seeds] + [
        (f, s) for f in args.faults for s in args.control_seeds]
    for who, seed in runs:
        job = loop.make_job(seed, traffic.WINDOW, 0)
        t0 = time.perf_counter()
        try:
            if who == "control":
                rec = loop.control(job, device)
            elif who == "program":
                rec = loop.run_job(job)
            else:
                with faults.FAULTS[who]():
                    rec = loop.run_job(job)
        except (RuntimeError, ValueError) as exc:
            line = {"who": who, "seed": seed, "error": "%s: %s" % (
                type(exc).__name__, exc)}
        else:
            t1 = time.perf_counter()
            line = {"who": who, "seed": seed, "run_s": t1 - t0,
                    "numbers": loop.judge(job, rec, device),
                    "judge_s": time.perf_counter() - t1}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {}
    for who, pick in [("program", max), ("control", min)] + [
            (f, min) for f in args.faults]:
        got = {}
        for line in lines:
            if line["who"] == who and "numbers" in line:
                for k, v in line["numbers"].items():
                    got[k] = pick(got.get(k, v), v)
        summary[who] = got
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"lines": lines, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
