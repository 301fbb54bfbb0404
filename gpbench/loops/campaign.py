"""
Bayesian-optimisation campaigns, back to back. A job is one
``boptimizer(...).run()`` (the configuration's ``entry["campaign"]``) whose
target is the harness's instrument, a callback with no dwell; its clock
runs from the constructor call to ``run()``'s return, and the instrument
records each wait: from the return of one measurement (or the campaign's
start) to the next call.

``judge`` lets the configuration's reference, in float64, measure the
pixels the campaign chose and judge each step; ``control`` is the
reference campaign in float32, below the configuration's float64.
"""

import os
import time

import numpy as np
import torch

from gpbench.harness import compare, find, traffic

# boptimizer always saves its results; they go here, inside the checkout
BO_DIR = os.path.normpath(os.path.join(find.HERE, os.pardir, "build",
                                       "gpbench", "bo"))

__all__ = ["Loop"]


class _Instrument:
    """The target as an instrument with no dwell: records the wait before
    each call."""

    def __init__(self, target):
        self.target = target
        self.waits = []
        self.last = None

    def __call__(self, idx):
        now = time.perf_counter()
        self.waits.append(now - self.last)
        value = traffic.target_value(self.target, idx)
        self.last = time.perf_counter()
        return value


class Loop:
    """Bayesian-optimisation campaigns, back to back."""

    def __init__(self, config, mix, device):
        self.config, self.mix, self.device = config, mix, device
        self.precision = config["precision"]
        self.jitter = float(config["jitter"]["campaign"])
        self.ref = find.load("reference", config["reference"])
        os.makedirs(BO_DIR, exist_ok=True)
        self.filename = os.path.join(BO_DIR, "boptim_results")

    def make_job(self, seed, purpose, index):
        return traffic.campaign_job(self.mix, seed, purpose, index)

    def _optimizer(self, job, instrument, steps, iterations, refit):
        from gpim_tpu_torch import utils
        grid = job["seed_grid"]
        return find.entry(self.config["entry"]["campaign"])(
            utils.get_sparse_grid(grid), grid.copy(),
            utils.get_full_grid(grid), instrument,
            acquisition_function=self.mix["acquisition"],
            exploration_steps=steps, batch_update=False,
            kernel=self.config["kernel"], gp_iterations=iterations,
            refit_iterations=refit,
            learning_rate=self.config["learning_rate"],
            use_gpu=self.device.type == "cuda", precision=self.precision,
            jitter=self.jitter, verbose=0, filename=self.filename)

    def warmup(self, job):
        w = self.mix["warmup"]
        inst = _Instrument(self.mix["target"])
        inst.last = time.perf_counter()
        self._optimizer(job, inst, int(w["exploration_steps"]),
                        int(w["gp_iterations"]),
                        int(w["refit_iterations"])).run()

    def run_job(self, job):
        inst = _Instrument(self.mix["target"])
        t0 = inst.last = time.perf_counter()
        bo = self._optimizer(job, inst, int(self.mix["exploration_steps"]),
                             int(self.mix["gp_iterations"]),
                             int(self.mix["refit_iterations"]))
        bo.run()
        t1 = time.perf_counter()
        shape = job["seed_grid"].shape
        rec = {"clock_s": t1 - t0, "steps": int(bo.steps_done),
               "waits": list(inst.waits),
               "choices": [int(np.ravel_multi_index(tuple(i), shape))
                           for i in bo.indices_all],
               "vals": [float(v) for v in bo.vals_all],
               "means": np.stack([np.ravel(p[0]) for p in bo.gp_predictions]),
               "sds": np.stack([np.ravel(p[1]) for p in bo.gp_predictions])}
        rec.update(compare.final_hp(bo.surrogate_model))
        return rec

    def _campaign(self, job, dtype, device, forced=None):
        """The reference campaign; with ``forced`` (flat indices), the
        pixel measured at each step is the forced one, and the step's own
        choice is kept beside it. Returns a record as :meth:`run_job`'s,
        plus each step's acquisition values ``acqs`` and own ``picks``."""
        mix, ref = self.mix, self.ref
        shape = job["seed_grid"].shape
        y_grid = job["seed_grid"].copy()
        b = ref.Bounds(shape, self.config["amplitude"])
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        Xt = t(ref.grid_rows(shape))
        u = ref.initial_u(b, dtype, device)
        lr = self.config["learning_rate"]
        chosen, picks, acqs, means, sds, vals = [], [], [], [], [], []
        steps = int(mix["exploration_steps"])
        for e in range(steps):
            X, y = ref.observed_rows(y_grid)
            X, y = t(X), t(y)
            u, _ = ref.train(X, y, b, u, lr=lr, jitter=self.jitter,
                             iterations=int(mix["gp_iterations"] if e == 0
                                            else mix["refit_iterations"]))
            mean, sd = ref.predict(X, y, b, u, Xt, jitter=self.jitter)
            measured = torch.as_tensor(~np.isnan(y_grid).ravel(),
                                       device=device)
            acq = ref.expected_improvement(mean, sd, measured)
            pick = ref.choose(acq, set(chosen))
            take = pick if forced is None else int(forced[e])
            picks.append(pick)
            acqs.append(acq.cpu().double().numpy())
            means.append(mean.cpu().double().numpy())
            sds.append(sd.cpu().double().numpy())
            vals.append(float(acqs[-1][pick]) if pick is not None
                        else float("nan"))
            chosen.append(take)
            idx = np.unravel_index(take, shape)
            y_grid[idx] = traffic.target_value(mix["target"], idx)
        X, y = ref.observed_rows(y_grid)
        u, _ = ref.train(t(X), t(y), b, u, lr=lr, jitter=self.jitter,
                         iterations=int(mix["refit_iterations"]))
        rec = {"choices": chosen, "picks": picks, "vals": vals,
               "acqs": np.stack(acqs), "means": np.stack(means),
               "sds": np.stack(sds)}
        rec.update(ref.hyperparams(u, b))
        return rec

    def control(self, job, device):
        """The reference campaign in float32, one precision below the
        configuration's float64."""
        return self._campaign(job, torch.float32, device)

    def judge(self, job, rec, device):
        """The reference follows the pixels the record measured and judges
        each step: the widest gaps of the posterior mean and sd over the
        grid, of the acquisition value at the chosen pixel (against the
        step's largest), the regret of the chosen pixel under the
        reference's acquisition, and the final hyperparameters."""
        steps = int(self.mix["exploration_steps"])
        if len(rec["choices"]) != steps or len(rec["vals"]) != steps:
            # a campaign that skipped steps: a number with limit 0 fails
            return {"steps_missing": float(abs(steps - len(rec["vals"]))
                                           + 1)}
        good = self._campaign(job, torch.float64, device,
                              forced=rec["choices"])
        acq_gap = regret = 0.0
        for e in range(steps):
            a = good["acqs"][e]
            top = a[good["picks"][e]]
            scale = max(top, np.finfo(float).tiny)
            acq_gap = max(acq_gap, abs(rec["vals"][e]
                                       - a[rec["choices"][e]]) / scale)
            regret = max(regret, (top - a[rec["choices"][e]]) / scale)
        numbers = compare.hp_gaps(rec, good, self.jitter)
        numbers.update({
            "mean_gap": float(np.max(np.abs(rec["means"] - good["means"]))),
            "sd_gap": float(np.max(np.abs(rec["sds"] - good["sds"]))),
            "acq_gap": float(acq_gap), "choice_regret": float(regret)})
        return compare.finite(numbers)
