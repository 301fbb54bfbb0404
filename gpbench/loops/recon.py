"""
Reconstruction jobs, one at a time (a closed loop, as on the microscope's
workstation). A job builds the configuration's ``entry["recon"]`` (a
``reconstructor``) from the scan's numpy arrays and calls ``.train()`` and
``.predict()``, which is what ``.run()`` does; its clock runs from the grid
preparation to mean and sd on the host.

``judge`` runs the configuration's reference in float64 on the job's scan
and gives the numbers compared; ``control`` gives the answers of the
reference put in the program's place one precision below the
configuration's (TF32 products for float32 with TF32 off, float32 for
float64).
"""

import time

import numpy as np
import torch

from gpbench.harness import compare, find, traffic

__all__ = ["Loop"]


class Loop:
    """Train on the scan, predict the whole grid."""

    def __init__(self, config, mix, device):
        self.config, self.mix, self.device = config, mix, device
        self.precision = config["precision"]
        self.jitter = float(config["jitter"]["recon"])
        self.ref = find.load("reference", config["reference"])

    def make_job(self, seed, purpose, index):
        return traffic.recon_job(self.mix, seed, purpose, index)

    def _model(self, R, iterations):
        from gpim_tpu_torch import utils
        X = utils.get_sparse_grid(R)
        Xf = utils.get_full_grid(R)
        return find.entry(self.config["entry"]["recon"])(
            X, R, Xf, kernel=self.config["kernel"],
            learning_rate=self.config["learning_rate"],
            iterations=iterations, use_gpu=self.device.type == "cuda",
            verbose=0, precision=self.precision, jitter=self.jitter,
            amplitude=list(self.config["amplitude"]))

    def warmup(self, job):
        model = self._model(job["R"], int(self.mix["warmup_iterations"]))
        model.train()
        model.predict()

    def run_job(self, job):
        """Run one job; returns its record: clock and spans in seconds,
        sizes, and the answers (numpy)."""
        t0 = time.perf_counter()
        model = self._model(job["R"], int(self.mix["iterations"]))
        t1 = time.perf_counter()
        model.train()
        t2 = time.perf_counter()
        mean, sd = model.predict()
        t3 = time.perf_counter()
        rec = {"clock_s": t3 - t0, "prep_s": t1 - t0, "train_s": t2 - t1,
               "predict_s": t3 - t2, "steps": int(self.mix["iterations"]),
               "n_obs": int(np.sum(~np.isnan(job["R"]))),
               "n_test": int(job["R"].size), "dims": job["R"].ndim,
               "itemsize": 4 if self.precision == "single" else 8,
               "mean": mean, "sd": sd, "loss": float(model.losses[-1])}
        rec.update(compare.final_hp(model))
        return rec

    def _reference(self, R, dtype, device):
        ref = self.ref
        X, y = ref.observed_rows(R)
        b = ref.Bounds(R.shape, self.config["amplitude"])
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        X, y = t(X), t(y)
        u, losses = ref.train(X, y, b, ref.initial_u(b, dtype, device),
                              lr=self.config["learning_rate"],
                              iterations=int(self.mix["iterations"]),
                              jitter=self.jitter)
        mean, sd = ref.predict(X, y, b, u, t(ref.grid_rows(R.shape)),
                               jitter=self.jitter)
        out = ref.hyperparams(u, b)
        out["loss"] = float(losses[-1])
        out["mean"] = mean.cpu().double().numpy().reshape(R.shape)
        out["sd"] = sd.cpu().double().numpy().reshape(R.shape)
        return out

    def control(self, job, device):
        """The reference's answers one precision below the job's."""
        if self.precision == "single":
            with self.ref.tf32(True):
                return self._reference(job["R"], torch.float32, device)
        return self._reference(job["R"], torch.float32, device)

    def judge(self, job, rec, device):
        """The numbers compared: the relative gaps of the trained
        lengthscales, variance and noise and of the last step's loss, and
        the widest gaps of the mean and sd over the whole grid."""
        good = self._reference(job["R"], torch.float64, device)
        numbers = compare.hp_gaps(rec, good, self.jitter)
        numbers["loss_gap"] = abs(rec["loss"] - good["loss"]) / abs(
            good["loss"])
        numbers["mean_gap"] = float(np.max(np.abs(rec["mean"]
                                                  - good["mean"])))
        numbers["sd_gap"] = float(np.max(np.abs(rec["sd"] - good["sd"])))
        return compare.finite(numbers)
