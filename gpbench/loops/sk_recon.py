"""
Masked-lattice SKI reconstruction jobs, one at a time (a closed loop, as on
the microscope's workstation). A job builds the configuration's
``entry["sk_recon"]`` (an ``skreconstructor`` with ``ski=True``) from the
scan's numpy arrays and calls ``.train()`` and ``.predict()``; its clock
runs from the grid preparation to mean and sd on the host. The route's own
defaults apply; the configuration's ``options`` are passed on (none in the
cell; the CPU tests shrink the problem with them).

Each job runs with the program's span recorder on
(:func:`gpim_tpu_torch.utils.profiling.spans`). Its record keeps the
seconds and the count of the spans by name (``spans``) and the host waits
by site (``waits``); a program without a span leaves it out, and the
metrics that read it give None. The realized CG iterations of training and
prediction and the training segments come from the engine's own counts
(``cg_iters``, ``predict_cg_iters``, ``train_segments``). The cell's
end-to-end metric, ``bo_device_ms_per_step``, divides the window's device
seconds by the ``steps`` (Adam steps) of the records that hold ``waits``,
so every record holds both.

``judge`` runs the configuration's reference in float64 on the job's scan,
with the training segments the program's job recorded, and gives the
numbers compared; ``control`` gives the answers of the reference in the
program's place in float32 with TF32 products.

Loading this loop adds its cell's faults to
:data:`gpbench.harness.faults.FAULTS`: ``cg_capped`` (CG stops after 2
iterations), ``half_probes`` (4 probes where the configuration states 8)
and ``sk_mean_shift`` (the lattice's predictive mean moved by 0.05 where
it is produced); ``adam_unchanged`` applies as it is.
"""

import contextlib
import time

import numpy as np
import torch

from gpbench.harness import compare, faults, find, traffic

__all__ = ["Loop"]


class Loop:
    """Train on the scan, predict the whole lattice."""

    def __init__(self, config, mix, device):
        self.config, self.mix, self.device = config, mix, device
        self.precision = config["precision"]
        self.jitter = float(config["jitter"]["sk_recon"])
        self.ref = find.load("reference", config["reference"])

    def make_job(self, seed, purpose, index):
        return traffic.recon_job(self.mix, seed, purpose, index)

    def _model(self, R, iterations):
        from gpim_tpu_torch import utils
        X = utils.get_sparse_grid(R)
        Xf = utils.get_full_grid(R)
        model = find.entry(self.config["entry"]["sk_recon"])(
            X, R, Xf, kernel=self.config["kernel"], ski=True,
            learning_rate=self.config["learning_rate"],
            iterations=iterations, use_gpu=self.device.type == "cuda",
            verbose=0, precision=self.precision,
            **self.config.get("options", {}))
        if model._mgrid_engine is None:
            raise ValueError("the scan did not take the masked-lattice route")
        return model

    def warmup(self, job):
        model = self._model(job["R"], int(self.mix["warmup_iterations"]))
        model.train()
        model.predict()

    def run_job(self, job):
        """Run one job; returns its record: clock and phases in seconds,
        sizes, the spans and waits, and the answers (numpy)."""
        from gpim_tpu_torch.utils import profiling
        with profiling.spans() as spans:
            t0 = time.perf_counter()
            model = self._model(job["R"], int(self.mix["iterations"]))
            t1 = time.perf_counter()
            model.train()
            t2 = time.perf_counter()
            mean, sd = model.predict()
            t3 = time.perf_counter()
        eng = model._mgrid_engine
        rec = {"clock_s": t3 - t0, "prep_s": t1 - t0, "train_s": t2 - t1,
               "predict_s": t3 - t2, "steps": int(self.mix["iterations"]),
               "grid": list(job["R"].shape),
               "n_obs": int(np.sum(~np.isnan(job["R"]))),
               "probes": int(eng._g0.shape[0]), "rank": eng.precond_rank,
               "itemsize": 4 if self.precision == "single" else 8,
               "train_segments": list(eng.last_segments),
               "cg_iters": int(eng.last_cg_iters.sum()),
               "predict_cg_iters": int(eng.last_predict_cg_iters),
               "mean": mean, "sd": sd,
               "losses": np.asarray(model.losses, np.float64),
               "variance": float(torch.nn.functional.softplus(
                   model.u["outputscale"].double()).reshape(-1)[0])}
        rec.update(_span_record(spans))
        hp = model.hyperparams
        rec["lengthscale"] = np.ravel(hp["lengthscale"][-1]).astype(float)
        rec["noise"] = float(np.ravel(hp["noise"][-1])[0])
        return rec

    def _reference(self, R, segments, dtype, device):
        ref, cfg = self.ref, self.config
        out = ref.train(R, segments, lr=cfg["learning_rate"],
                        jitter=self.jitter, n_probes=int(cfg["n_probes"]),
                        rank=int(cfg["precond_rank"]),
                        seed=int(cfg["probe_seed"]), dtype=dtype,
                        device=device)
        mean, sd, _ = ref.predict(out["lat"], out["u"], jitter=self.jitter,
                                  rank=int(cfg["precond_rank"]))
        hp = ref.hyperparams(out["u"], out["lat"])
        hp.update(mean=mean.cpu().double().numpy(),
                  sd=sd.cpu().double().numpy(), losses=out["losses"],
                  max_cg=out["max_cg"])
        return hp

    def control(self, job, device):
        """The reference's answers in float32 with TF32 products, on the
        training segments of the program's own run of the job."""
        segments = self.run_job(job)["train_segments"]
        with self.ref.tf32(True):
            out = self._reference(job["R"], segments, torch.float32, device)
        out["train_segments"] = segments
        return out

    def judge(self, job, rec, device):
        """The numbers compared: the relative gaps of the trained
        lengthscales, outputscale and noise, the largest relative gap of
        the recorded losses, and the widest gaps of the mean and sd over
        the lattice."""
        with self.ref.tf32(False):
            good = self._reference(job["R"], rec["train_segments"],
                                   torch.float64, device)
        numbers = compare.hp_gaps(rec, good, self.jitter)
        losses = np.asarray(rec["losses"], np.float64)
        numbers["loss_gap"] = (float(np.max(np.abs(losses - good["losses"])
                                            / np.abs(good["losses"])))
                               if losses.shape == good["losses"].shape
                               else float("inf"))
        numbers["mean_gap"] = float(np.max(np.abs(rec["mean"]
                                                  - good["mean"])))
        numbers["sd_gap"] = float(np.max(np.abs(rec["sd"] - good["sd"])))
        return compare.finite(numbers)


def _span_record(rec):
    """{spans: {name: [seconds, count]}, waits: {site: count}} of a
    recorder."""
    spans = {}
    for s in rec.spans:
        if s is None:
            continue
        sec, n = spans.get(s.name, (0.0, 0))
        spans[s.name] = (sec + (s.end_ns - s.start_ns) * 1e-9, n + 1)
    return {"spans": {k: list(v) for k, v in spans.items()},
            "waits": dict(rec.counts)}


@contextlib.contextmanager
def _engine_changed(change):
    """Every masked-lattice engine built inside the block is changed by
    ``change(engine)`` once its constructor returns."""
    from gpim_tpu_torch.gpreg import mgrid_model
    cls = mgrid_model.MaskedGridEngine
    real = cls.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        change(self)
    with faults._patched(cls, "__init__", init):
        yield


def cg_capped():
    return _engine_changed(lambda eng: setattr(eng, "cg_iters", 2))


def half_probes():
    return _engine_changed(lambda eng: setattr(
        eng, "_g0", eng._g0[:eng._g0.shape[0] // 2]))


@contextlib.contextmanager
def sk_mean_shift():
    from gpim_tpu_torch.gpreg import mgrid_model
    real = mgrid_model._predict_grid

    def shifted(*a, **k):
        mean, var = real(*a, **k)
        return mean + 0.05, var
    with faults._patched(mgrid_model, "_predict_grid", shifted):
        yield


for _f in (cg_capped, half_probes, sk_mean_shift):
    faults.FAULTS.setdefault(_f.__name__, _f)
