"""Pieces that the loops' comparisons share: the trained hyperparameters
as numbers, and their relative gaps from the reference's."""

import numpy as np

__all__ = ["final_hp", "hp_gaps", "finite"]


def final_hp(model):
    """The last trained {lengthscale (d,), variance, noise} of a model of
    the program, as float64 numpy."""
    hp = model.hyperparams
    return {"lengthscale": np.ravel(hp["lengthscale"][-1]).astype(float),
            "variance": float(np.ravel(hp["variance"][-1])[0]),
            "noise": float(np.ravel(hp["noise"][-1])[0])}


def hp_gaps(rec, hp, jitter):
    """Relative gaps of the trained hyperparameters; the noise's against
    noise + jitter, the diagonal it enters the model by."""
    return {
        "ls_gap": float(np.max(np.abs(np.asarray(rec["lengthscale"])
                                      - hp["lengthscale"])
                               / hp["lengthscale"])),
        "var_gap": abs(rec["variance"] - hp["variance"]) / hp["variance"],
        "noise_gap": abs(rec["noise"] - hp["noise"]) / (hp["noise"]
                                                        + jitter),
    }


def finite(numbers):
    """The numbers as floats, a NaN or an infinity as infinity (which
    fails any limit)."""
    return {k: (float(v) if np.isfinite(v) else float("inf"))
            for k, v in numbers.items()}
