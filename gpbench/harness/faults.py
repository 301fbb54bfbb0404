"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that breaks one thing in the program and
puts it back on exit.

- ``adam_unchanged``: an Adam step that returns its state unchanged;
- ``half_rows``: half of the observations left out of the training set;
- ``mean_shift``: the predictive mean altered where it is produced, by
  0.05 (a twentieth of the data's range);
- ``choice_swap``: the acquisition ranking's best two pixels swapped, so
  the campaign measures the second best.
"""

import contextlib

import torch

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def adam_unchanged():
    with _patched(torch.optim.Adam, "step", lambda self, *a, **k: None):
        yield


@contextlib.contextmanager
def half_rows():
    from gpim_tpu_torch.utils import gridutils
    real = gridutils.prepare_training_data

    def half(X, y=None, **kw):
        Xn, yn = real(X, y, **kw)
        return Xn[::2], (None if yn is None else yn[::2])
    with _patched(gridutils, "prepare_training_data", half):
        yield


@contextlib.contextmanager
def mean_shift():
    from gpim_tpu_torch.gpreg import engine
    real = engine.predict_exact

    def shifted(*a, **k):
        mean, var = real(*a, **k)
        return mean + 0.05, var
    with _patched(engine, "predict_exact", shifted):
        yield


@contextlib.contextmanager
def choice_swap():
    from gpim_tpu_torch.gpbayes import boptim
    real = boptim._top_k

    def swapped(macq, k):
        vals, order = real(macq, k)
        idx = [1, 0] + list(range(2, len(vals)))
        return vals[idx], order[idx]
    with _patched(boptim, "_top_k", swapped):
        yield


FAULTS = {"adam_unchanged": adam_unchanged, "half_rows": half_rows,
          "mean_shift": mean_shift, "choice_swap": choice_swap}
