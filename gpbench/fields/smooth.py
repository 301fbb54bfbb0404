"""A band-limited random field in [0, 1]: white noise damped in Fourier
space by a Gaussian of ``sigma`` grid units an axis (the stand-in scan of
the port's examples)."""

import numpy as np


def make(shape, params, rng):
    f = rng.standard_normal(shape)
    for ax, s in enumerate(params["sigma"]):
        if s <= 0:
            continue
        n = shape[ax]
        damp = np.exp(-0.5 * (2 * np.pi * np.fft.rfftfreq(n) * s) ** 2)
        f = np.fft.irfft(np.fft.rfft(f, axis=ax) * damp.reshape(
            [-1 if a == ax else 1 for a in range(f.ndim)]), n=n, axis=ax)
    return (f - f.min()) / (f.max() - f.min())
