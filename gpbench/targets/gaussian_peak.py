"""A campaign's target: exp(-|idx - center|^2 / width2) at grid index
``idx``."""

import math


def value(params, idx):
    d2 = sum((float(i) - float(c)) ** 2
             for i, c in zip(idx, params["center"]))
    return math.exp(-d2 / float(params["width2"]))
