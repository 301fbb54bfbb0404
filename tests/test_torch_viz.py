"""
gpim_tpu_torch.utils' plotting helpers: the twin of tests/test_viz.py on
the port, each plot held against gpim_tpu.utils.viz on the same seeded
inputs (every figure's axes: titles, labels, limits, scales, line data,
image arrays, scatter offsets and colours, texts, exactly), the ten names
resolving lazily from gpim_tpu_torch.utils, and the package importing
without matplotlib, a plot name then raising ImportError.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gpim_tpu.utils import viz as jviz  # noqa: E402

import gpim_tpu_torch  # noqa: E402
from gpim_tpu_torch import utils  # noqa: E402
from gpim_tpu_torch.utils import viz  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


def _hyperparams(rng, iters=6, d=2):
    return {"lengthscale": np.abs(rng.rand(iters, d)) + 1.0,
            "noise": np.abs(rng.rand(iters)) * 0.1,
            "variance": np.abs(rng.rand(iters)) + 0.5}


def _no_variance(v, rng):
    hp = _hyperparams(rng)
    del hp["variance"]
    v.plot_kernel_hyperparams(hp)


def _mixture(v, rng):
    q, iters = 3, 5
    v.plot_kernel_hyperparams({           # dispatches to the mixture plot
        "means": np.abs(rng.rand(iters, q, 1, 2)) + 0.2,
        "scales": np.abs(rng.rand(iters, q, 1, 2)) + 0.2,
        "weights": np.abs(rng.rand(iters, q)),
        "noise": np.abs(rng.rand(iters)) * 0.1, "maxdim": 20})


def _sparse(rng, shape):
    R = rng.rand(*shape)
    R[rng.rand(*shape) > 0.7] = np.nan
    return R


def _exploration(v, rng):
    e1, e2, e3 = 8, 8, 10
    R_true = rng.rand(e1, e2, e3)
    R_all = [np.where(r == 0, np.nan, r) for r in
             (R_true * (rng.rand(e1, e2, e3) > 0.3) for _ in range(4))]
    v.plot_exploration_results(
        R_all, [rng.rand(e1 * e2 * e3) for _ in range(4)],
        [np.abs(rng.rand(e1 * e2 * e3)) * .1 for _ in range(4)], R_true,
        episodes=[0, 1, 3], slice_number=4, pos=np.array([[2, 2], [4, 4]]),
        dist_edge=[1, 1])


def _query_points(v, rng):
    inds = rng.randint(0, 20, (12, 2))
    v.plot_query_points(inds)
    v.plot_query_points(inds, plot_lines=True)


CASES = {
    "kernel_hyperparams": lambda v, rng: v.plot_kernel_hyperparams(
        _hyperparams(rng)),
    "kernel_hyperparams_no_variance": _no_variance,
    "mixture_hyperparams": _mixture,
    "raw_data": lambda v, rng: v.plot_raw_data(
        rng.rand(8, 9, 12), slice_number=3, pos=np.array([[2, 2], [4, 5]])),
    "reconstructed_data2d": lambda v, rng: v.plot_reconstructed_data2d(
        _sparse(rng, (16, 16)), rng.rand(16, 16), sparsity=0.3),
    "reconstructed_data3d": lambda v, rng: v.plot_reconstructed_data3d(
        _sparse(rng, (8, 9, 12)), rng.rand(8 * 9 * 12),
        np.abs(rng.rand(8 * 9 * 12)) * 0.1, slice_number=3,
        pos=np.array([[2, 2], [4, 5]]), z_vec_label="f", z_vec_units="Hz"),
    "exploration_results": _exploration,
    "inducing_points_2d": lambda v, rng: v.plot_inducing_points(
        {"inducing_points": rng.rand(5, 20, 2) * 10}),
    "inducing_points_3d": lambda v, rng: v.plot_inducing_points(
        {"inducing_points": rng.rand(5, 20, 3) * 10}, slice_step=2),
    "query_points": _query_points,
}


def _arr(a):
    return None if a is None else np.ma.filled(np.ma.asarray(a), np.nan)


def _figures():
    """Every open figure as plain data, then closed."""
    out = []
    for num in plt.get_fignums():
        fig = plt.figure(num)
        axes = []
        for ax in fig.axes:
            axes.append({
                "title": ax.get_title(), "xlabel": ax.get_xlabel(),
                "ylabel": ax.get_ylabel(), "xlim": ax.get_xlim(),
                "ylim": ax.get_ylim(), "yscale": ax.get_yscale(),
                "visible": ax.get_visible(),
                "lines": [ln.get_xydata() for ln in ax.get_lines()],
                "images": [_arr(im.get_array()) for im in ax.get_images()],
                "collections": [(_arr(c.get_offsets()), _arr(c.get_array()),
                                 c.get_facecolors())
                                for c in ax.collections],
                "texts": [t.get_text() for t in ax.texts]
                + [t.get_text() for t in (ax.get_legend().get_texts()
                                          if ax.get_legend() else [])],
            })
        out.append((tuple(fig.get_size_inches()), axes))
    plt.close("all")
    return out


def _same(a, b, where="figure"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], "%s.%s" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=True), where
    else:
        assert a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_matches_gpim_tpu(case, monkeypatch):
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    CASES[case](jviz, np.random.RandomState(3))
    ref = _figures()
    CASES[case](viz, np.random.RandomState(3))
    got = _figures()
    assert got and any(ax["lines"] or ax["images"] or ax["collections"]
                       for _, axes in got for ax in axes)
    _same(got, ref)


def test_plot_names_resolve_from_utils():
    assert viz.__all__ == jviz.__all__ and len(viz.__all__) == 10
    assert list(utils._VIZ_NAMES) == viz.__all__
    for name in viz.__all__:
        assert getattr(utils, name) is getattr(viz, name)
        assert name in dir(utils)
    with pytest.raises(AttributeError):
        utils.plot_nothing
    # star-imports of utils stay matplotlib-free
    assert not set(viz.__all__) & set(utils.__all__)


def test_package_imports_without_matplotlib():
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import gpim_tpu_torch\n"
        "from gpim_tpu_torch import utils\n"
        "from gpim_tpu_torch.examples import sparse_image_2d\n"
        "assert 'gpim_tpu_torch.utils.viz' not in sys.modules\n"
        "try:\n"
        "    utils.plot_query_points([[0, 1], [2, 3]])\n"
        "except ImportError:\n"
        "    print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "raised"
    assert gpim_tpu_torch.utils is utils
