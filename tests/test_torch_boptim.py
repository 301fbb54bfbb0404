"""
gpim_tpu_torch.boptimizer on the CPU, the port alone: the twin of
tests/test_boptim.py (the three goldens, written by gpim_tpu and read
here, batch selection, masks, custom acquisition callables, simulated
measurements and their artefacts), plus the ranking's tie order, the
default device and, on the card, a known float32 fault.
tests/test_torch_boptim_parity.py holds the same runs against gpim_tpu.

The tests marked ``cuda`` need a CUDA device and skip without one. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_boptim.py
"""

import os
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from gpim_tpu_torch import boptimizer, utils
from gpim_tpu_torch.gpbayes import acqfunc, boptim
from gpim_tpu_torch.native import spatial

_DATA = os.path.join(os.path.dirname(__file__), "test_data")
_EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def trial_func(idx, x0=5, y0=10, fwhm=4.5):
    return np.exp(-4 * np.log(2) *
                  ((idx[0] - x0) ** 2 + (idx[1] - y0) ** 2) / fwhm ** 2)


def initial_seed():
    """25x25 Gaussian peak seen at 5 random pixels (test_boptim.py:28-36)."""
    np.random.seed(0)
    x = np.arange(0, 25, 1.)
    y = x[:, np.newaxis]
    Z = trial_func([y, x])
    idx = np.random.randint(0, Z.shape[0], size=(2, 5))
    Z_sparse = np.ones_like(Z) * np.nan
    Z_sparse[idx[0], idx[1]] = Z[idx[0], idx[1]]
    return Z_sparse


def y_true():
    x = np.arange(0, 25, 1.)
    return trial_func([x[:, None], x])


def make_bo(tmp_path, target=trial_func, **kw):
    """A port boptimizer on the CPU in float64 over initial_seed()."""
    Z = initial_seed()
    base = dict(verbose=0, use_gpu=False,
                filename=str(tmp_path / "bo_results"))
    base.update(kw)
    return boptimizer(utils.get_sparse_grid(Z), Z, utils.get_full_grid(Z),
                      target, **base)


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """The 20-step golden runs of each acquisition function, run once."""
    tmp = tmp_path_factory.mktemp("golden")
    runs = {}

    def get(acqf):
        if acqf not in runs:
            bo = make_bo(tmp, acquisition_function=acqf,
                         exploration_steps=20, gp_iterations=200)
            bo.run()
            runs[acqf] = bo
        return runs[acqf]
    return get


@pytest.mark.parametrize("acqf", ["ei", "poi", "cb"])
def test_boptim_golden(acqf, golden_runs):
    bo = golden_runs(acqf)
    assert bo.surrogate_model.dtype == torch.float64
    expected = np.load(os.path.join(_DATA, "golden_%s.npy" % acqf))
    assert_allclose(bo.target_func_vals[-1], expected)


def test_boptim_finds_optimum(golden_runs):
    """EI locates the global max within 20 steps."""
    bo = golden_runs("ei")
    assert np.nanmax(bo.target_func_vals[-1]) > 0.99
    assert [5, 10] in bo.indices_all
    # every trajectory on the host, one entry per Adam step of the run:
    # 200 + 19 refits of 50 + the trailing retrain
    assert len(bo.surrogate_model.hyperparams["lengthscale"]) == 1200
    assert all(isinstance(m, np.ndarray) and m.shape == (25, 25)
               for pred in bo.gp_predictions for m in pred)


def test_boptim_batch_update_and_dscale(tmp_path):
    """Batch mode returns spaced batches; dscale memory avoids revisits."""
    bo = make_bo(tmp_path, acquisition_function="cb", exploration_steps=3,
                 batch_update=True, batch_size=50, batch_out_max=6,
                 dscale=3, gamma=0.8, memory=5, gp_iterations=50)
    bo.run()
    assert len(bo.indices_all) == 3 * 6
    assert (~np.isnan(bo.target_func_vals[-1])).sum() > 5


def test_boptim_mask(tmp_path):
    """NaN-masked grid positions are never selected (boptim.py:303-315)."""
    mask = np.ones((25, 25))
    mask[:, :13] = np.nan  # forbid the left half (contains the optimum)
    bo = make_bo(tmp_path, acquisition_function="cb", exploration_steps=4,
                 gp_iterations=50, mask=mask)
    bo.run()
    assert all(idx[1] >= 13 for idx in bo.indices_all)


def test_custom_acquisition_function(tmp_path):
    """A user callable (model, X_full, X_sparse) -> (acq, pred) takes the
    host loop."""

    def my_acq(model, X_full_, X_sparse_):
        mean, sd = model.predict(X_full_, verbose=0)
        return mean + 2.0 * sd, (mean, sd)

    bo = make_bo(tmp_path, acquisition_function=my_acq, exploration_steps=2,
                 gp_iterations=50)
    assert not bo._fused_ok()
    bo.run()
    assert len(bo.indices_all) == 2
    assert len(bo.surrogate_model.hyperparams["lengthscale"]) == 50 + 2 * 12


def test_simulate_measurement(tmp_path):
    """simulate_measurement=True looks values up in y_true."""
    yt = y_true()
    bo = make_bo(tmp_path, target=None, acquisition_function="cb",
                 exploration_steps=2, gp_iterations=50,
                 simulate_measurement=True, y_true=yt)
    bo.run()
    for idx in bo.indices_all:
        assert bo.target_func_vals[-1][tuple(idx)] == yt[tuple(idx)]
    with pytest.raises(AssertionError, match="y_true"):
        make_bo(tmp_path, target=None, simulate_measurement=True)


def test_poi_unpacks_prediction():
    """The reference's POI nanmax-over-tuple bug (acqfunc.py:86-88) must not
    reproduce: POI values are proper probabilities in [0, 1]."""

    class FakeModel:
        def predict(self, X, **kw):
            n = X.shape[1] * X.shape[2]
            mean = np.linspace(0, 1, n).reshape(X.shape[1:])
            sd = np.full(X.shape[1:], 0.5)
            return mean, sd

    X = np.zeros((2, 5, 5))
    acq, pred = acqfunc.probability_of_improvement(FakeModel(), X, X)
    assert acq.shape == (5, 5)
    assert np.all((acq >= 0) & (acq <= 1))


# --------------------------------------------------------------------------
# ranking on the device paths
# --------------------------------------------------------------------------

def _tied_acquisition(device="cpu"):
    """Ties at the top, inside the list and at -inf, placed so that any
    order other than ascending index shows."""
    v = torch.tensor([0.5, 2.0, -1.0, 2.0, 0.5, 2.0, float("nan"), 0.5,
                      1.0, 2.0], dtype=torch.float64, device=device)
    sel = torch.tensor([1, 1, 1, 1, 1, 1, 1, 1, 0, 1],
                       dtype=torch.float64, device=device)
    return v, sel


def _check_tie_order(device):
    v, sel = _tied_acquisition(device)
    macq = boptim._select(v, sel)
    vals, order = boptim._top_k(macq, 10)
    assert order.tolist() == [1, 3, 5, 9, 0, 4, 7, 2, 6, 8]
    assert vals.tolist()[:8] == [2.0, 2.0, 2.0, 2.0, 0.5, 0.5, 0.5, -1.0]
    # the NaN and the masked-out point rank last, at -inf, in index order
    assert vals.tolist()[8:] == [-np.inf, -np.inf]


def test_tied_acquisition_ranks_lower_flat_index_first():
    """Equal acquisition values rank in ascending flat-index order, as
    jax.lax.top_k ranks them; NaN and masked-out points rank last."""
    _check_tie_order("cpu")


@pytest.mark.cuda
def test_tied_acquisition_order_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check_tie_order("cuda")


def test_acquisition_on_tensors_matches_acqfunc():
    """The device step's CB/EI/POI equal the host acqfunc's on one
    prediction; the incumbent is the best mean at an observed point."""
    rng = np.random.RandomState(3)
    mean = rng.rand(5, 5)
    sd = 0.05 + rng.rand(5, 5)
    Xs = utils.get_full_grid(mean).astype(float)
    obs = rng.rand(5, 5) < 0.3
    Xs[:, ~obs] = np.nan

    class FakeModel:
        def predict(self, X, **kw):
            return mean, sd

    tm, ts, tobs = (torch.as_tensor(a.ravel()) for a in (mean, sd, obs))
    for kind, fn, kw in (
            ("cb", acqfunc.confidence_bound, dict(alpha=0.3, beta=2.0)),
            ("ei", acqfunc.expected_improvement, dict(xi=0.02)),
            ("poi", acqfunc.probability_of_improvement, dict(xi=0.02))):
        args = (FakeModel(), Xs) if kind == "cb" else (FakeModel(), Xs, Xs)
        ref, _ = fn(*args, **kw)
        got = boptim._acquisition(tm, ts, tobs, kind, kw.get("alpha", 0),
                                  kw.get("beta", 1), kw.get("xi", 0.01))
        assert_allclose(got.numpy(), ref.ravel(), rtol=1e-13, atol=1e-15,
                        err_msg=kind)


def test_spaced_batch_suppresses_within_dscale():
    pts = np.array([[0, 0], [0, 1], [3, 0], [0, 2], [3, 1], [6, 6]], float)
    assert spatial.spaced_batch(pts, 1.0) == [0, 2, 3, 5]
    assert spatial.spaced_batch(pts, 1.0, max_out=2) == [0, 2]
    assert spatial.spaced_batch(pts, 0.0) == list(range(6))
    assert spatial.spaced_batch(np.zeros((0, 2)), 1.0) == []


# --------------------------------------------------------------------------
# simulated measurements on the device step
# --------------------------------------------------------------------------

def _sim_bo(tmp_path, **kw):
    base = dict(acquisition_function="ei", exploration_steps=6,
                gp_iterations=60, simulate_measurement=True, y_true=y_true())
    base.update(kw)
    return make_bo(tmp_path, target=None, **base)


def test_device_loop_keyword_is_accepted_and_ignored(tmp_path):
    """gpim_tpu's device_loop switch is taken for its signature: every
    value runs the same device step and selects the same points."""
    runs = []
    for device_loop in (None, True, False):
        bo = _sim_bo(tmp_path, exploration_steps=3, gp_iterations=30,
                     device_loop=device_loop)
        assert bo._fused_ok()
        bo.run()
        runs.append(bo)
    for bo in runs[1:]:
        assert bo.indices_all == runs[0].indices_all
        assert bo.vals_all == runs[0].vals_all


def test_simulated_run_artifacts_roundtrip(tmp_path):
    """save_results after a simulated run writes the artefact dict the host
    loop writes, numpy only (np.load-able, reference boptim.py keys)."""
    bo = _sim_bo(tmp_path, filename=str(tmp_path / "dev_bo"))
    bo.run()
    d = np.load(str(tmp_path / "dev_bo.npy"), allow_pickle=True).item()
    assert set(d) >= {"gp_pred", "func_val", "inds_all", "vals_all"}
    assert d["inds_all"].shape == (6, 2)
    assert d["inds_all"].tolist() == bo.indices_all
    assert np.isfinite(np.asarray(d["vals_all"], float)).all()
    assert len(d["gp_pred"]) == len(d["func_val"]) - 1 == 6
    for mean, sd in d["gp_pred"]:
        assert isinstance(mean, np.ndarray) and mean.shape == (25, 25)
        assert np.isfinite(mean).all() and (sd > 0).all()
    # 60 + 5 refits of 15 + the trailing retrain, on the host
    assert len(bo.surrogate_model.hyperparams["lengthscale"]) == 60 + 6 * 15
    # the surrogate's training set holds the measured points
    assert len(bo.surrogate_model.X) == 5 + 6


@pytest.mark.cuda
def test_float32_spiral_bo_fails_its_cholesky(tmp_path):
    """Known fault, open: at the float32 default on the card, EI seeded
    with the 128x128 spiral scan (n = 6144 rows) drives noise + jitter
    under the float32 factorisation's round-off, and a refit's Cholesky
    fails. The test fails once that is repaired, or if the run breaks
    otherwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, _EXAMPLES)
    try:
        import _data
    finally:
        sys.path.remove(_EXAMPLES)
    R = _data.spiral_scan()
    field = _data._smooth_field((128, 128), sigma=(6.0, 6.0), seed=0)
    bo = boptimizer(utils.get_sparse_grid(R), R, utils.get_full_grid(R),
                    None, acquisition_function="ei", exploration_steps=8,
                    gp_iterations=250, simulate_measurement=True,
                    y_true=field, verbose=0,
                    filename=str(tmp_path / "spiral_bo"))
    assert bo.surrogate_model.dtype == torch.float32
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        bo.run()


def test_checkpoint_roundtrip_resumes(tmp_path):
    """save_checkpoint holds numpy only; load_checkpoint + run() resumes
    from the saved step."""
    bo = make_bo(tmp_path, acquisition_function="cb", exploration_steps=2,
                 gp_iterations=30)
    bo.run()
    bo.save_checkpoint(str(tmp_path / "state"))
    state = np.load(str(tmp_path / "state.npy"), allow_pickle=True).item()
    assert all(isinstance(v, np.ndarray)
               for v in state["surrogate_u"].values())
    bo2 = make_bo(tmp_path, acquisition_function="cb", exploration_steps=3,
                  gp_iterations=30)
    bo2.load_checkpoint(str(tmp_path / "state"))
    assert bo2.indices_all == bo.indices_all and bo2.steps_done == 2
    bo2.run()
    assert len(bo2.indices_all) == 3
    assert bo2.indices_all[:2] == bo.indices_all


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """Built without use_gpu, the surrogate asks for the CUDA device: with
    none the optimizer raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Z = initial_seed()
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        boptimizer(utils.get_sparse_grid(Z), Z, utils.get_full_grid(Z),
                   trial_func, verbose=0)


def test_mesh_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="mesh"):
        make_bo(tmp_path, mesh=True)
