"""
gpim_tpu_torch.boptimizer and reconstructor.step against gpim_tpu on the
same inputs, float64 on the CPU: equal selected indices and measured
values, acquisition values and hyperparameter trajectories to rtol 1e-6
(with an atol of 1e-6 of the largest value: EI far from the optimum is
tiny), on the device step (against gpim_tpu's device step and its
device-resident loop), the host loop, batch
selection with dscale, masks, custom callables, the VFE surrogate and
step(); and checkpoints written by either package resume in the other.
The JAX side runs as tests/test_boptim.py runs it.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import gpim_tpu
from gpim_tpu.gpbayes import acqfunc as jacqfunc
from gpim_tpu.native import spatial as jspatial

import gpim_tpu_torch
from gpim_tpu_torch import utils
from gpim_tpu_torch.gpbayes import acqfunc
from gpim_tpu_torch.native import spatial

from test_torch_boptim import initial_seed, trial_func, y_true

RTOL = 1e-6
ACQFUNC = {gpim_tpu: jacqfunc, gpim_tpu_torch: acqfunc}
NAMED = {"ei": "expected_improvement", "cb": "confidence_bound"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, err_msg=""):
    ref = np.asarray(ref, float)
    assert_allclose(np.asarray(got, float), ref, rtol=RTOL,
                    atol=RTOL * np.abs(ref).max(), err_msg=err_msg)


def _make(pkg, tmp_path, target=trial_func, **kw):
    Z = initial_seed()
    base = dict(verbose=0, use_gpu=False, precision="double",
                gp_iterations=60,
                filename=str(tmp_path / (pkg.__name__ + "_bo")))
    base.update(kw)
    return pkg.boptimizer(utils.get_sparse_grid(Z), Z,
                          utils.get_full_grid(Z), target, **base)


def _run_both(tmp_path, jax_device_loop=None, **kw):
    """The same run through gpim_tpu and the port; ``kw`` may map a
    package to its own value of a keyword. ``jax_device_loop`` is whether
    gpim_tpu must take its device-resident loop (the port has none)."""
    out = []
    for pkg in (gpim_tpu, gpim_tpu_torch):
        args = {k: (v[pkg] if isinstance(v, dict) and pkg in v else v)
                for k, v in kw.items()}
        bo = _make(pkg, tmp_path, **args)
        if jax_device_loop is not None and pkg is gpim_tpu:
            assert bo._device_explore_ok() == jax_device_loop
        bo.run()
        out.append(bo)
    return out


def _assert_same_run(bj, bt):
    assert bt.indices_all == bj.indices_all
    assert bt.steps_done == bj.steps_done
    _close(bt.vals_all, bj.vals_all, "vals_all")
    assert np.array_equal(bt.y_sparse, bj.y_sparse, equal_nan=True)
    assert len(bt.target_func_vals) == len(bj.target_func_vals)
    assert len(bt.gp_predictions) == len(bj.gp_predictions)
    hj = bj.surrogate_model.hyperparams
    ht = bt.surrogate_model.hyperparams
    assert set(ht) == set(hj)
    for k in hj:
        assert ht[k].shape == hj[k].shape, k
        if ht[k].size:
            _close(ht[k], hj[k], k)
    mj, sj = bj.gp_predictions[-1]
    mt, st = bt.gp_predictions[-1]
    _close(mt, mj, "mean")
    _close(st, sj, "sd")


def _sim(**kw):
    return dict(target=None, simulate_measurement=True, y_true=y_true(),
                exploration_steps=4, **kw)


def _wrapped(acqf):
    """Each package's named acquisition function as a custom callable,
    which takes the host loop."""
    def wrap(mod):
        f = getattr(mod, NAMED[acqf])
        if acqf == "cb":
            return lambda m, xf, xs: f(m, xf)
        return lambda m, xf, xs: f(m, xf, xs)
    return {pkg: wrap(mod) for pkg, mod in ACQFUNC.items()}


@pytest.mark.parametrize("acqf", ["ei", "cb"])
@pytest.mark.parametrize("loop", ["fused", "device", "host"])
def test_loops_match_gpim_tpu(loop, acqf, tmp_path):
    """The port's device step selects what gpim_tpu's device step
    (device_loop=False) and its device-resident loop (the default) select,
    and the port's host loop (the named function wrapped in a callable)
    what gpim_tpu's selects."""
    kw = _sim(acquisition_function=_wrapped(acqf) if loop == "host"
              else acqf)
    if loop == "fused":
        kw["device_loop"] = False
    bj, bt = _run_both(tmp_path, jax_device_loop=loop == "device", **kw)
    assert bt._fused_ok() == (loop != "host")
    _assert_same_run(bj, bt)


def test_batch_with_dscale_matches_gpim_tpu(tmp_path):
    """Lengthscale-spaced batches, distance memory and the random fill-up
    (the same RandomState draws)."""
    bj, bt = _run_both(tmp_path, acquisition_function="cb",
                       exploration_steps=3, batch_update=True, batch_size=50,
                       batch_out_max=6, dscale=3, gamma=0.8, memory=5)
    assert len(bt.indices_all) == 18
    _assert_same_run(bj, bt)


def test_mask_matches_gpim_tpu(tmp_path):
    mask = np.ones((25, 25))
    mask[:, :13] = np.nan
    mask[20:, 13:] = 0.5
    bj, bt = _run_both(tmp_path, acquisition_function="ei",
                       exploration_steps=3, mask=mask)
    assert all(idx[1] >= 13 for idx in bt.indices_all)
    _assert_same_run(bj, bt)


def test_custom_callable_matches_gpim_tpu(tmp_path):
    def my_acq(model, X_full_, X_sparse_):
        mean, sd = model.predict(X_full_, verbose=0)
        return mean + 2.0 * sd, (mean, sd)

    bj, bt = _run_both(tmp_path, acquisition_function=my_acq,
                       exploration_steps=3)
    _assert_same_run(bj, bt)


def test_vfe_surrogate_matches_gpim_tpu(tmp_path):
    """A sparse (VFE) surrogate: the port's device step against
    gpim_tpu's device-resident loop."""
    bj, bt = _run_both(tmp_path, jax_device_loop=True,
                       **_sim(acquisition_function="ei", sparse=True,
                              indpoints=24))
    _assert_same_run(bj, bt)
    assert bt.surrogate_model.hyperparams["inducing_points"].shape[1:] == \
        (5, 2)


@pytest.mark.parametrize("direction", ["gpim_tpu_to_port", "port_to_gpim_tpu"])
def test_checkpoint_interchange(direction, tmp_path):
    """A checkpoint written mid-run (after step 2, before the trailing
    retrain) by one package resumes in the other to the indices that the
    writer's own resume reaches."""
    writer, reader = (gpim_tpu, gpim_tpu_torch)
    if direction == "port_to_gpim_tpu":
        writer, reader = reader, writer
    kw = dict(acquisition_function="ei", exploration_steps=2)
    bo = _make(writer, tmp_path, save_checkpoints=True, **kw)
    bo.run()
    state = bo.filename + "_state"
    resumed = {}
    for pkg in (writer, reader):
        b = _make(pkg, tmp_path, **dict(kw, exploration_steps=4))
        b.load_checkpoint(state)
        assert b.steps_done == 2 and b.indices_all == bo.indices_all
        b.run()
        resumed[pkg] = b
    _assert_same_run(resumed[gpim_tpu], resumed[gpim_tpu_torch])


def _step_data():
    rng = np.random.RandomState(0)
    ii, jj = np.indices((16, 16))
    R = np.exp(-((ii - 5.0) ** 2 + (jj - 9.0) ** 2) / 30.0)
    R[rng.rand(16, 16) < 0.6] = np.nan
    return R, utils.get_sparse_grid(R), utils.get_full_grid(R)


@pytest.mark.parametrize("batch_update", [False, True])
def test_step_matches_gpim_tpu(batch_update):
    """reconstructor.step: train, read the lengthscale, predict, rank."""
    R, X, Xf = _step_data()
    kw = dict(iterations=30, verbose=0, precision="double", use_gpu=False)
    out = []
    for pkg in (gpim_tpu, gpim_tpu_torch):
        model = pkg.reconstructor(X, R, Xf, **kw)
        out.append(model.step(
            acquisition_function=lambda m, s: m + 1.5 * s, batch_size=40,
            batch_update=batch_update))
    (vj, ij, mj, sj), (vt, it, mt, st) = out
    assert it == ij
    assert mt.shape == st.shape == (256,)
    _close(vt, vj, "vals")
    _close(mt, mj, "mean")
    _close(st, sj, "sd")
    assert (len(it) < 40) == batch_update


def test_spaced_batch_matches_gpim_tpu():
    """The numpy sweep selects what gpim_tpu's spaced_batch (its C++ helper
    where it is built) selects, ties at exactly dscale included."""
    rng = np.random.RandomState(1)
    for trial in range(20):
        pts = rng.randint(0, 12, size=(60, 2)).astype(float)
        for dscale in (0.0, 1.0, 2.0, 2.5, 5.0):
            for cap in (None, 7):
                assert spatial.spaced_batch(pts, dscale, cap) == \
                    jspatial.spaced_batch(pts, dscale, cap)
