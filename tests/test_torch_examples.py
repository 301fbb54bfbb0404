"""
gpim_tpu_torch.examples, the port's runners of the six examples/*.py
workflows, on the CPU: the port's copy of examples/_data.py equal to it
bit for bit with and without bundled data; each runner's run() and main()
at 2 iterations with use_gpu=False / --cpu on reduced data (the flagship
on a 32x32 crop of the spiral, the VFE on a 6x6x54 crop of the cube, eels
on 16x16 pixels, cKPFM on 17 of its 64 channels, the masked cube at
16x16x8 as tests/test_examples.py shrinks it), under Agg, writing only to
their output directory; the card as every runner's default device; and
the BO runner in float64 picking the points gpim_tpu's boptimizer picks
with the same arguments.
"""

import importlib
import importlib.util
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gpim_tpu  # noqa: E402

from gpim_tpu_torch.examples import _data  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNERS = ["sparse_image_2d", "hyperspectral_3d_sparse", "eels_parallel_gp",
           "ckpfm_4d_ski", "large_masked_ski", "bayesian_optimization"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _script_data():
    spec = importlib.util.spec_from_file_location(
        "examples_data", os.path.join(ROOT, "examples", "_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_expdata(root):
    """Stand-ins for the bundled files, in the layouts _data reads."""
    rng = np.random.RandomState(5)
    img = rng.rand(128, 128)
    img[rng.rand(128, 128) < 0.6] = 0.25       # the unmeasured fill value
    np.save(root / "spiral_s_00010_2019.npy", img)
    cube = rng.rand(32, 32, 102)
    np.save(root / "bepfm_test_data.npy", cube)
    cube[rng.rand(32, 32) < 0.7] = np.nan
    np.save(root / "bepfm_test_data_sparse.npy", cube)
    np.savez(root / "cKPFM loop_0001 10 x 10-proc.npz",
             Nd_mat_amp=rng.rand(10, 10, 3, 64, 5),
             Nd_mat_phase=rng.rand(10, 10, 3, 64, 5) * 3)


DATA_CALLS = {
    "spiral_scan": lambda m: m.spiral_scan(),
    "bepfm_cube": lambda m: m.bepfm_cube(),
    "bepfm_cube_sparse": lambda m: m.bepfm_cube(sparse=True),
    "ckpfm_slab": lambda m: m.ckpfm_slab(),
}


@pytest.mark.parametrize("expdata", ["absent", "present"])
@pytest.mark.parametrize("call", sorted(DATA_CALLS))
def test_data_equals_the_scripts_data(call, expdata, tmp_path, monkeypatch):
    script = _script_data()
    if expdata == "present":
        _write_expdata(tmp_path)
    roots = (str(tmp_path if expdata == "present" else tmp_path / "none"),)
    for m in (script, _data):
        monkeypatch.setattr(m, "_DEFAULT_ROOTS", roots)
    got, ref = DATA_CALLS[call](_data), DATA_CALLS[call](script)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref, equal_nan=True)
    assert (_data.expdata_path("bepfm_test_data.npy") is None) == (
        expdata == "absent")


def _reduced(mod, monkeypatch):
    """Point the runner's default data at a reduced copy (the module's own
    data function, which run() and main() call); returns run()'s
    keyword for the same data."""
    name = mod.NAME
    if name == "sparse_image_2d":
        R = _data.spiral_scan()[40:72, 40:72]
        monkeypatch.setattr(mod, "data", lambda path=None: R)
        return {"R": R}
    if name == "hyperspectral_3d_sparse":
        cubes = tuple(c[:6, :6, :54] for c in mod.data())
        monkeypatch.setattr(mod, "data", lambda: cubes)
        monkeypatch.setattr(mod, "PLOT", dict(slice_number=50,
                                              pos=[[1, 2], [4, 5]]))
        return {"cubes": cubes}
    if name == "eels_parallel_gp":
        bands = mod.data()[:16, :16]
        monkeypatch.setattr(mod, "data", lambda: bands)
        return {"bands": bands}
    if name == "ckpfm_4d_ski":
        R = mod.data()[:, :, :17]
        monkeypatch.setattr(mod, "data", lambda: R)
        return {"R": R}
    if name == "large_masked_ski":
        cube = mod.make_cube((16, 16, 8), missing=0.6)
        monkeypatch.setattr(mod, "make_cube", lambda *a, **k: cube)
        return {"cube": cube}
    return {}


def _check(name, out):
    if name == "bayesian_optimization":
        assert out["indices"].shape == (2, 2)
        assert np.isfinite(out["best_found"])
        assert os.path.exists(os.path.join(out["outdir"],
                                           "boptim_results.npy"))
        return
    mean, sd = out["mean"], out["sd"]
    shape = {"eels_parallel_gp": (32, 32, 6),
             "ckpfm_4d_ski": (10, 10, 17, 5)}.get(name)
    assert mean.shape == sd.shape == (shape or mean.shape)
    assert np.isfinite(mean).all() and (sd > 0).all()
    for key in ("rmse_obs", "rmse_vs_truth", "mae", "rmse_vs_bands",
                "rmse_fit"):
        assert np.isfinite(out.get(key, 0.0))
    if name == "ckpfm_4d_ski":
        assert out["mean2x"].shape == (20, 20, 34, 10)
        assert np.isfinite(out["sd2x"]).all()
    assert out["model"].device.type == "cpu"
    assert os.path.exists(os.path.join(out["outdir"], name + ".npz"))


@pytest.mark.parametrize("name", RUNNERS)
def test_run_on_the_cpu(name, tmp_path, monkeypatch):
    mod = importlib.import_module("gpim_tpu_torch.examples." + name)
    kw = _reduced(mod, monkeypatch)
    before = sorted(os.listdir(ROOT))
    out = mod.run(2, use_gpu=False, outdir=str(tmp_path / "out"), **kw)
    assert out["outdir"] == str(tmp_path / "out")
    _check(name, out)
    assert sorted(os.listdir(ROOT)) == before


@pytest.mark.parametrize("name", RUNNERS)
def test_main_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    mod = importlib.import_module("gpim_tpu_torch.examples." + name)
    _reduced(mod, monkeypatch)
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(
        len(plt.get_fignums())))
    before = sorted(os.listdir(ROOT))
    try:
        mod.main(["--iterations", "2", "--cpu", "--out", str(tmp_path)])
    finally:
        plt.close("all")
    printed = capsys.readouterr().out
    assert str(tmp_path) in printed
    assert any(f.endswith((".npz", ".npy")) for f in os.listdir(tmp_path))
    plots = name in ("sparse_image_2d", "hyperspectral_3d_sparse",
                     "bayesian_optimization")
    assert bool(shown) == plots and all(shown)
    assert sorted(os.listdir(ROOT)) == before


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_defaults_to_the_card(name, tmp_path, monkeypatch):
    """Without use_gpu the runner asks for the CUDA device, which raises
    where there is none, as every model built without use_gpu does."""
    mod = importlib.import_module("gpim_tpu_torch.examples." + name)
    kw = _reduced(mod, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        mod.run(2, outdir=str(tmp_path), **kw)


def test_bo_runner_picks_the_points_gpim_tpu_picks(tmp_path):
    """3 iterations, so 3 EI steps of 3 GP iterations, float64: the
    runner's run() and gpim_tpu.boptimizer with the script's arguments
    measure the same points and values."""
    from gpim_tpu_torch.examples import bayesian_optimization as bo_run
    from gpim_tpu import utils as jutils
    out = bo_run.run(3, use_gpu=False, outdir=str(tmp_path / "port"))
    Z = bo_run.data()
    jbo = gpim_tpu.boptimizer(
        jutils.get_sparse_grid(Z), Z, jutils.get_full_grid(Z),
        bo_run.measure, acquisition_function="ei", exploration_steps=3,
        gp_iterations=3, save_checkpoints=True,
        filename=str(tmp_path / "jax"), verbose=0, precision="double")
    jbo.run()
    bo = out["bo"]
    assert bo.surrogate_model.dtype == torch.float64
    assert len(bo.indices_all) == 3
    assert [tuple(i) for i in bo.indices_all] == \
        [tuple(i) for i in jbo.indices_all]
    np.testing.assert_allclose(np.asarray(bo.vals_all, float),
                               np.asarray(jbo.vals_all, float), rtol=1e-6)
    np.testing.assert_array_equal(bo.y_sparse, jbo.y_sparse)
