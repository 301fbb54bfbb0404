"""
The port's example notebooks (``gpim_tpu_torch/examples/notebooks``) on the
CPU: each of the seven runs through ``_notebook.execute`` at 2 iterations
(each once, cached for the module; three on reduced data, see
``_reduced``); quickstart's
result against ``gpim_tpu.reconstructor`` on the same arrays and kwargs in
float64; quickstart through a Jupyter kernel; the committed notebooks
against what their generator writes; the cells' imports and plot cells;
and the card as the notebooks' default device, which raises without one.
"""

import ast
import importlib.util
import os
import traceback

import numpy as np
import pytest
import torch

import gpim_tpu
from gpim_tpu_torch.examples import _data, _notebook

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NB_DIR = os.path.join(REPO, "gpim_tpu_torch", "examples", "notebooks")
NAMES = ("sparse_image_2d", "hyperspectral_3d_sparse", "eels_parallel_gp",
         "ckpfm_4d_ski", "bayesian_optimization", "quickstart",
         "large_masked_ski")
MODELS = ("reconstructor", "skreconstructor", "vreconstructor",
          "boptimizer")


def _path(name):
    return os.path.join(NB_DIR, name + ".ipynb")


def _generator():
    spec = importlib.util.spec_from_file_location(
        "_generate", os.path.join(NB_DIR, "_generate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cells(name):
    """[(cell number, source, is a plot cell)] of the code cells."""
    return [(i, src, _notebook.PLOT_TAG in tags)
            for i, src, tags in _notebook.code_cells(_path(name),
                                                     skip_tags=())]


def _reduced(name, mp):
    """Point ``_data`` at a reduced copy of the notebook's data, the slices
    ``tests/test_torch_examples.py`` gives its runner twin: the spiral, the
    BEPFM cube and the cKPFM slab at full size cost minutes on the CPU and
    run at full size on the card (``chip_smoke.py`` phase ``notebooks``).
    The other four notebooks run on their full data."""
    if name == "sparse_image_2d":
        R = _data.spiral_scan()[40:72, 40:72]
        mp.setattr(_data, "spiral_scan", lambda seed=0: R)
    elif name == "hyperspectral_3d_sparse":
        cubes = {s: _data.bepfm_cube(sparse=s)[:6, :6, :54]
                 for s in (False, True)}
        mp.setattr(_data, "bepfm_cube", lambda sparse=False: cubes[sparse])
    elif name == "ckpfm_4d_ski":
        R = _data.ckpfm_slab()[:, :, :17]
        mp.setattr(_data, "ckpfm_slab", lambda seed=0: R)


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    """name -> (namespace, skipped cells, working directory), each
    notebook run once at 2 iterations on the CPU, on one thread: where the
    suite runs several test processes on few cores, the notebooks' many
    small parallel operations at the default thread count mostly wait for
    their threads; one thread needs no other core."""
    cache = {}

    def run(name):
        if name not in cache:
            cwd = tmp_path_factory.mktemp(name)
            with pytest.MonkeyPatch.context() as mp:
                _reduced(name, mp)
                ns, skipped = _notebook.execute(_path(name), iters=2,
                                                device="cpu", cwd=str(cwd))
            cache[name] = ns, skipped, cwd
        return cache[name]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield run
    torch.set_num_threads(threads)


def _finite(*arrays):
    return all(np.isfinite(np.asarray(a, float)).all() for a in arrays)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_the_cpu(name, executed):
    env = {k: os.environ.get(k) for k in (
        _notebook.ENV_ITERS, _notebook.ENV_DEVICE, _notebook.ENV_REPO)}
    here = os.getcwd()
    ns, skipped, cwd = executed(name)
    # the environment and the working directory are restored
    assert {k: os.environ.get(k) for k in env} == env
    assert os.getcwd() == here
    assert ns["ITERS"] == 2 and ns["USE_GPU"] is False
    assert skipped == [i for i, _, plot in _cells(name) if plot]
    shapes = {"sparse_image_2d": (32, 32),
              "hyperspectral_3d_sparse": (6, 6, 54),
              "eels_parallel_gp": (64, 64, 6), "ckpfm_4d_ski": (10, 10, 17, 5),
              "quickstart": (48, 48), "large_masked_ski": (64, 64, 32)}
    if name == "bayesian_optimization":
        bo = ns["boptim"]
        assert bo.steps_done == 2
        assert np.asarray(bo.indices_all).shape == (2, 2)
        assert np.isfinite(np.nanmax(bo.target_func_vals[-1]))
        assert bo.surrogate_model.device.type == "cpu"
        assert (cwd / "boptim_results.npy").exists()
        return
    mean, sd = ns["mean"], ns["sd"]
    assert mean.shape == sd.shape == shapes[name]
    assert _finite(mean, sd)
    assert ns["model"].device.type == "cpu"
    assert len(ns["hyperparams"]["noise"]) == 2        # a value a step
    if name == "ckpfm_4d_ski":
        assert ns["mean2x"].shape == ns["sd2x"].shape == (20, 20, 34, 10)
        assert _finite(ns["mean2x"], ns["sd2x"])
    if name == "large_masked_ski":
        assert ns["model"]._mgrid_engine is not None
        assert np.isfinite(ns["rmse"])
    if name == "hyperspectral_3d_sparse":
        assert ns["model"].u["Xu"].shape[1] == 3


def test_quickstart_matches_gpim_tpu(executed):
    """The notebook's reconstructor against gpim_tpu's on the same image and
    kwargs, both in float64 on the CPU."""
    ns = executed("quickstart")[0]
    R, utils = ns["R"], gpim_tpu.utils
    mean, sd, hp = gpim_tpu.reconstructor(
        utils.get_sparse_grid(R), R, utils.get_full_grid(R), kernel="RBF",
        iterations=2, verbose=0).run()
    assert ns["mean"].dtype == np.float64
    np.testing.assert_allclose(ns["mean"], mean, rtol=1e-6)
    np.testing.assert_allclose(ns["sd"], sd, rtol=1e-6)
    assert set(ns["hyperparams"]) == set(hp)
    for k in hp:
        np.testing.assert_allclose(ns["hyperparams"][k], hp[k], rtol=1e-6)


def test_quickstart_runs_in_a_jupyter_kernel(tmp_path, monkeypatch):
    """nbclient runs every cell, the plot cell too (Agg matplotlib)."""
    nbformat = pytest.importorskip("nbformat")
    nbclient = pytest.importorskip("nbclient")
    monkeypatch.setenv(_notebook.ENV_ITERS, "2")
    monkeypatch.setenv(_notebook.ENV_DEVICE, "cpu")
    monkeypatch.setenv(_notebook.ENV_REPO, REPO)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    monkeypatch.delenv("DISPLAY", raising=False)
    nb = nbformat.read(_path("quickstart"), as_version=4)
    nbclient.NotebookClient(
        nb, timeout=600, kernel_name="python3",
        resources={"metadata": {"path": str(tmp_path)}}).execute()
    codes = [c for c in nb.cells if c.cell_type == "code"]
    assert all(c.execution_count is not None for c in codes)
    assert any("rmse vs truth" in o.get("text", "")
               for c in codes for o in c.outputs)


def test_committed_notebooks_are_what_the_generator_writes():
    nbformat = pytest.importorskip("nbformat")
    generated = _generator().notebooks()
    committed = sorted(f for f in os.listdir(NB_DIR) if f.endswith(".ipynb"))
    assert committed == sorted(n + ".ipynb" for n in NAMES)
    assert sorted(generated) == committed
    for name, nb in generated.items():
        with open(os.path.join(NB_DIR, name), encoding="utf-8") as f:
            text = f.read()
        assert text.rstrip("\n") == nbformat.writes(nb).rstrip("\n"), name


def _roots(tree):
    """The top-level modules a cell imports."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add((node.module or "").split(".")[0])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_cells_import_the_port_only_and_plot_only_in_plot_cells(name):
    """No cell imports jax or gpim_tpu, matplotlib shows up in no cell, a
    plot cell holds only calls of utils.plot_*, and every model takes
    use_gpu=USE_GPU."""
    models = 0
    for _, src, plot in _cells(name):
        tree = ast.parse(src)
        assert not _roots(tree) & {"jax", "gpim_tpu", "matplotlib"}, src
        assert "matplotlib" not in src and "plt." not in src, src
        if plot:
            for stmt in tree.body:
                call = getattr(stmt, "value", None)
                assert isinstance(stmt, ast.Expr) and isinstance(
                    call, ast.Call), src
                assert isinstance(call.func, ast.Attribute) and isinstance(
                    call.func.value, ast.Name), src
                assert call.func.value.id == "utils", src
                assert call.func.attr.startswith("plot_"), src
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) in MODELS):
                models += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert getattr(kw.get("use_gpu"), "id", None) == "USE_GPU"
    assert models == 1


def _first_model_cell(name):
    return next(i for i, src, plot in _cells(name)
                if not plot and "use_gpu=USE_GPU" in src)


@pytest.mark.parametrize("name", NAMES)
def test_without_a_card_the_first_model_cell_raises(name, tmp_path,
                                                    monkeypatch):
    """The card is the notebooks' default device: with none, and the CPU
    not asked for, the first model cell raises (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device") as err:
        _notebook.execute(_path(name), iters=2, device="cuda",
                          cwd=str(tmp_path))
    where = "%s:cell %d" % (_path(name), _first_model_cell(name))
    frames = traceback.extract_tb(err.value.__traceback__)
    assert where in [f.filename for f in frames]
    # the cells before it ran
    assert [f.filename for f in frames].count(where) == 1


def test_unset_device_means_the_card(tmp_path, monkeypatch):
    """GPIM_TPU_TORCH_NB_DEVICE unset: the SETUP cell asks for the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(_notebook.ENV_DEVICE, raising=False)
    monkeypatch.setenv(_notebook.ENV_ITERS, "2")
    monkeypatch.chdir(tmp_path)
    ns = {}
    cells = [src for _, src, _ in _notebook.code_cells(_path("quickstart"))]
    exec(cells[0], ns)
    assert ns["USE_GPU"] is True and ns["ITERS"] == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exec(cells[1], ns)
