"""
gpim_tpu_torch's host-side pieces: grid utilities against gpim_tpu.utils
(the section-2.4 fixes pinned in test_gridutils.py), precision helpers,
the span recorder's summary and the trace, the masked-lattice engine's memory
accounting, parameter conversion, package settings, the kernel build
recipe, and a static scan that the port imports no JAX.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from gpim_tpu.utils import gridutils as jg

import gpim_tpu_torch
from gpim_tpu_torch import convert, dtypes
from gpim_tpu_torch.ops import _build, gram_kernels
from gpim_tpu_torch.utils import gridutils as g
from gpim_tpu_torch.utils import profiling
from gpim_tpu_torch.utils.profiling import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "gpim_tpu", "matplotlib"}


def _same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert_array_equal(a, b)


def _sparse(shape, seed, frac=0.4):
    rng = np.random.RandomState(seed)
    R = rng.rand(*shape)
    R[rng.rand(*shape) < frac] = np.nan
    return R


GRID_CASES = {
    "full_grid": lambda m: m.get_full_grid(np.zeros((5, 7))),
    "full_grid_dense_x": lambda m: m.get_full_grid(np.zeros((4, 4)),
                                                   dense_x=0.5),
    "full_grid_extent_2d": lambda m: m.get_full_grid(
        np.zeros((10, 10)), extent=[[0, 5], [0, 5]]),
    "full_grid_extent_3d": lambda m: m.get_full_grid(
        np.zeros((8, 8, 4)), extent=[[0, 4], [0, 4], [0, 2]]),
    "full_grid_4d": lambda m: m.get_full_grid(np.zeros((3, 4, 5, 2))),
    "sparse_grid_2d": lambda m: m.get_sparse_grid(_sparse((6, 6), 0)),
    "sparse_grid_3d_xy": lambda m: m.get_sparse_grid(
        np.where((np.random.RandomState(2).rand(5, 5) < 0.5)[..., None],
                 np.nan, np.random.RandomState(1).rand(5, 5, 8))),
    "sparse_grid_4d": lambda m: m.get_sparse_grid(_sparse((3, 3, 4, 2), 3)),
    "grid_indices": lambda m: m.get_grid_indices(
        np.where(np.eye(5, dtype=bool), np.nan, 1.0)),
    "training_data": lambda m: m.prepare_training_data(
        m.get_sparse_grid(_sparse((6, 7), 4)), _sparse((6, 7), 4)),
    "training_data_single": lambda m: m.prepare_training_data(
        m.get_sparse_grid(_sparse((6, 7), 4)), _sparse((6, 7), 4),
        precision="single"),
    "training_data_vector": lambda m: m.prepare_training_data(
        m.get_full_grid(np.zeros((4, 4))),
        _sparse((4, 4, 3), 5, frac=0.1), vector_valued=True),
    "test_data": lambda m: m.prepare_test_data(
        m.get_full_grid(np.zeros((3, 5))), precision="single"),
    "corrupt_2d": lambda m: m.corrupt_data_xy(
        m.get_full_grid(np.ones((10, 10))),
        np.random.RandomState(0).rand(10, 10), prob=0.5),
    "corrupt_3d": lambda m: m.corrupt_image3d(
        m.get_full_grid(np.ones((8, 8, 5))),
        np.random.RandomState(0).rand(8, 8, 5), 0.5, True),
    "open_edge_points": lambda m: m.open_edge_points(
        np.full((12, 12), np.nan), np.ones((12, 12)), s=4),
    "to_constrained_interval": lambda m: m.to_constrained_interval(
        {"lenghtscale_map_unconstrained": np.array([0.3, -1.0]),
         "variance_map_unconstrained": np.array(0.5)},
        [[0., 0.], [10., 10.]], [1e-4, 10.]),
}


def test_full_grid_extent_non_divisible_span():
    """tests/test_review_fixes.py's fix on the port: extent spans that do
    not divide the shape (larger and smaller than it) give axes of the
    shape's sizes, and the sparse grid stays consistent with the full
    one; the same arrays as gpim_tpu's."""
    R = np.zeros((50, 50))
    X = g.get_full_grid(R, extent=[[0, 100], [0, 100]])
    assert X.shape == (2, 50, 50)
    assert np.isclose(X[0].min(), 0) and X[0].max() < 100
    X2 = g.get_full_grid(R, extent=[[0, 30], [0, 30]])
    assert X2.shape == (2, 50, 50)
    Rn = R.copy()
    Rn[10:20, 10:20] = np.nan
    Xs = g.get_sparse_grid(Rn, extent=[[0, 30], [0, 30]])
    assert Xs.shape == (2, 50, 50)
    assert np.isnan(Xs[0][10, 10]) and not np.isnan(Xs[0][0, 0])
    for got, ref in ((X, jg.get_full_grid(R, extent=[[0, 100], [0, 100]])),
                     (X2, jg.get_full_grid(R, extent=[[0, 30], [0, 30]])),
                     (Xs, jg.get_sparse_grid(Rn, extent=[[0, 30],
                                                         [0, 30]]))):
        _same(got, ref)


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_gridutils_equal_gpim_tpu(case):
    _same(GRID_CASES[case](g), GRID_CASES[case](jg))


def test_gridutils_errors_match():
    for m in (g, jg):
        with pytest.raises(NotImplementedError):
            m.get_sparse_grid(np.ones((4, 4)))
        with pytest.raises(NotImplementedError):
            m.get_full_grid(np.zeros((2, 2, 2, 2, 2)))
    assert g.__all__ == jg.__all__
    assert gpim_tpu_torch.utils.__all__ == g.__all__


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    """No JAX or gpim_tpu anywhere in the port; matplotlib only in the
    plotting module, which the package imports on first use (the CUDA
    machine has none; tests/test_torch_viz.py imports the package with
    matplotlib blocked)."""
    files = sorted((ROOT / "gpim_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    viz = ROOT / "gpim_tpu_torch" / "utils" / "viz.py"
    assert viz in files and "matplotlib" in set(_imports(viz))
    offenders = {str(f.relative_to(ROOT)): sorted(
        set(_imports(f)) & (FORBIDDEN - {"matplotlib"} if f == viz
                            else FORBIDDEN)) for f in files}
    assert not {k: v for k, v in offenders.items() if v}


def test_package_pins_full_precision_matmuls():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert gpim_tpu_torch.__all__ == ["utils", "reconstructor",
                                      "skreconstructor", "vreconstructor",
                                      "boptimizer"]


def test_dtypes():
    assert dtypes.resolve_dtype(None, torch.device("cpu")) == torch.float64
    assert dtypes.resolve_dtype(None, "cuda") == torch.float32
    assert dtypes.resolve_dtype(None) == torch.float64
    assert dtypes.resolve_dtype("single", "cpu") == torch.float32
    assert dtypes.resolve_dtype("double", "cuda") == torch.float64
    with pytest.raises(ValueError):
        dtypes.resolve_dtype("half")
    assert dtypes.default_jitter(torch.float64) == 1e-5
    assert dtypes.default_jitter(torch.float32) == 1e-4
    assert [dtypes.round_up(x, 128) for x in (1, 128, 129, 6036)] == \
        [128, 128, 256, 6144]


def test_timer_records_first_and_warm_calls():
    """The recorder's per-name summary, which replaced the phase timer:
    the first call apart from the mean of the warm ones."""
    with profiling.spans() as rec:
        for _ in range(3):
            with profiling.span("recon.train"):
                pass
        with profiling.span("recon.predict"):
            pass
    s = rec.summary()
    assert s["recon.train"]["calls"] == 3
    assert s["recon.train"]["first_s"] >= 0 and s["recon.train"]["warm_s"] >= 0
    assert s["recon.predict"] == {"calls": 1, "warm_s": None,
                                  "first_s": s["recon.predict"]["first_s"]}


def test_convert_from_numpy():
    u = {"lengthscale": np.array([0.1, 0.2]), "variance": np.asarray(0.3),
         "noise": np.asarray(-1.0, np.float32)}
    t = convert.params_from_numpy(u, torch.device("cpu"), torch.float32)
    assert set(t) == set(u)
    assert all(v.dtype == torch.float32 for v in t.values())
    assert t["variance"].shape == () and t["lengthscale"].shape == (2,)
    b = convert.bounds_from_numpy({"ls_lo": np.zeros(2)}, "cpu",
                                  torch.float64)
    assert b["ls_lo"].dtype == torch.float64


def test_kernel_build_recipe():
    """The CUDA library is built for sm_90a from the package's source,
    without fast math, into a build directory git ignores; the CPU path
    never builds or loads it."""
    assert _build.SOURCE.is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in _build.NVCC_FLAGS)
    rel = _build.BUILD_DIR.relative_to(ROOT).as_posix()
    assert rel == "build/gpim_tpu_torch"
    assert "build/gpim_tpu_torch/" in (ROOT / ".gitignore").read_text()
    src = _build.SOURCE.read_text()
    for name in _build._SIGNATURES:
        for suffix in ("f32", "f64"):
            assert "int %s_%s(" % (name, suffix) in src
    X = torch.rand(8, 2, dtype=torch.float64)
    gram_kernels.sqdist(X, X)
    assert _build.load_library.cache_info().currsize == 0


def test_trace_writes_a_chrome_trace_of_a_cpu_train(tmp_path):
    """utils.profiling.trace around 2 training steps on the CPU writes one
    Chrome trace into logdir, with the operators the steps ran."""
    import json
    from gpim_tpu_torch import reconstructor
    R = _sparse((12, 12), 7)
    model = reconstructor(g.get_sparse_grid(R), R, g.get_full_grid(R),
                          iterations=2, use_gpu=False, verbose=0)
    with trace(str(tmp_path / "tr")) as logdir:
        model.train()
    assert logdir == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name", "") for e in json.loads(
        files[0].read_text())["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert {"aten::linalg_cholesky_ex", "aten::mm"} <= names


def test_memory_analysis_model_on_a_small_lattice():
    """MaskedGridEngine.train_memory_analysis: the grid's sizes and the
    analytic model of gpim_tpu mgrid_model.py:520-536, computed here from
    the shapes; on the CPU no measured peak and the error it records."""
    from gpim_tpu_torch.gpreg.mgrid_model import MaskedGridEngine
    shape = (10, 9, 6)
    rng = np.random.RandomState(0)
    mask = rng.rand(*shape) < 0.6
    axes = [np.arange(s, dtype=np.float64) for s in shape]
    for dtype, isz in ((torch.float64, 8), (torch.float32, 4)):
        eng = MaskedGridEngine("RBF", axes, mask, rng.rand(*shape), dtype,
                               "cpu", n_probes=5, precond_rank=64)
        out = eng.train_memory_analysis(None, None, 0.1, 1e-4,
                                        iterations=7)
        G, p, r = 540, 5, 64
        assert (out["G"], out["grid_shape"], out["rank"], out["n_probes"],
                out["itemsize"]) == (G, shape, r, p, isz)
        assert out["analytic_bytes"] == {
            "cg_state_4x(p+1)G": 4 * (p + 1) * G * isz,
            "probe_block_pG": p * G * isz,
            "grid_vectors_y_mask": 2 * G * isz,
            "precond_factored_rr": r * r * isz + (100 + 81 + 36) * isz,
            "trajectory_per_iter": 7 * (2 + 3) * isz}
        assert "cpu" in out["memory_analysis_error"]
        assert "peak_allocated_bytes" not in out
