"""
Run the port's example notebooks (``gpim_tpu_torch/examples/notebooks``)
without Jupyter, with the standard library alone.

A notebook is read as JSON, and its code cells run in order in one fresh
namespace, in this process. The cells tagged ``plot`` (in their
``metadata.tags``) hold the plotting calls and nothing else; they are
skipped, since plotting needs matplotlib. Any cell that raises propagates.

    ns, skipped = execute("quickstart.ipynb", iters=2, device="cpu")
"""

import contextlib
import json
import os
import sys

__all__ = ["code_cells", "execute", "PLOT_TAG", "ENV_ITERS", "ENV_DEVICE",
           "ENV_REPO"]

# the tag of the cells that plot, and do nothing else
PLOT_TAG = "plot"

# the notebooks' SETUP cell reads these
ENV_ITERS = "GPIM_TPU_TORCH_NB_ITERS"
ENV_DEVICE = "GPIM_TPU_TORCH_NB_DEVICE"
ENV_REPO = "GPIM_TPU_TORCH_REPO"
# the checkout's root: the directory that holds the gpim_tpu_torch package
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def code_cells(path, skip_tags=(PLOT_TAG,)):
    """[(cell number in the notebook, source, tags)] of the notebook's code
    cells, in order, without those that carry a tag in ``skip_tags``."""
    with open(path, encoding="utf-8") as f:
        nb = json.load(f)
    out = []
    for i, cell in enumerate(nb["cells"]):
        if cell["cell_type"] != "code":
            continue
        tags = tuple(cell.get("metadata", {}).get("tags", ()))
        if set(tags) & set(skip_tags):
            continue
        src = cell["source"]
        src = "".join(src) if isinstance(src, list) else src
        out.append((i, src, tags))
    return out


@contextlib.contextmanager
def _environment(env, cwd):
    """Set (a value) or remove (None) the variables of ``env`` and enter
    ``cwd``; restores the environment, ``sys.path`` and the working
    directory on the way out."""
    saved = {k: os.environ.get(k) for k in env}
    path, here = list(sys.path), os.getcwd()
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if cwd is not None:
            os.chdir(cwd)
        yield
    finally:
        os.chdir(here)
        sys.path[:] = path
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def execute(path, *, iters=None, device="cuda", cwd=None):
    """Run the notebook at ``path``: its code cells in order, in one fresh
    namespace, inside ``cwd`` (default: the current directory), with the
    environment its SETUP cell reads: ``iters`` iterations (None: the
    notebook's full budget), ``device`` ("cpu" for the CPU, else the CUDA
    card) and this checkout on ``sys.path``. Cells tagged ``plot`` are
    skipped. Returns (the namespace, the skipped cells' numbers in the
    notebook)."""
    path = os.path.abspath(path)
    env = {ENV_ITERS: None if iters is None else str(int(iters)),
           ENV_DEVICE: device, ENV_REPO: _REPO}
    ns = {"__name__": "__main__"}
    skipped = []
    with _environment(env, cwd):
        for i, src, tags in code_cells(path, skip_tags=()):
            if PLOT_TAG in tags:
                skipped.append(i)
                continue
            exec(compile(src, "%s:cell %d" % (path, i), "exec"), ns)
    return ns, skipped
