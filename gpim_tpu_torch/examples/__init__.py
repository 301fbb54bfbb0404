"""
The example workflows of ``examples/*.py`` as the port's own runners, one
module each, run on the CUDA card by default:

    python -m gpim_tpu_torch.examples.sparse_image_2d
    python -m gpim_tpu_torch.examples.large_masked_ski --xl
    python -m gpim_tpu_torch.examples.<name> --cpu --iterations 2

Each module has ``run(iterations, <data>, use_gpu, outdir)``, which trains
and predicts with the script's data, kwargs and budget and returns its
arrays (and the model), and ``main(argv)``, which parses ``--iterations``,
``--cpu`` and ``--out`` (``--xl`` for ``large_masked_ski``; ``--no-plot``
where the script plots), calls ``run``, prints the script's numbers and
plots. Results (an ``.npz`` a run, and the Bayesian optimiser's
checkpoint) go to ``outdir``, by default a new temporary directory.
Plotting needs matplotlib.

``notebooks/`` holds the seven example notebooks (the six workflows and a
quickstart), written by ``notebooks/_generate.py``. Each runs on the card
unless ``GPIM_TPU_TORCH_NB_DEVICE=cpu``; ``GPIM_TPU_TORCH_NB_ITERS`` shrinks
its iteration budget. :func:`_notebook.execute` runs one without Jupyter,
skipping its cells tagged ``plot``:

    from gpim_tpu_torch.examples import _notebook
    ns, skipped = _notebook.execute(".../quickstart.ipynb", device="cpu")
"""
