"""
``gpim_tpu_torch.entry`` on the CPU: the predict step and its seeded
arguments against ``__graft_entry__.entry()``'s (JAX) in float32, the card
as its default device, and ``dryrun_multichip`` forwarding its process
count to the parallel layer's dry run (whose real worlds
``tests/test_torch_parallel.py`` runs).
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from gpim_tpu_torch import entry
from gpim_tpu_torch.parallel import distributed


def test_entry_matches_the_jax_entry():
    fn, args = entry.entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    u, X, y, mask, bounds, jitter, chunks = args
    assert X.dtype == torch.float32 and X.device.type == "cpu"
    assert tuple(X.shape) == (256, 2) and tuple(chunks.shape) == (4, 128, 2)
    # the same seeded arrays
    for ours, theirs in ((X, jargs[1]), (y, jargs[2]), (mask, jargs[3]),
                         (chunks, jargs[6])):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    for k in u:
        np.testing.assert_array_equal(u[k].numpy(), np.asarray(jargs[0][k]))
    mean, var = fn(*args)
    jmean, jvar = jfn(*jargs)
    assert mean.shape == var.shape == (512,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jmean).max()))
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-4)


def test_entry_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_forwards_the_process_count(n, monkeypatch):
    calls = []

    def fake(n_procs):
        calls.append(n_procs)
        return {"multitask": {"mean": 0.0}, "vfe": {"mean": 0.0}}

    monkeypatch.setattr(distributed, "dryrun_multiprocess", fake)
    assert entry.dryrun_multichip(n) == fake(n)
    assert calls[0] == n


def test_dryrun_multichip_checks_the_report(monkeypatch):
    monkeypatch.setattr(distributed, "dryrun_multiprocess",
                        lambda n_procs: {"multitask": {}})
    with pytest.raises(AssertionError, match="vfe"):
        entry.dryrun_multichip(2)
