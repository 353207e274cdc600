"""The port's finite guard keeps the contract JAX's
``tests/test_chunked_fit.py::test_finite_guard_off_bitmatches_when_finite``
states: on a run whose every step is finite, ``Trainer(finite_guard=True)``
and ``finite_guard=False`` give the same history and the same final and
best parameters, bit for bit, at K = 1 and K = 3 epochs a dispatch."""

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
from hyperbolic_vae_tpu_torch.train import Trainer


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit(guard: bool, k: int):
    x, y, xt, yt = synthetic_mnist_arrays(288, 32, seed=5)
    dm = ArrayDataModule(x[:256], y[:256], x[256:], y[256:], xt, yt, batch_size=64)
    model = GyroplaneVAE(generator=torch.Generator().manual_seed(3), device="cpu")
    trainer = Trainer(model, max_epochs=3, epochs_per_dispatch=k, early_stopping_patience=None,
                      finite_guard=guard, device="cpu")
    return trainer.fit(dm)


@pytest.mark.parametrize("k", [1, 3])
def test_finite_guard_off_equals_on_when_finite(k):
    on, off = _fit(True, k), _fit(False, k)
    assert len(on.history) == len(off.history) == 3
    for a, b in zip(on.history, off.history):
        assert a.keys() == b.keys()
        assert all(np.isfinite(a[m]) for m in a)
        assert a == b
    assert all(row["train/skipped_steps"] == 0 for row in on.history)
    for d in ("params", "best_params"):
        for name, v in getattr(on, d).items():
            assert torch.equal(v, getattr(off, d)[name]), (d, name)
