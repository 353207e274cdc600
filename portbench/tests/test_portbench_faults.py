"""A run of the harness on the CPU, past its look for a card, with the
timed path broken underneath: ``correct`` comes out false for each fault
a training cell can have (one card: no exchange between cards)."""

import contextlib
import time
from unittest import mock

import pytest
import torch

from portbench.harness import cell as cm
from portbench.tests.helpers import small_cell


def _frozen():
    """Every step returns its state unchanged."""
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff
    from hyperbolic_vae_tpu_torch.optim import RiemannianAdam

    real = ff.flagship_train_step_torch

    def k3_frozen(params, m, v, x, eps, **kw):
        _, _, _, metrics, count = real(params, m, v, x, eps, **kw)
        return tuple(params), tuple(m), tuple(v), metrics, count

    return [mock.patch.object(RiemannianAdam, "step", lambda self, *a, **k: None),
            mock.patch.object(ff, "flagship_train_step_torch", k3_frozen)]


def _half_batch():
    """Half of each batch left out, the mean taken over the rest."""
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, UnifiedVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    real = ff.flagship_train_step_torch
    patches = []
    for cls in (GyroplaneVAE, UnifiedVAE):
        loss = cls.loss
        patches.append(mock.patch.object(
            cls, "loss", lambda self, x, g=None, _l=loss: _l(self, x[: x.shape[0] // 2], g)))
    patches.append(mock.patch.object(
        ff, "flagship_train_step_torch",
        lambda params, m, v, x, eps, **kw: real(params, m, v, x[: len(x) // 2], eps[: len(x) // 2], **kw)))
    return patches


def _altered():
    """Each step's loss altered where it is produced (1 % high)."""
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE, UnifiedVAE
    from hyperbolic_vae_tpu_torch.ops import flagship_fused as ff

    real = ff.flagship_train_step_torch

    def k3_altered(*a, **kw):
        p, m, v, metrics, count = real(*a, **kw)
        return p, m, v, metrics * torch.tensor([1.01, 1.0, 1.0, 1.0]), count

    patches = [mock.patch.object(ff, "flagship_train_step_torch", k3_altered)]
    for cls in (GyroplaneVAE, UnifiedVAE):
        loss = cls.loss

        def altered(self, x, g=None, _l=loss):
            out = dict(_l(self, x, g))
            out["loss_total"] = out["loss_total"] * 1.01
            return out

        patches.append(mock.patch.object(cls, "loss", altered))
    return patches


def _first_batch():
    """Every step of an epoch fed the epoch's first batch (the row gather
    at step offsets above 0 lost)."""
    from hyperbolic_vae_tpu_torch.train import epoch_program

    real = epoch_program.batch_indices

    def first(n, batch_size, shuffle, generator, device):
        idx = real(n, batch_size, shuffle, generator, device)
        return idx[:1].expand_as(idx)

    return [mock.patch.object(epoch_program, "batch_indices", first)]


FAULTS = {"frozen": _frozen, "half_batch": _half_batch, "altered": _altered,
          "first_batch": _first_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ("flagship-train-autograd", "flagship-train-k3",
                                      "exp8-train-autograd"))
def test_fault_fails_the_check(workload, fault):
    patches = FAULTS[fault]()

    @contextlib.contextmanager
    def broken():
        with contextlib.ExitStack() as s:
            for p in patches:
                s.enter_context(p)
            yield

    out = cm.run_cell(small_cell(workload), 31337, 0.3, False, "cpu", time.monotonic(),
                      faults=broken)
    assert out["correct"] is False, out["checks"]
