"""Training utilities: masked losses and metrics, and a train step.

Counterpart of ``graphneuralnetworks_tpu/training.py``. The JAX package
jits a pure step over an optax state; here the step is eager PyTorch:
forward, ``backward()`` and ``optimizer.step()``. ``torch.optim.Adam`` and
``optax.adam`` apply the same update (bias-corrected moments, ``eps``
outside the square root).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["masked_cross_entropy", "masked_accuracy", "make_train_step"]


def masked_cross_entropy(logits, labels, mask):
    """Mean softmax cross-entropy over the entries where ``mask`` is True."""
    ls = torch.log_softmax(logits, -1)
    nll = -ls.gather(-1, labels.long()[:, None])[:, 0]
    m = mask.to(ls.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1)


def masked_accuracy(logits, labels, mask):
    """Share of the entries where ``mask`` is True that ``logits`` get right."""
    hit = (logits.argmax(-1) == labels).to(torch.float32)
    m = mask.to(torch.float32)
    return (hit * m).sum() / m.sum().clamp(min=1)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable):
    """``step(*batch) -> loss``: one forward, backward and optimizer update.

    ``loss_fn(model, *batch)`` returns a scalar tensor. The returned loss is
    detached; reading its value waits for the device.
    """

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
