"""Checkpoint and resume of model and optimizer state.

Counterpart of ``graphneuralnetworks_tpu/checkpoint.py``, with its layout:
``ckpt_dir/step_<N:010d>`` per step and ``ckpt_dir/latest.json`` holding
``{"step": N}``. A step's directory holds ``state.pt``, written by
``torch.save`` of the state dicts: each entry of the saved tree that has
one (a module, an optimizer) is saved as its ``state_dict()``, anything
else (a tensor, a number, a dict of them) as it is. The JAX package's
orbax route has no counterpart.
"""

from __future__ import annotations

import json
import os

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_STATE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def _write(path: str, write) -> None:
    """``write(tmp)`` then an atomic rename onto ``path``."""
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Save ``tree`` (a dict of modules, optimizers and tensors, or one of
    them) under ``ckpt_dir/step_<N>`` and point ``latest.json`` at it.
    Returns the step's directory."""
    path = _step_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)

    def state(v):
        return v.state_dict() if hasattr(v, "state_dict") else v

    data = ({k: state(v) for k, v in tree.items()} if isinstance(tree, dict)
            else state(tree))
    _write(os.path.join(path, _STATE), lambda f: torch.save(data, f))

    def meta(f):
        with open(f, "w") as fh:
            json.dump({"step": step}, fh)

    _write(os.path.join(ckpt_dir, "latest.json"), meta)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    meta = os.path.join(ckpt_dir, "latest.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["step"]


def _restore(target, saved):
    """Load ``saved`` into ``target``: a module or optimizer in place (its
    ``load_state_dict`` puts the values on its own parameters' devices), a
    tensor as a copy on the target's device, a dict entry by entry."""
    if hasattr(target, "load_state_dict"):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Tensor):
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        return {k: _restore(v, saved[k]) for k, v in target.items()}
    return saved


def restore_checkpoint(ckpt_dir: str, target, step: int | None = None):
    """Restore the step's state (the latest by default) into ``target``,
    the structure :func:`save_checkpoint` was given: modules and optimizers
    load in place (in the dict's order: a model before its optimizer), on
    their own devices. Returns ``target`` with tensors replaced by their
    restored values."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    saved = torch.load(os.path.join(_step_dir(ckpt_dir, step), _STATE),
                       map_location="cpu", weights_only=True)
    return _restore(target, saved)
