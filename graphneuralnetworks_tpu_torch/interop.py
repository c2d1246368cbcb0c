"""Carry weights trained or initialised by the JAX package into the port.

The input is a nested dict of numpy arrays laid out like the JAX package's
``nnx.state(model, nnx.Param)`` turned into plain dicts with ``np.asarray``
leaves: list positions are int keys (``{"layers": {0: {"weight": ...}}}``).
The port never sees a JAX object.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params"]

# nnx.BatchNorm's names -> torch.nn.BatchNorm1d's (``bias`` is the same)
_BATCH_NORM = {"scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _child(module: nn.Module, key) -> nn.Module:
    if isinstance(module, (nn.ModuleList, nn.Sequential)):
        return module[int(key)]
    return getattr(module, str(key))


def _load(module: nn.Module, tree: Mapping, path: str) -> None:
    for key, value in tree.items():
        where = f"{path}/{key}"
        if isinstance(value, Mapping):
            _load(_child(module, key), value, where)
            continue
        arr = np.asarray(value)
        if isinstance(module, nn.Linear) and key == "kernel":
            # nnx.Linear stores [in, out]; torch.nn.Linear [out, in]
            target, arr = module.weight, arr.T
        elif isinstance(module, nn.BatchNorm1d) and key in _BATCH_NORM:
            target = getattr(module, _BATCH_NORM[key])
        else:
            target = getattr(module, str(key), None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"{where}: no such parameter in "
                           f"{type(module).__name__}")
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{where}: shape {arr.shape} != "
                             f"{tuple(target.shape)}")
        target.copy_(torch.tensor(arr))


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from ``params`` in place; returns it.

    Conv weights are ``[in, out]`` in both packages and copy as they are;
    Dense kernels (``nnx.Linear``, in :class:`~.models.MLP` or a head) are
    transposed into ``torch.nn.Linear.weight``; ``nnx.BatchNorm``'s
    ``scale`` goes to the weight and, given ``nnx.state(model,
    nnx.BatchStat)`` as dicts, its ``mean`` and ``var`` to the running
    statistics. Raises on a name or shape that does not match.
    """
    with torch.no_grad():
        _load(module, params, "")
    return module
