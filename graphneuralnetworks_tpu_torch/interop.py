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


# nnx.OptimizedLSTMCell's (dense, key) -> torch.nn.LSTMCell's name
_LSTM = {("dense_i", "kernel"): "weight_ih", ("dense_h", "kernel"): "weight_hh",
         ("dense_h", "bias"): "bias_hh"}


def _load_lstm(cell: nn.LSTMCell, tree: Mapping, path: str) -> None:
    """``nnx.OptimizedLSTMCell``'s ``dense_i`` (kernel ``[in, 4h]``, no
    bias) and ``dense_h`` (kernel ``[h, 4h]``, bias ``[4h]``) into the torch
    cell, gates in the same order (i, f, g, o): kernels transposed, the one
    bias to ``bias_hh``, and ``bias_ih`` zeroed."""
    cell.bias_ih.zero_()
    for dense, sub in tree.items():
        for key, value in sub.items():
            where = f"{path}/{dense}/{key}"
            if (dense, key) not in _LSTM:
                raise KeyError(f"{where}: no such parameter in LSTMCell")
            arr = np.asarray(value)
            _copy(getattr(cell, _LSTM[dense, key]),
                  arr.T if key == "kernel" else arr, where)


def _load(module: nn.Module, tree: Mapping, path: str) -> None:
    if isinstance(module, nn.LSTMCell):
        return _load_lstm(module, tree, path)
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
        _copy(target, arr, where)


def _copy(target: torch.Tensor, arr: np.ndarray, where: str) -> None:
    if tuple(target.shape) != arr.shape:
        raise ValueError(f"{where}: shape {arr.shape} != "
                         f"{tuple(target.shape)}")
    target.copy_(torch.tensor(arr))


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill ``module``'s parameters from ``params`` in place; returns it.

    Conv weights are ``[in, out]`` in both packages (stacked ones
    ``[k, in, out]``, DConv's ``[2, k, in, out]``) and copy as they are;
    Dense kernels (``nnx.Linear``, in :class:`~.models.MLP`, a head or
    ``nnx.GRUCell``'s ``dense_i``/``dense_h``, which
    :class:`~.models.GRUCell` keeps) are transposed into
    ``torch.nn.Linear.weight``; ``nnx.BatchNorm``'s
    ``scale`` goes to the weight and, given ``nnx.state(model,
    nnx.BatchStat)`` as dicts, its ``mean`` and ``var`` to the running
    statistics; ``nnx.OptimizedLSTMCell`` (``Set2Set.lstm``) to
    ``torch.nn.LSTMCell`` (see :func:`_load_lstm`; also
    ``EvolveGCNOCell.lstm``). Pooling and ``EdgeConv`` keep the JAX names
    (``p``, ``fgate``, ``ffeat``, ``nn``), and :class:`~.models.Precision`
    JAX's ``module``, under which ``nnx.state(Precision(...))`` nests the
    wrapped model. So do the hetero and recurrent layers:
    ``HeteroGraphConv.convs`` (a list, by position), ``GNNRecurrence.cell``,
    the cells' convs (``conv_x_r``, ``dconv_u``, ``conv_z``, ...), TGCN's
    and A3TGCN's Dense layers (``dense_z``, ``dense1``: kernels
    transposed) and GConvLSTM's peephole vectors ``w_i``, ... and biases
    ``b_i``, ... (copied as they are). The edge-featured layers keep
    JAX's names too: ``NNConv``'s ``weight`` and ``bias`` (copied) and
    ``nn`` (its module's); ``CGConv``'s ``dense_f`` and ``dense_s``,
    ``GMMConv``'s ``dense_x`` (Dense: kernels transposed) and its ``mu``,
    ``sigma_inv`` and ``bias`` (copied); ``MEGNetConv``'s ``phi_e`` and
    ``phi_v``; ``EGNNConv``'s ``phi_e`` and ``phi_h`` (:class:`~.models.MLP`)
    and ``phi_x_hidden`` and ``phi_x_out`` (Dense, the last without bias).
    Raises on a name or shape that does not match.
    """
    with torch.no_grad():
        _load(module, params, "")
    return module
