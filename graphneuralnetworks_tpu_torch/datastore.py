"""DataStore: a dict of feature arrays with one leading dimension.

Counterpart of ``graphneuralnetworks_tpu/datastore.py`` (reference
GNNGraphs datastore.jl:59-200): attribute and index access, ``map`` over
the features, ``getobs`` by index, array or mask, and concatenation. The
values are tensors (``torch.cat`` joins them) or numpy arrays
(``np.concatenate``).
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping

import numpy as np
import torch

__all__ = ["DataStore"]


class DataStore(Mapping):
    """A dict of arrays whose leading dims all equal ``n``.

    >>> ds = DataStore(x=np.ones((5, 3)), y=np.zeros(5))
    >>> ds.n, ds.x.shape
    (5, (5, 3))
    """

    def __init__(self, n: int | None = None, _data=None, **feats):
        data = dict(_data or {})
        data.update(feats)
        self._data = {}
        self._n = n
        for k, v in data.items():
            self._set(k, v)

    def __getitem__(self, k):
        return self._data[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __getattr__(self, k):
        try:
            return self._data[k]
        except KeyError:
            raise AttributeError(k) from None

    @property
    def n(self) -> int | None:
        return self._n

    def _set(self, k, v):
        if not hasattr(v, "shape"):
            v = np.asarray(v)
        if v.ndim == 0:
            raise ValueError(f"feature {k!r} must have a leading dim")
        if self._n is None:
            self._n = int(v.shape[0])
        elif v.shape[0] != self._n:
            raise ValueError(
                f"feature {k!r} leading dim {v.shape[0]} != n={self._n} "
                "(datastore.jl:59-106 invariant)")
        self._data[k] = v

    def getdata(self) -> dict:
        """The raw dict (reference ``getdata``)."""
        return dict(self._data)

    def getn(self) -> int | None:
        return self._n

    def map(self, fn: Callable) -> "DataStore":
        """``fn`` applied to every feature (datastore.jl ``map``)."""
        return DataStore(_data={k: fn(v) for k, v in self._data.items()})

    def getobs(self, idx) -> "DataStore":
        """The observations ``idx``: an int, an index array or a mask."""
        return DataStore(_data={k: v[idx] for k, v in self._data.items()})

    @staticmethod
    def cat(stores: list["DataStore"]) -> "DataStore":
        """Concatenate along the observation axis (``cat_features``)."""
        keys = set().union(*[set(s) for s in stores])
        out = {}
        for k in keys:
            parts = [s[k] for s in stores if k in s]
            if len(parts) != len(stores):
                raise ValueError(f"feature {k!r} missing in some stores")
            out[k] = (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                      else np.concatenate([np.asarray(p) for p in parts]))
        return DataStore(_data=out)

    def __repr__(self):
        inner = ", ".join(f"{k}: {tuple(v.shape)}"
                          for k, v in self._data.items())
        return f"DataStore(n={self._n}, {inner})"
