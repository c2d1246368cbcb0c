"""Profiling: traces, step timing and a layer sweep.

Counterpart of ``graphneuralnetworks_tpu/profiling.py`` (reference
GraphNeuralNetworks perf/perf.jl:10-99). :func:`trace` runs
``torch.profiler`` and writes a Chrome trace. :class:`StepTimer` times
steps on the card with CUDA events recorded on the current stream (host
clocks move up to 60 % between passes on a shared host), and on the CPU
with ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from . import resolve_device

__all__ = ["trace", "StepTimer", "benchmark_layers"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and, where there is a card, CUDA activity)
    and write its Chrome trace to ``logdir/trace_<pid>_<ns>.json``. Yields
    the ``torch.profiler.profile``; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


class StepTimer:
    """Step timing and an edges/s counter for training loops::

        timer = StepTimer(num_edges=g.num_edges)
        for ...:
            with timer:
                step()
        print(timer.report())

    On a CUDA ``device`` (``None``: the card) each step is the time between
    two CUDA events recorded on the current stream at the block's start and
    end, read when :attr:`history` is (which waits for the last one); on
    the CPU, ``time.perf_counter`` around the block.
    """

    def __init__(self, num_edges: int | None = None, *, device=None):
        self.num_edges = num_edges
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._t = None
        self._events: list = []
        self._done: list[float] = []

    def __enter__(self):
        if self._cuda:
            self._t = torch.cuda.Event(enable_timing=True)
            self._t.record()
        else:
            self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._t, end))
        else:
            self._done.append(time.perf_counter() - self._t)

    @property
    def history(self) -> list[float]:
        """Seconds per step, in order."""
        for start, end in self._events:
            end.synchronize()
            self._done.append(start.elapsed_time(end) / 1e3)
        self._events.clear()
        return list(self._done)

    @property
    def mean_s(self) -> float:
        h = self.history
        h = h[1:] or h  # drop the first (warm-up) step
        return sum(h) / max(len(h), 1)

    @property
    def edges_per_s(self) -> float | None:
        if self.num_edges is None or not self.history:
            return None
        return self.num_edges / self.mean_s

    def report(self) -> str:
        out = {"steps": len(self.history),
               "mean_ms": round(self.mean_s * 1e3, 3)}
        if self.edges_per_s is not None:
            out["edges_per_s"] = round(self.edges_per_s)
        return json.dumps(out)


def benchmark_layers(layer_factories: dict, graph_sizes=(10, 100, 1000),
                     *, d: int = 64, iters: int = 10, seed: int = 0,
                     device=None) -> list[dict]:
    """Layer x graph-size sweep (the perf/perf.jl:10-99 analog).

    ``layer_factories``: ``{name: (din, dout) -> nn.Module}``, each built
    on ``device`` by the factory. Returns a list of ``{layer, n,
    forward_ms, grad_ms}`` rows: the mean over ``iters`` calls of the
    forward (no gradient) and of the gradient of ``sum(out ** 2)`` in ``x``,
    after one warm-up call of each, timed by :class:`StepTimer` on
    ``device`` (``None``: the card).
    """
    import numpy as np

    from . import rand_graph

    device = resolve_device(device)
    rows = []
    for name, make in layer_factories.items():
        for n in graph_sizes:
            g = rand_graph(n, min(n * 10, n * (n - 1) // 2 * 2 or 2),
                           seed=seed, device=device)
            x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
                (g.num_nodes, d)), dtype=torch.float32, device=device)
            layer = make(d, d)

            def fwd():
                with torch.no_grad():
                    return layer(g, x)

            def grad():
                xx = x.clone().requires_grad_()
                return torch.autograd.grad((layer(g, xx) ** 2).sum(), xx)[0]

            times = []
            for fn in (fwd, grad):
                timer = StepTimer(device=device)
                for _ in range(iters + 1):
                    with timer:
                        fn()
                times.append(timer.mean_s)
            rows.append({"layer": name, "n": n,
                         "forward_ms": round(times[0] * 1e3, 3),
                         "grad_ms": round(times[1] * 1e3, 3)})
    return rows
