"""The general traffic generator and the closed loop.

A traffic mix (``traffic/<name>.json``) gives the loop (``"closed"``), its
``clients`` and ``max_batch``, how many answers of each shape are compared
(``compared_per_shape``), and its shapes: each a query of ``queries/``, a
weight, and a sampler for every parameter:

* ``{"sampler": "uniform", "entity": E}``: an id of E, uniform;
* ``{"sampler": "paths", "entity": E, "path": [[table, key], ...]}``: an id
  of E drawn in proportion to its count of paths along the hops, each hop
  from ``key`` of ``table`` to the relation's other key (``[["DT", "Term"]]``
  weighs a term by its DT rows).

Requests are drawn in the order they are issued from one stream seeded by
the run's seed. The loop takes the oldest queued request and the queued
requests of its shape, up to ``max_batch``, answers them in one call, and
sends each answered client's next request at that moment. The loop is
deterministic, so a seed fixes every batch the window makes; only how many
of them fit into the window varies.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

#: Requests drawn at a time.
DRAW = 4096


def path_weights(graph: dict, entity: str, path: list) -> np.ndarray:
    """Paths from each id of ``entity`` along ``path`` (float64)."""
    rels = graph["relationships"]
    w = None
    for table, key in reversed(path):
        r = rels[table]
        other = r["fk2"] if key == r["fk1"] else r["fk1"]
        src_ent = r["entity1"] if key == r["fk1"] else r["entity2"]
        n = graph["entities"][src_ent]["size"]
        k = r["columns"][key]
        w = (np.bincount(k, minlength=n).astype(np.float64) if w is None
             else np.bincount(k, weights=w[r["columns"][other]], minlength=n))
    if len(w) != graph["entities"][entity]["size"]:
        raise ValueError(f"path {path} does not start at {entity}")
    return w


class Sampler:
    def __init__(self, spec: dict, graph: dict):
        n = graph["entities"][spec["entity"]]["size"]
        kind = spec["sampler"]
        if kind == "uniform":
            self.n, self.cdf = n, None
        elif kind == "paths":
            w = path_weights(graph, spec["entity"], spec["path"])
            if w.sum() <= 0:
                raise ValueError(f"no paths along {spec['path']}")
            self.n, self.cdf = n, np.cumsum(w) / w.sum()
        else:
            raise ValueError(f"unknown sampler {kind!r}")

    def draw(self, rng: np.random.Generator, size: int) -> np.ndarray:
        if self.cdf is None:
            return rng.integers(0, self.n, size=size)
        return np.minimum(np.searchsorted(self.cdf, rng.random(size), side="right"), self.n - 1)


class Stream:
    """Requests in issue order, each known by its ordinal: a shape by the
    weights, then its parameters, drawn in blocks from
    ``np.random.default_rng([seed, stream])``."""

    def __init__(self, traffic: dict, graph: dict, seed: int, stream: int = 0):
        self.rng = np.random.default_rng([int(seed), stream])
        self.names = [s["query"] for s in traffic["shapes"]]
        w = np.asarray([float(s["weight"]) for s in traffic["shapes"]])
        self.p = w / w.sum()
        self.samplers = [{k: Sampler(v, graph) for k, v in s["params"].items()}
                         for s in traffic["shapes"]]
        self.shape = np.zeros(0, dtype=np.int64)
        self.params = [{k: np.zeros(0, dtype=np.int64) for k in ss} for ss in self.samplers]
        self.issued = []  # issue time of each ordinal

    def _fill(self) -> None:
        self.shape = np.concatenate([self.shape, self.rng.choice(len(self.names), size=DRAW,
                                                                  p=self.p)])
        for ss, ps in zip(self.samplers, self.params):
            for k, smp in ss.items():
                ps[k] = np.concatenate([ps[k], smp.draw(self.rng, DRAW)])

    def issue(self, n: int, now: float) -> range:
        """The next ``n`` requests, issued at ``now``: their ordinals."""
        i = len(self.issued)
        while i + n > self.shape.shape[0]:
            self._fill()
        self.issued.extend([now] * n)
        return range(i, i + n)

    def arrays(self, batch: list) -> dict:
        """The parameters of a batch of one shape, a ``[B]`` array each."""
        idx = np.asarray(batch)
        return {k: v[idx] for k, v in self.params[int(self.shape[idx[0]])].items()}

    def batch_of(self, shape: str, n: int) -> list:
        """``n`` requests of ``shape`` (for warm-up and the control),
        skipping the others."""
        s = self.names.index(shape)
        out = []
        while len(out) < n:
            i = self.issue(1, 0.0)[0]
            if self.shape[i] == s:
                out.append(i)
        return out


def closed_loop(answer, stream: Stream, clients: int, max_batch: int, seconds: float,
                on_batch, sync=None, clock=time.perf_counter):
    """Run the window: ``answer(shape, params)`` returns one outcome a
    request; ``on_batch(shape, batch, outcomes, t_done)`` records them
    (``batch``: the requests' ordinals). The clients stop sending at
    ``seconds``; the requests already sent are answered. Returns
    ``(t_start, t_last, batches)``."""
    if sync is not None:
        sync()
    t0 = clock()
    t_end = t0 + seconds
    queue = deque(stream.issue(clients, t0))
    t, n = t0, 0
    while queue:
        kinds = stream.shape
        s = kinds[queue[0]]
        batch, rest = [], deque()
        for r in queue:
            (batch if kinds[r] == s and len(batch) < max_batch else rest).append(r)
        queue = rest
        shape = stream.names[int(s)]
        with torch.profiler.record_function("gq.batch"):
            outcomes = answer(shape, stream.arrays(batch))
        t = clock()
        n += 1
        with torch.profiler.record_function("gq.record"):
            on_batch(shape, batch, outcomes, t)
        if t < t_end:
            with torch.profiler.record_function("gq.issue"):
                queue.extend(stream.issue(len(batch), t))
    return t0, t, n
