"""The reference's own indexes over the generated columns and its hop.

An index of ``(table, key)`` is the relation sorted by ``key``: offsets a
key value, the other key and the measures in that order. A hop takes a
dense ``[B, n_src]`` frontier to ``[B, n_dst]``: every edge of a source live
in any row adds ``x[b, src] * measure`` into ``y[b, dst]``, in the
frontier's dtype, over blocks of edges so that the working set stays
bounded."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

#: Bytes of the ``[B, edges]`` products a hop holds at once.
BLOCK_BYTES = 1 << 29


@dataclass
class Index:
    indptr: torch.Tensor  # int64[n_src + 1]
    src: torch.Tensor  # int64[E], sorted
    dst: torch.Tensor  # int64[E]
    measures: dict
    n_src: int
    n_dst: int
    dst_col: str


class Graph:
    """The generated graph (``gen.to_host``'s form) on ``device``, with
    indexes made at first use."""

    def __init__(self, host: dict, device):
        self.device = torch.device(device)
        self.host = host
        self.sizes = {k: e["size"] for k, e in host["entities"].items()}
        self._indexes: dict = {}
        self._widths: dict = {}

    def attribute(self, entity: str, attr: str) -> torch.Tensor:
        return torch.as_tensor(self.host["entities"][entity]["attributes"][attr], device=self.device)

    def index(self, table: str, key: str) -> Index:
        got = self._indexes.get((table, key))
        if got is not None:
            return got
        r = self.host["relationships"][table]
        other = r["fk2"] if key == r["fk1"] else r["fk1"]
        src_ent = r["entity1"] if key == r["fk1"] else r["entity2"]
        dst_ent = r["entity2"] if key == r["fk1"] else r["entity1"]
        k = torch.as_tensor(r["columns"][key], device=self.device)
        order = torch.argsort(k, stable=True)
        n_src = self.sizes[src_ent]
        indptr = torch.zeros(n_src + 1, dtype=torch.int64, device=self.device)
        indptr[1:] = torch.cumsum(torch.bincount(k, minlength=n_src), 0)
        cols = {c: torch.as_tensor(v, device=self.device)[order]
                for c, v in r["columns"].items() if c not in (key, other)}
        idx = Index(indptr, k[order], torch.as_tensor(r["columns"][other], device=self.device)[order],
                    cols, n_src, self.sizes[dst_ent], other)
        self._indexes[(table, key)] = idx
        return idx

    def width_bits(self, table: str, col: str) -> int:
        """Bits a value of ``table.col`` needs at a fixed width: enough for
        its count of distinct values."""
        key = (table, col)
        if key not in self._widths:
            n = int(np.unique(self.host["relationships"][table]["columns"][col]).shape[0])
            self._widths[key] = max(1, math.ceil(math.log2(max(n, 2))))
        return self._widths[key]

    def seed(self, entity: str, ids, dtype) -> torch.Tensor:
        """One-hot rows: row b holds 1 at ``ids[b]``."""
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        x = torch.zeros(ids.shape[0], self.sizes[entity], dtype=dtype, device=self.device)
        x[torch.arange(ids.shape[0], device=self.device), ids] = 1
        return x

    def hop(self, x: torch.Tensor, table: str, key: str, measure: str | None = None,
            work: list | None = None) -> torch.Tensor:
        idx = self.index(table, key)
        B = x.shape[0]
        rows = (x != 0).sum(0)
        live = torch.nonzero(rows).squeeze(1)
        deg = idx.indptr[1:] - idx.indptr[:-1]
        counts = deg[live]
        if work is not None:
            work.append({
                "table": table, "key": key, "dst_col": idx.dst_col, "measure": measure,
                "B": B, "n_src": idx.n_src, "n_dst": idx.n_dst,
                "E_union": int(counts.sum()), "E_rows": int((rows[live] * counts).sum()),
            })
        total = int(counts.sum())
        y = torch.zeros(B, idx.n_dst, dtype=x.dtype, device=x.device)
        if total == 0:
            return y
        starts = idx.indptr[live]
        first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        pos = torch.repeat_interleave(starts, counts) + torch.arange(total, device=x.device) - first
        step = max(1, BLOCK_BYTES // (B * x.element_size() * 2))
        for i in range(0, total, step):
            p = pos[i:i + step]
            v = x[:, idx.src[p]]
            if measure is not None:
                v = v * idx.measures[measure][p].to(x.dtype)
            y.index_add_(1, idx.dst[p], v)
        return y
