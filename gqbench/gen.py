"""The general pieces of the graph generators: Zipf draws by inverse CDF,
de-duplication of key pairs, and the raw draw count that leaves a target
fanout after de-duplication. Everything runs on the given device from a
``torch.Generator`` seeded by the run's seed.

A configuration's generator (``configs/<config>.py``) calls these and returns
the graph as plain tensors::

    {"entities": {name: {"size": int, "attributes": {attr: int64[size]}}},
     "relationships": {name: {"fk1": str, "fk2": str, "entity1": str,
                              "entity2": str, "columns": {col: int64[rows]}}}}
"""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator of its own for each draw of a graph: ``stream`` keeps
    draws apart, so adding one leaves the others as they were."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    return g


def zipf_probs(n: int, s: float) -> np.ndarray:
    """Zipf probabilities over ranks 1..n (id 0 is the most popular)."""
    p = np.arange(1, n + 1, dtype=np.float64) ** (-s)
    return p / p.sum()


def zipf(n: int, s: float, size: int, g: torch.Generator, device) -> torch.Tensor:
    """``size`` Zipf(s) ids in [0, n) by inverse CDF: one uniform draw each,
    looked up in the cumulative probabilities."""
    cdf = torch.as_tensor(np.cumsum(zipf_probs(n, s)), device=device)
    u = torch.rand(size, generator=g, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u).clamp_(max=n - 1)


def uniform(n: int, size: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, n, (size,), generator=g, device=device)


def dedupe(a: torch.Tensor, b: torch.Tensor, nb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct (a, b) pairs, sorted by (a, b)."""
    key = torch.unique(a * nb + b)
    return key // nb, key % nb


def draws_for_fanout(target: float, partner_probs: np.ndarray, device="cpu") -> float:
    """Raw draws a source needs so that ``target`` distinct partners remain
    after de-duplication: a source's draws of partner i are Poisson(λ·p_i),
    so E[distinct] = Σ 1 − exp(−λ·p_i); λ by bisection, to 1e-9 of itself.
    Depends on the configuration alone, never on the seed."""
    if target >= partner_probs.shape[0]:
        raise ValueError(f"fanout {target} exceeds the {partner_probs.shape[0]} partners")
    p = torch.as_tensor(partner_probs, device=device)

    def distinct(lam: float) -> float:
        return float(-torch.expm1(-lam * p).sum())

    lo, hi = target, target
    while distinct(hi) < target:
        hi *= 2.0
    while hi - lo > 1e-9 * hi:
        mid = 0.5 * (lo + hi)
        if distinct(mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def relation(n_src: int, n_dst: int, fanout: float, dst_zipf: float,
             g: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairs (src, dst) with src uniform and dst Zipf(dst_zipf), drawn so
    that ``fanout`` distinct pairs a source remain on average."""
    lam = draws_for_fanout(fanout, zipf_probs(n_dst, dst_zipf), device)
    raw = int(round(n_src * lam))
    src = uniform(n_src, raw, g, device)
    dst = zipf(n_dst, dst_zipf, raw, g, device)
    return dedupe(src, dst, n_dst)


def user_bytes(graph: dict) -> int:
    """The user data's bytes: every relation and attribute column at 4 B a
    value."""
    n = sum(len(c) for r in graph["relationships"].values() for c in r["columns"].values())
    n += sum(len(a) for e in graph["entities"].values() for a in e["attributes"].values())
    return 4 * n


def to_host(graph: dict) -> dict:
    """The same graph with every column as an int64 numpy array."""
    def host(t):
        return t.to("cpu", torch.int64).numpy()

    return {
        "entities": {
            k: {"size": e["size"], "attributes": {a: host(v) for a, v in e["attributes"].items()}}
            for k, e in graph["entities"].items()
        },
        "relationships": {
            k: {**{f: r[f] for f in ("fk1", "fk2", "entity1", "entity2")},
                "columns": {c: host(v) for c, v in r["columns"].items()}}
            for k, r in graph["relationships"].items()
        },
    }
