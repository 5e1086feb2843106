"""DIN — Deep Interest Network [arXiv:1706.06978], on PyTorch.

The JAX package's ``repro.models.din``, over the same parameter tree.
Target attention over the user behaviour sequence: for candidate item c and
history h_1..h_T, attention MLP scores a(h_t, c) over [h, c, h−c, h⊙c]
(the paper's activation unit, 80-40 MLP), weighted-sum pooled, concatenated
with user/context features into the 200-80 output MLP.

Shapes served: train_batch (65k), serve_p99 (512), serve_bulk (262k),
retrieval_cand (1 user × 10⁶ candidates). Embedding lookups are the hot path
(``index_select``; DESIGN.md §5 — the paper's fragment lookup + γ).

One thing differs from the reference: :func:`din_retrieval_scores` scores
the candidates in chunks of ``RETRIEVAL_CHUNK``. Each candidate's score
depends on that candidate alone, so the scores are the reference's; eager
PyTorch materialises the ``[N, T, 4D]`` features and ``[N, T, 80]`` hidden
layer that XLA fuses, 28.8 GB and 32.0 GB at 10⁶ candidates, which do not fit
beside their temporaries.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .common import randn, shard_hint
from .gnn.common import gather, mlp_apply, mlp_init

#: Candidates scored at once by din_retrieval_scores: at seq 100 and embed 18
#: a chunk's features, attention layers and their temporaries hold about
#: 2,000 B a history position, ~13 GB at 65,536 candidates (the peak that
#: chip_smoke.py's path r1 reads on the card is in PERF.md §6).
RETRIEVAL_CHUNK = 65_536


@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_hidden: tuple[int, ...] = (80, 40)
    mlp_hidden: tuple[int, ...] = (200, 80)
    n_items: int = 10_000_000
    n_users: int = 1_000_000
    n_cates: int = 100_000

    def param_count(self) -> int:
        d = self.embed_dim
        emb = (self.n_items + self.n_users + self.n_cates) * d
        attn = 4 * d * 80 + 80 * 40 + 40 * 1 + 121
        mlp = (4 * d) * 200 + 200 * 80 + 80 * 1 + 281
        return emb + attn + mlp

    def active_param_count(self) -> int:
        """Params touched per example: MLPs + the (T+2) embedding rows gathered
        (embedding tables are lookup-sparse — DESIGN.md roofline convention)."""
        d = self.embed_dim
        attn = 4 * d * 80 + 80 * 40 + 40 * 1 + 121
        mlp = (4 * d) * 200 + 200 * 80 + 80 * 1 + 281
        return attn * self.seq_len + mlp + (self.seq_len + 2) * d


def din_init(cfg: DINConfig, gen: torch.Generator) -> dict:
    """The reference's tree, drawn from ``gen`` on its device."""
    d = cfg.embed_dim

    def table(rows: int) -> torch.Tensor:
        return randn(gen, (rows, d)) * 0.01

    return {
        "item_emb": table(cfg.n_items),
        "cate_emb": table(cfg.n_cates),
        "user_emb": table(cfg.n_users),
        "attn": mlp_init(gen, [4 * d, *cfg.attn_hidden, 1]),
        "mlp": mlp_init(gen, [4 * d, *cfg.mlp_hidden, 1]),
    }


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape (the reference's ``jnp.take``)."""
    return gather(table, ids.reshape(-1)).reshape(ids.shape + table.shape[1:])


def _target_attention(p, hist: torch.Tensor, hist_mask: torch.Tensor,
                      cand: torch.Tensor) -> torch.Tensor:
    """hist [B,T,D], cand [B,D] → pooled interest [B,D] (DIN activation unit)."""
    B, T, D = hist.shape
    c = cand[:, None, :].expand(B, T, D)
    feats = torch.cat([hist, c, hist - c, hist * c], dim=-1)
    logits = mlp_apply(p["attn"], feats, act=torch.sigmoid)[..., 0]  # [B,T]
    w = torch.where(hist_mask > 0, logits, 0.0)  # paper: no softmax, masked weights
    return torch.einsum("bt,btd->bd", w, hist)


def _head(p, user, interest, cand) -> torch.Tensor:
    x = torch.cat([user, interest, cand, interest * cand], dim=-1)
    return mlp_apply(p["mlp"], x, act=F.relu)[..., 0]


def din_forward(p: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """batch: user [B], hist_items [B,T], hist_mask [B,T], cand_item [B] → logits [B]."""
    hist = _lookup(p["item_emb"], batch["hist_items"])  # [B,T,D]
    hist = shard_hint(hist, ("pod", "data"), None, None)
    cand = _lookup(p["item_emb"], batch["cand_item"])  # [B,D]
    user = _lookup(p["user_emb"], batch["user"])
    interest = _target_attention(p, hist, batch["hist_mask"], cand)
    return _head(p, user, interest, cand)


def din_retrieval_scores(p: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """One user/history against n_candidates items: the pooled interest must be
    re-computed per candidate (DIN's point), batched → [N] scores. A rank
    that holds more than RETRIEVAL_CHUNK candidates scores them a chunk at a
    time (over a production mesh each rank's share fits in one pass, and a
    DTensor's sharded dim is not sliced without gathering it)."""
    # the history and the user are every rank's: the candidates' layout then
    # decides the features' (torch 2.11 cannot flatten the [n, T] dims of
    # features whose T dim a strategy sharded)
    hist = shard_hint(_lookup(p["item_emb"], batch["hist_items"]), None, None, None)  # [1,T,D]
    user = shard_hint(_lookup(p["user_emb"], batch["user"]), None, None)  # [1,D]
    cand_items = batch["cand_items"]
    T, D = hist.shape[1], hist.shape[2]
    n_local = (cand_items.to_local() if hasattr(cand_items, "to_local") else cand_items).shape[0]
    parts = (cand_items,) if n_local <= RETRIEVAL_CHUNK else cand_items.split(RETRIEVAL_CHUNK)
    out = []
    for ids in parts:
        cands = _lookup(p["item_emb"], ids)  # [n,D]
        n = cands.shape[0]
        interest = _target_attention(p, hist.expand(n, T, D),
                                     batch["hist_mask"].expand(n, T), cands)
        out.append(_head(p, user.expand(n, D), interest, cands))
    return torch.cat(out) if len(out) > 1 else out[0]


def din_loss(p: dict, batch: dict, cfg: DINConfig):
    logits = din_forward(p, batch, cfg)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(
        torch.clamp_min(logits, 0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    )
    return loss, {"loss": loss}
