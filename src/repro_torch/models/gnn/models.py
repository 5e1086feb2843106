"""The four GNN architectures, one functional (init, apply) pair each, on
PyTorch.

  schnet        [arXiv:1706.08566]  cfconv: RBF-filter ⊙ gather → segment sum
  egnn          [arXiv:2102.09844]  E(n): scalar-distance MLP msgs + coord update
  mace          [arXiv:2206.07697]  E(3)-ACE: SH ⊗ radial A-basis, correlation-3
                                    symmetric CG contractions (real basis)
  equiformer_v2 [arXiv:2306.12059]  eSCN: per-edge Wigner rotation to edge frame,
                                    SO(2) m-restricted linear conv, graph attention

The JAX package's ``repro.models.gnn.models``, over the same parameter trees
leaf for leaf, so weights and checkpoints carry across. What differs is the
form, not the function:

  * the reference's functional updates (``.at[...].set/add``) become blocks
    built in lists and joined by ``torch.cat``: no tensor that autograd saved
    is written in place, which the checkpointed backward needs;
  * ``_ckpt`` is ``torch.utils.checkpoint`` (non-reentrant) behind the same
    ``REMAT`` flag: each block's per-edge intermediates are recomputed in
    the backward pass;
  * a three-operand einsum is two products whose intermediate is the small
    one (MACE's ``Y ⊗ CG`` before the channels; the outer product of two
    irreps before its coupling), and EquiformerV2's SO(2) convolution sums
    over the input degrees inside one matrix product a coefficient (its
    terms do not depend on the output degree), keeping only the output
    columns with |m| ≤ m_max, which are the nonzero ones.

All share the GraphBatch contract; ``apply`` returns node embeddings
[N, d_hidden]; the head maps them to node logits (classification shapes) or
per-graph energy (molecule shape). See DESIGN.md §5 for the documented
simplifications. This path reaches no hand-written kernel: the reference's
segment sums reach no Pallas kernel, and here they are ``index_add``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import randn
from .common import (
    aggregate,
    bessel_rbf,
    cosine_cutoff,
    edge_hint,
    edge_vectors,
    gather,
    gaussian_rbf,
    mlp_apply,
    mlp_init,
    node_hint,
    readout,
    segment_max,
)
from .equivariant import (
    cg_tensor,
    irreps_dim,
    l_slices,
    real_sph_harm,
    rotation_to_edge_frame,
    wigner_d_real,
)

N_SPECIES = 100


REMAT = True  # the reference's flag: per-block recompute in the backward pass


def _ckpt(fn):
    """Per-block remat: per-edge intermediates are recomputed in backward —
    without it the 12-layer equiformer saves every [E, C, irreps] tensor."""
    if not REMAT:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # schnet | egnn | mace | equiformer_v2
    n_layers: int
    d_hidden: int
    n_rbf: int = 16
    cutoff: float = 10.0
    l_max: int = 0
    m_max: int = 0
    n_heads: int = 1
    correlation: int = 1
    d_feat: int = 0  # input node-feature width (0 → atom-type embedding only)
    n_classes: int = 0  # 0 → energy head


def _normal(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    return randn(gen, shape) * scale


def _embed(p: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    x = gather(p["embed"], batch["z"])
    if cfg.d_feat and "node_feat" in batch:
        x = x + mlp_apply(p["feat_proj"], batch["node_feat"])
    return x


# ---------------------------------------------------------------------------
# SchNet
# ---------------------------------------------------------------------------


def schnet_init(cfg: GNNConfig, gen: torch.Generator) -> dict:
    d = cfg.d_hidden
    p = {"embed": _normal(gen, (N_SPECIES, d), 0.1), "blocks": []}
    if cfg.d_feat:
        p["feat_proj"] = mlp_init(gen, [cfg.d_feat, d])
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            "filter": mlp_init(gen, [cfg.n_rbf, d, d]),
            "in": mlp_init(gen, [d, d]),
            "out": mlp_init(gen, [d, d, d]),
        })
    return p


def _ssp(x):  # shifted softplus (SchNet activation)
    return F.softplus(x) - math.log(2.0)


def schnet_apply(p: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    n = batch["z"].shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    x = _embed(p, batch, cfg)
    _, r = edge_vectors(batch["pos"], src, dst)
    rbf = gaussian_rbf(r, cfg.n_rbf, cfg.cutoff) * batch["edge_mask"][:, None]
    for blk in p["blocks"]:
        def block(x, blk=blk):
            W = mlp_apply(blk["filter"], rbf, act=_ssp, final_act=True)
            h = mlp_apply(blk["in"], x)
            msg = edge_hint(gather(h, src)) * W
            agg = aggregate(msg, dst, n)
            return node_hint(x + mlp_apply(blk["out"], agg, act=_ssp))
        x = _ckpt(block)(x)
    return x


# ---------------------------------------------------------------------------
# EGNN
# ---------------------------------------------------------------------------


def egnn_init(cfg: GNNConfig, gen: torch.Generator) -> dict:
    d = cfg.d_hidden
    p = {"embed": _normal(gen, (N_SPECIES, d), 0.1), "blocks": []}
    if cfg.d_feat:
        p["feat_proj"] = mlp_init(gen, [cfg.d_feat, d])
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            "phi_e": mlp_init(gen, [2 * d + 1, d, d]),
            "phi_x": mlp_init(gen, [d, d, 1]),
            "phi_h": mlp_init(gen, [2 * d, d, d]),
        })
    return p


def egnn_apply(p: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    n = batch["z"].shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    h = _embed(p, batch, cfg)
    x = batch["pos"]
    em = batch["edge_mask"][:, None]
    for blk in p["blocks"]:
        def block(x, h, blk=blk):
            vec = edge_hint(gather(x, src) - gather(x, dst))
            d2 = torch.sum(vec**2, dim=-1, keepdim=True)
            hi = edge_hint(gather(h, dst))
            hj = edge_hint(gather(h, src))
            m = mlp_apply(blk["phi_e"], torch.cat([hi, hj, d2], -1), final_act=True) * em
            # coordinate update (normalized difference, EGNN eq. 4)
            coef = mlp_apply(blk["phi_x"], m) * em
            xup = aggregate(vec / (torch.sqrt(d2) + 1.0) * coef, dst, n)
            magg = aggregate(m, dst, n)
            return x + xup, node_hint(h + mlp_apply(blk["phi_h"], torch.cat([h, magg], -1)))
        x, h = _ckpt(block)(x, h)
    return h


# ---------------------------------------------------------------------------
# MACE (E(3)-ACE, correlation order 3, channel-wise real-CG contractions)
# ---------------------------------------------------------------------------


def _mace_paths(l_max: int) -> list[tuple[int, int, int]]:
    return [
        (l1, l2, l3)
        for l1 in range(l_max + 1)
        for l2 in range(l_max + 1)
        for l3 in range(l_max + 1)
        if abs(l1 - l2) <= l3 <= l1 + l2
    ]


def mace_init(cfg: GNNConfig, gen: torch.Generator) -> dict:
    C = cfg.d_hidden
    P = len(_mace_paths(cfg.l_max))
    p: dict = {"embed": _normal(gen, (N_SPECIES, C), 0.1), "blocks": []}
    if cfg.d_feat:
        p["feat_proj"] = mlp_init(gen, [cfg.d_feat, C])
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            # radial MLP: one weight per (channel, l1, l2) A-path
            "radial": mlp_init(gen, [cfg.n_rbf, 64, C * P]),
            "w_A": _normal(gen, (P, C), 1 / math.sqrt(P)),
            "w_B2": _normal(gen, (P, C), 1 / math.sqrt(P)),
            "w_B3": _normal(gen, (P, C), 1 / math.sqrt(P)),
            "lin": _normal(gen, (C, C), 1 / math.sqrt(C)),
        })
    return p


def _times(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m`` for x [N, C, k]. Where x's channels are sharded (a DTensor
    that ``node_hint`` laid out over 'model') the channels lead the product:
    folding [N, C] with C sharded gives a strided shard, whose offsets
    DTensor materializes row by row. Elsewhere the plain product, which
    copies nothing: the transposed one costs path r's MACE step 6% on the
    H100 (PERF.md §6)."""
    if any(getattr(pl, "dim", None) == 1 for pl in getattr(x, "placements", ())):
        return (x.transpose(0, 1) @ m).transpose(0, 1)
    return x @ m


def _stack(parts: list) -> torch.Tensor:
    """Parts [E, C] side by side as [E, C·P], channel-major (the rows
    :func:`_rows` lays out), so Σ_p parts[p] @ w[p] is one product. The
    channels lead each row: over a mesh, folding [E, P, C] with C sharded
    over 'model' makes a strided shard, whose reshard plans DTensor searches
    for without end on the 3-D mesh."""
    return torch.stack(parts, 2).reshape(parts[0].shape[0], -1)


def _rows(w: torch.Tensor) -> torch.Tensor:
    """w [P, C, C'] as the [C·P, C'] rows that match :func:`_stack`'s."""
    return w.transpose(0, 1).reshape(-1, w.shape[-1])


def _couple_all(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                paths: list[tuple[int, int, int]], sl: list[slice]) -> torch.Tensor:
    """Σ over ``paths`` of (x_{l1} ⊗ y_{l2})_{l3} · w[path] (per channel), the
    l3 blocks joined along the last axis: the reference's ``_couple`` summed
    into ``.at[..., sl[l3]]``. The outer product of a (l1, l2) pair is made
    once for every l3 it couples to."""
    by_l3: dict[int, torch.Tensor] = {}
    outer, pair = None, None
    for pi, (l1, l2, l3) in enumerate(paths):
        if pair != (l1, l2):
            xa, yb = x[..., sl[l1]], y[..., sl[l2]]
            outer = (xa[..., :, None] * yb[..., None, :]).flatten(-2)
            pair = (l1, l2)
        term = _times(outer, cg_tensor(l1, l2, l3, x.dtype, x.device)) * w[pi][None, :, None]
        by_l3[l3] = term if l3 not in by_l3 else by_l3[l3] + term
    return torch.cat([by_l3[l] for l in range(len(sl))], -1)


def mace_apply(p: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    n = batch["z"].shape[0]
    C, lm = cfg.d_hidden, cfg.l_max
    dim = irreps_dim(lm)
    sl = l_slices(lm)
    src, dst = batch["edge_src"], batch["edge_dst"]
    vec, r = edge_vectors(batch["pos"], src, dst)
    Y = edge_hint(real_sph_harm(lm, vec))  # [E, dim]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    env = (cosine_cutoff(r, cfg.cutoff) * batch["edge_mask"])[:, None]
    paths = _mace_paths(lm)
    # Y_{l1} contracted with the coupling first: [E, 2l2+1, 2l3+1] a path
    YC = [torch.einsum("em,mpq->epq", Y[:, sl[l1]],
                       cg_tensor(l1, l2, l3, Y.dtype, Y.device).reshape(
                           2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
          for l1, l2, l3 in paths]

    h0 = _embed(p, batch, cfg)
    # node irreps: scalar channel initialized from embedding
    h = node_hint(torch.cat([h0[..., None], h0.new_zeros((n, C, dim - 1))], -1))

    for blk in p["blocks"]:
        def block(h, blk=blk):
            Rw = mlp_apply(blk["radial"], rbf).reshape(-1, C, len(paths)) * env[..., None]
            Rw = edge_hint(Rw)
            hj = edge_hint(gather(h, src))  # [E, C, dim]
            # A-basis: Σ_j R ⊙ (Y_{l1} ⊗ h_{l2})_{l3}
            by_l3: dict[int, torch.Tensor] = {}
            for pi, (l1, l2, l3) in enumerate(paths):
                msg = torch.matmul(hj[..., sl[l2]], YC[pi]) * Rw[:, :, pi: pi + 1]
                part = aggregate(msg, dst, n)
                by_l3[l3] = part if l3 not in by_l3 else by_l3[l3] + part
            A = torch.cat([by_l3[l] for l in range(lm + 1)], -1)
            # B-basis: symmetric contractions, correlation order 1..3
            B = A * blk["w_A"][0][None, :, None]  # ν = 1 (per-channel scale)
            AA = _couple_all(A, A, blk["w_B2"], paths, sl)  # ν = 2
            B = B + AA
            B = B + _couple_all(AA, A, blk["w_B3"], paths, sl)  # ν = 3: (A⊗A)_{l1} ⊗ A_{l2}
            # channel-mixing update + residual
            # the update takes the nodes' layout before the residual sum (over
            # a mesh the channel contraction leaves a partial sum)
            return node_hint(h + node_hint(torch.einsum("ncq,cd->ndq", B, blk["lin"])
                                           / len(paths)))
        h = _ckpt(block)(h)
    return h[:, :, 0]  # scalar (invariant) channels


# ---------------------------------------------------------------------------
# EquiformerV2 (eSCN SO(2) convolution + graph attention)
# ---------------------------------------------------------------------------


def equiformer_init(cfg: GNNConfig, gen: torch.Generator) -> dict:
    C, lm, mm = cfg.d_hidden, cfg.l_max, cfg.m_max
    n_l = lm + 1
    p: dict = {"embed": _normal(gen, (N_SPECIES, C), 0.1), "blocks": []}
    if cfg.d_feat:
        p["feat_proj"] = mlp_init(gen, [cfg.d_feat, C])
    for _ in range(cfg.n_layers):
        p["blocks"].append({
            # SO(2) conv: m=0 real matrix over (l, channel); m>0 complex pair
            "w_m0": _normal(gen, (n_l, C, C), 1 / math.sqrt(C * n_l)),
            "w_re": _normal(gen, (mm, n_l, C, C), 1 / math.sqrt(C * n_l)),
            "w_im": _normal(gen, (mm, n_l, C, C), 1 / math.sqrt(C * n_l)),
            "radial": mlp_init(gen, [cfg.n_rbf, 64, C]),
            "attn": mlp_init(gen, [2 * C, C, cfg.n_heads]),
            "ffn": mlp_init(gen, [C, 2 * C, C]),
        })
    return p


def equiformer_apply(p: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    n = batch["z"].shape[0]
    C, lm, mm, H = cfg.d_hidden, cfg.l_max, cfg.m_max, cfg.n_heads
    sl = l_slices(lm)
    src, dst = batch["edge_src"], batch["edge_dst"]
    vec, r = edge_vectors(batch["pos"], src, dst)
    rot = edge_hint(rotation_to_edge_frame(vec))  # [E,3,3]
    D = [edge_hint(d) for d in wigner_d_real(lm, rot)]  # per-l [E, 2l+1, 2l+1]
    Dt = [d.transpose(-1, -2) for d in D]
    rbf = edge_hint(gaussian_rbf(r, cfg.n_rbf, cfg.cutoff))
    env = (cosine_cutoff(r, cfg.cutoff) * batch["edge_mask"])[:, None]
    ml = [min(l, mm) for l in range(lm + 1)]  # the |m| each degree keeps

    h0 = _embed(p, batch, cfg)
    h = node_hint(torch.cat([h0[..., None], h0.new_zeros((n, C, irreps_dim(lm) - 1))], -1))

    for blk in p["blocks"]:
        def block(h, blk=blk):
            hj = edge_hint(gather(h, src))  # [E, C, dim]
            E = hj.shape[0]
            # rotate into edge frame, keep only |m| <= m_max coefficients (eSCN):
            # x[l][..., ml[l] + m] is the rotated coefficient m of degree l
            x = [torch.matmul(hj[..., sl[l]], Dt[l][..., l - ml[l]: l + ml[l] + 1])
                 for l in range(lm + 1)]
            # SO(2) linear conv: mixes channels and l at fixed m; the sums over
            # the input degree lp run inside each product
            S0 = _stack([x[lp][..., ml[lp]] for lp in range(lm + 1)]) @ _rows(blk["w_m0"])
            Sc, Ss = {}, {}
            for m in range(1, mm + 1):  # m > 0: complex-structured 2×2 mixing
                xc = _stack([x[lp][..., ml[lp] + m] for lp in range(m, lm + 1)])  # cos part
                xs = _stack([x[lp][..., ml[lp] - m] for lp in range(m, lm + 1)])  # sin part
                wre = _rows(blk["w_re"][m - 1, m:])
                wim = _rows(blk["w_im"][m - 1, m:])
                Sc[m] = xc @ wre - xs @ wim
                Ss[m] = xs @ wre + xc @ wim
            rad = mlp_apply(blk["radial"], rbf) * env  # [E, C] radial gate
            # stacked at dim -1 written non-negative (torch 2.11 mislays a
            # DTensor stacked at a negative dim)
            out_l = [torch.stack([Ss[m] for m in range(ml[l], 0, -1)] + [S0]
                                 + [Sc[m] for m in range(1, ml[l] + 1)], S0.dim()) * rad[..., None]
                     for l in range(lm + 1)]  # the |m| <= ml[l] columns of degree l
            # attention weights from invariant (l=0) features
            inv_i = gather(h[:, :, 0], dst)
            inv_msg = out_l[0][..., 0]
            logits = mlp_apply(blk["attn"], torch.cat([inv_i, inv_msg], -1))  # [E, H]
            logits = logits - gather(segment_max(logits, dst, n), dst)
            expw = torch.exp(logits) * batch["edge_mask"][:, None]
            denom = gather(aggregate(expw, dst, n), dst) + 1e-9
            alpha = expw / denom  # [E, H] segment softmax
            alpha_c = torch.repeat_interleave(alpha, C // H, dim=1)  # [E, C]
            # rotate back and aggregate
            msg = torch.cat([torch.matmul(out_l[l], Dt[l][..., l - ml[l]: l + ml[l] + 1, :])
                             for l in range(lm + 1)], -1)
            msg = msg * alpha_c[..., None]
            agg = aggregate(msg.reshape(E, -1), dst, n).reshape(h.shape)
            h = h + agg
            # gated FFN on invariant channel, scaling all irreps (equivariant gate)
            gate = mlp_apply(blk["ffn"], h[:, :, 0])
            h = h * torch.sigmoid(gate)[..., None]
            return node_hint(torch.cat([h[:, :, :1] + gate[..., None], h[:, :, 1:]], -1))
        h = _ckpt(block)(h)
    return h[:, :, 0]


# ---------------------------------------------------------------------------
# Dispatch table + heads
# ---------------------------------------------------------------------------

GNN_MODELS = {
    "schnet": (schnet_init, schnet_apply),
    "egnn": (egnn_init, egnn_apply),
    "mace": (mace_init, mace_apply),
    "equiformer_v2": (equiformer_init, equiformer_apply),
}


def gnn_init(cfg: GNNConfig, gen: torch.Generator) -> dict:
    """The reference's tree (``backbone`` and ``head``), drawn from ``gen`` on
    its device."""
    init, _ = GNN_MODELS[cfg.arch]
    p = {"backbone": init(cfg, gen)}
    out = cfg.n_classes if cfg.n_classes else 1
    p["head"] = mlp_init(gen, [cfg.d_hidden, cfg.d_hidden, out])
    return p


def gnn_apply(p: dict, batch: dict, cfg: GNNConfig, n_graphs: int = 1) -> torch.Tensor:
    _, apply = GNN_MODELS[cfg.arch]
    x = apply(p["backbone"], batch, cfg)
    out = mlp_apply(p["head"], x)
    if cfg.n_classes:
        return out  # [N, n_classes] node logits
    return readout(out, batch, n_graphs)[:, 0]  # [n_graphs] energies


def gnn_loss(p: dict, batch: dict, cfg: GNNConfig, n_graphs: int = 1):
    out = gnn_apply(p, batch, cfg, n_graphs)
    if cfg.n_classes:
        logp = torch.log_softmax(out, dim=-1)
        nll = -torch.gather(logp, 1, batch["labels"][:, None].long())[:, 0]
        loss = (nll * batch["node_mask"]).sum() / torch.clamp_min(batch["node_mask"].sum(), 1)
    else:
        loss = torch.mean((out - batch["labels"]) ** 2)
    return loss, {"loss": loss}
