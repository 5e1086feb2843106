"""Decoder-only LM family: dense (CodeQwen/Qwen2.5/Llama-3) and MoE
(Arctic-style dense+MoE parallel residual, OLMoE top-k) in one config space,
on PyTorch.

The JAX package's model (``repro.models.transformer``), function for
function, over the same parameter tree:

  * stacked ``[L, ...]`` layer weights, so weights and checkpoints carry
    across key for key; the layers run in a Python loop (the reference's
    ``lax.scan``), each under ``torch.utils.checkpoint`` where ``cfg.remat``
    is set;
  * chunked online-softmax attention (float32 running max, sum and
    accumulator) over KV chunks, GQA without repeating the KV heads;
  * scatter-based MoE dispatch: slot positions from a cumsum over the
    token→expert one-hot, dropped tokens written to an overflow slot that is
    cut off;
  * parameters in ``cfg.param_dtype`` (float32), cast to
    ``cfg.compute_dtype`` (bfloat16) at every use, as the reference does.

Every major activation carries the reference's ``shard_hint`` (an identity
on one device; over a production mesh, under ``use_mesh``, a DTensor
redistribution), and ``seq_shard`` shards the residual stream's sequence dim
over 'model' between layers (Megatron-style sequence parallelism). The
attention's running max, sum and accumulator are made ``like`` q, so over a
mesh they take q's layout and never a whole batch's on every rank.

The backward pass is autograd's. The einsums are plain products: this path
reaches no hand-written kernel (the reference's reaches no Pallas kernel).
Serving updates the KV cache in place: ``prefill`` and ``decode_step`` return
the cache they wrote.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (
    apply_rope,
    cross_entropy_loss,
    current_mesh,
    dense_init,
    pin,
    rms_norm,
    shard_hint,
    sharded_zeros,
    split_hint,
)

BATCH = ("pod", "data")  # logical batch sharding axes


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 2048
    tie_embeddings: bool = False
    seq_shard: bool = False  # residual stream's sequence dim over 'model' between layers

    def pad_heads(self, tp: int) -> "TransformerConfig":
        """Pad q-head count up to a multiple of tp (padded heads have
        zero-init output rows in the reference's production layout)."""
        h = -(-self.n_heads // tp) * tp
        return dataclasses.replace(self, n_heads=h) if h != self.n_heads else self

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads if self.n_heads % self.n_kv_heads == 0 else 0

    def _count(self, experts: int) -> int:
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = 3 * d * f if self.moe is None or self.moe.dense_residual else 0
        if self.moe is not None:
            ffn += experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d

    def param_count(self) -> int:
        return self._count(self.moe.n_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k experts only)."""
        return self._count(self.moe.top_k if self.moe else 0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, gen: torch.Generator) -> dict:
    """The reference's tree, drawn from ``gen`` on ``gen``'s device (each
    weight from the generator in turn, not from the reference's key split:
    the values differ, the shapes, dtypes and scales do not)."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.d_head
    H, Hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    pt, dev = cfg.param_dtype, gen.device

    def di(shape, in_axis=-2):
        return dense_init(gen, shape, in_axis, pt)

    def ones(*shape):
        return torch.ones(shape, dtype=pt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pt, device=dev)

    layer = {
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "wq": di((L, d, H, hd), -3),
        "wk": di((L, d, Hkv, hd), -3),
        "wv": di((L, d, Hkv, hd), -3),
        "wo": di((L, H, hd, d), -2),
    }
    if cfg.qkv_bias:
        layer["bq"] = zeros(L, H, hd)
        layer["bk"] = zeros(L, Hkv, hd)
        layer["bv"] = zeros(L, Hkv, hd)
    if cfg.moe is None or cfg.moe.dense_residual:
        layer["w_gate"] = di((L, d, f))
        layer["w_up"] = di((L, d, f))
        layer["w_down"] = di((L, f, d))
    if cfg.moe is not None:
        m = cfg.moe
        layer["router"] = di((L, d, m.n_experts))
        layer["e_gate"] = di((L, m.n_experts, d, m.d_ff_expert))
        layer["e_up"] = di((L, m.n_experts, d, m.d_ff_expert))
        layer["e_down"] = di((L, m.n_experts, m.d_ff_expert, d))
    params = {
        "embed": di((cfg.vocab, d), -1),
        "layers": layer,
        "ln_f": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = di((d, cfg.vocab))
    return params


def _layer_params(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _head(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _gqa_scores(qf: torch.Tensor, kt: torch.Tensor, scale: float) -> torch.Tensor:
    """qf [B,Hkv,Sq·G,hd] × kt [B,Hkv,C,hd] → [B,Hkv,Sq·G,C] without
    repeating K."""
    return (qf @ kt.transpose(2, 3)) / scale


def chunked_attention(
    q: torch.Tensor,  # [B,Sq,H,hd]
    k: torch.Tensor,  # [B,Sk,Hkv,hd]
    v: torch.Tensor,
    causal: bool,
    q_offset: int = 0,  # absolute position of q[0] (decode/prefill)
    kv_valid: int | None = None,  # number of valid kv positions
    kv_chunk: int = 2048,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks: memory O(Sq · kv_chunk)
    instead of O(Sq · Sk). The state is [B,Hkv,Sq,G(,hd)]: the products
    fold (Sq, G) with the positions outermost, so a q sharded over its
    positions (a mesh's 'model' axis when the KV heads do not divide it)
    folds without a reshard. q is laid out so once, K and V as [B,Hkv,Sk,hd]
    once (a batch-sharded K stays local): a chunk's products then read
    views, with no copy a chunk."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kv_chunk = min(kv_chunk, Sk)
    n_chunks = -(-Sk // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kt = k.transpose(1, 2).contiguous()  # [B,Hkv,Sk,hd]
    vt = v.transpose(1, 2).contiguous()
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    # the reference divides by sqrt(hd) rounded to q's dtype
    scale = float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype))

    # the running state takes q's layout
    q_t = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 1, 3, 4)  # [B,Hkv,Sq,G,hd]
    qf = q_t.reshape(B, Hkv, Sq * G, hd)
    like = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    m = torch.full_like(q_t[..., 0], -math.inf, **like)
    l_ = torch.zeros_like(q_t[..., 0], **like)
    acc = torch.zeros_like(q_t, **like)
    for ci in range(n_chunks):
        kch = kt[:, :, ci * kv_chunk:(ci + 1) * kv_chunk]
        vch = vt[:, :, ci * kv_chunk:(ci + 1) * kv_chunk]
        s = _gqa_scores(qf, kch, scale).float().reshape(B, Hkv, Sq, G, -1)  # [B,Hkv,Sq,G,C]
        kv_pos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (kv_pos < Sk)[None, :]  # chunk padding
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        if kv_valid is not None:
            mask = mask & (kv_pos < kv_valid)[None, :]
        s = s.masked_fill(~mask[:, None, :], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_ = l_ * alpha + p.sum(-1)
        pv = p.to(q.dtype).reshape(B, Hkv, Sq * G, -1) @ vch
        acc = acc * alpha[..., None] + pv.float().reshape(B, Hkv, Sq, G, hd)
        m = m_new
    out = acc / torch.clamp_min(l_, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_route(lp: dict, x: torch.Tensor, cfg: TransformerConfig) -> dict:
    """The router's choices for x [T, d]: float32 softmax, top-k
    renormalised, the Switch auxiliary loss, and each (token, k) entry's
    capacity slot (``C`` for a dropped entry)."""
    m = cfg.moe
    T, _ = x.shape
    E, K = m.n_experts, m.top_k
    logits = x.float() @ lp["router"].float()  # [T,E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)  # [T,K]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    flat_e = topi.reshape(-1)  # [T*K]
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # [T*K,E]
    # Switch-style load-balance auxiliary loss
    ce = onehot.sum(0).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(probs.mean(0) * ce)

    C = max(8, int(-(-T * K * m.capacity_factor // E)))  # capacity per expert
    pos = torch.cumsum(onehot, dim=0) - onehot  # positions before this entry
    pos_flat = torch.gather(pos, 1, flat_e[:, None])[:, 0]  # [T*K]
    keep = pos_flat < C
    slot = torch.where(keep, pos_flat, C)  # dropped entries → overflow slot C
    return {"topw": topw, "topi": topi, "keep": keep, "slot": slot, "C": C, "aux": aux}


def moe_ffn(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
            routing: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] flattened tokens → (y [T, d], aux_loss scalar). A
    ``routing`` list gets ``{"x", "topi", "keep"}`` of this call appended."""
    m = cfg.moe
    T, d = x.shape
    E, K = m.n_experts, m.top_k
    r = moe_route(lp, x, cfg)
    if routing is not None:
        routing.append({"x": x.detach(), "topi": r["topi"], "keep": r["keep"]})
    C, flat_e, slot = r["C"], r["topi"].reshape(-1), r["slot"]

    xk = shard_hint(torch.repeat_interleave(x, K, dim=0), BATCH, None)  # per-(t,k) tokens
    # many dropped entries land on slot C: which one wins does not matter,
    # the slot is cut off below
    # the indices over 'data' alone: torch 2.11's index strategy takes no
    # index sharded over two mesh dims (('pod', 'data') on the multi-pod mesh)
    pick = (shard_hint(flat_e, "data"), shard_hint(slot, "data"))
    buf = shard_hint(x.new_zeros((E, C + 1, d)), "model", None, None)
    buf = shard_hint(buf.index_put(pick, xk)[:, :C], "model", None, None)  # [E,C,d]

    # compute follows the weight sharding: E on 'model', ffn width on 'data' —
    # gate/up are local; down contracts the sharded width
    g = torch.einsum("ecd,edf->ecf", buf, lp["e_gate"].to(x.dtype))
    u = torch.einsum("ecd,edf->ecf", buf, lp["e_up"].to(x.dtype))
    h = shard_hint(F.silu(g) * u, "model", None, "data")
    y_e = torch.einsum("ecf,efd->ecd", h, lp["e_down"].to(x.dtype))
    y_e = shard_hint(y_e, "model", None, None)
    y_e = torch.cat([y_e, y_e.new_zeros((E, 1, d))], 1)

    gathered = shard_hint(y_e[pick], BATCH, None)  # [T*K, d]; the overflow slot reads 0
    wts = (r["topw"].reshape(-1) * r["keep"]).to(x.dtype)
    y = (gathered * wts[:, None]).reshape(T, K, d).sum(1)
    return y, r["aux"]


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor, spec: tuple) -> torch.Tensor:
    """x [B,S,d] · w [d,H,hd] → [B,S,H,hd] (the reference's bsd,dhk->bshk),
    laid out as ``spec``."""
    return split_hint(x @ pin(w.reshape(w.shape[0], -1)), tuple(w.shape[1:]), *spec)


def _attn(lp, x, cfg: TransformerConfig, positions, kv_cache=None, kv_valid=None):
    """Attention block. ``kv_cache`` = (ck, cv, pos0): this layer's cache
    [B,Smax,Hkv,hd] ×2, written in place at pos0."""
    B, S, d = x.shape
    cd = cfg.compute_dtype
    # q's positions over 'model' (the reference hints its heads): each
    # product folds (batch, KV heads) into one dim, and folding two sharded
    # dims makes a strided shard whose reshard plans DTensor searches for,
    # which does not end on the 3-D mesh; positions fold with G unsharded
    q_spec = (BATCH, "model", None, None)
    kv_spec = (BATCH, None, None, None)
    # the sequence-parallel stream is gathered at the block's entry (the
    # norm ran on its shard)
    xn = shard_hint(rms_norm(x, lp["ln1"], cfg.norm_eps).to(cd), BATCH, None, None)
    q = _proj(xn, lp["wq"].to(cd), q_spec)
    k = _proj(xn, lp["wk"].to(cd), kv_spec)
    v = _proj(xn, lp["wv"].to(cd), kv_spec)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        k = k + lp["bk"].to(cd)
        v = v + lp["bv"].to(cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_hint(q, *q_spec)
    k = shard_hint(k, *kv_spec)
    v = shard_hint(v, *kv_spec)  # a head-sharded bias would shard it

    if kv_cache is not None:
        ck, cv, pos0 = kv_cache
        ck[:, pos0:pos0 + S] = k
        cv[:, pos0:pos0 + S] = v
        attn_out = _cached_attention(q, ck, cv, q_offset=pos0, kv_valid=kv_valid,
                                     kv_chunk=cfg.attn_kv_chunk)
        new_cache = (ck, cv)
    else:
        attn_out = chunked_attention(q, k, v, causal=True, kv_chunk=cfg.attn_kv_chunk)
        new_cache = (k, v)
    # positions gathered before the output product
    attn_out = shard_hint(attn_out, BATCH, None, None, None)
    wo = lp["wo"].to(cd)
    out = attn_out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    return shard_hint(out, BATCH, None, None), new_cache


def _cached_attention(q, ck, cv, **kw) -> torch.Tensor:
    """Attention of q against a layer's KV cache. Over a mesh whose cache
    is sharded over its KV heads (and batch), each rank attends its own
    heads: ``chunked_attention`` runs in ``local_map`` on q laid out as the
    cache (its heads are the cache's KV groups). DTensor would fold the two
    sharded dims (batch, heads) of each product into one, a strided shard
    whose reshard plans it searches for without end on the 3-D mesh."""
    if current_mesh() is None:
        return chunked_attention(q, ck, cv, causal=True, **kw)
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(ck, DTensor) \
            or not any(isinstance(p, Shard) and p.dim == 2 for p in ck.placements):
        return chunked_attention(q, ck, cv, causal=True, **kw)
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(ck.placements)
    mesh = ck.device_mesh
    local = local_map(functools.partial(chunked_attention, causal=True, **kw),
                      out_placements=(pl,), in_placements=(pl, pl, pl), device_mesh=mesh)
    return local(q.redistribute(mesh, pl), ck, cv.redistribute(mesh, pl))


def _ffn(lp, x, cfg: TransformerConfig, routing: list | None = None):
    cd = cfg.compute_dtype
    xn = shard_hint(rms_norm(x, lp["ln2"], cfg.norm_eps).to(cd), BATCH, None, None)
    B, S, d = xn.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = torch.zeros_like(xn)
    if cfg.moe is None or cfg.moe.dense_residual:
        g = xn @ lp["w_gate"].to(cd)
        u = xn @ lp["w_up"].to(cd)
        h = shard_hint(F.silu(g) * u, BATCH, None, "model")
        y = y + h @ lp["w_down"].to(cd)
    if cfg.moe is not None:
        ym, aux = moe_ffn(lp, xn.reshape(B * S, d), cfg, routing)
        y = y + ym.reshape(B, S, d)
    return shard_hint(y, BATCH, None, None), aux


def _layer(cfg: TransformerConfig, x, lp, positions, kv_cache=None, kv_valid=None,
           routing: list | None = None):
    a, cache = _attn(lp, x, cfg, positions, kv_cache, kv_valid)
    x = x + a.to(x.dtype)
    f, aux = _ffn(lp, x, cfg, routing)
    x = x + f.to(x.dtype)
    return x, cache, aux


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    # ``F.embedding``, not indexing: over a mesh DTensor has a strategy for
    # it (vocab- or width-sharded tables) and for its backward
    return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            routing: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward (no cache); returns (logits, moe_aux). A
    ``routing`` list gets each MoE layer's router choices (``moe_ffn``; with
    remat the backward's recomputation appends them again)."""
    B, S = tokens.shape
    cd = cfg.compute_dtype
    seq_ax = "model" if cfg.seq_shard else None
    x = shard_hint(_embed(params, tokens, cfg), BATCH, seq_ax, None)
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, lp):
        out, _, aux = _layer(cfg, x, lp, positions, routing=routing)
        # sequence-parallel residual stream: what remat saves a layer is
        # sharded over 'model' on the sequence dim
        return shard_hint(out, BATCH, seq_ax, None), aux

    auxs = []
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x, aux = body(x, lp)
        auxs.append(aux)
    x = shard_hint(rms_norm(x, params["ln_f"], cfg.norm_eps).to(cd), BATCH, None, None)
    logits = x @ _head(params, cfg).to(cd)
    return shard_hint(logits, BATCH, None, "model"), torch.stack(auxs).sum()


def loss_fn(params, batch, cfg: TransformerConfig):
    logits, aux = forward(params, batch["tokens"], cfg)
    loss = cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:])
    return loss + aux, {"loss": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int, device="cuda") -> dict:
    """Zeros [L, B, S, H_kv, hd]; over a mesh, batch over (pod, data) and
    heads over 'model' (``dist.sharding.kv_cache_shardings``' layout)."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    spec = (None, BATCH, None, "model", None)
    return {
        "k": sharded_zeros(shape, cfg.compute_dtype, device, *spec),
        "v": sharded_zeros(shape, cfg.compute_dtype, device, *spec),
    }


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig, max_seq: int):
    """Run the prompt; returns (last-position logits, filled cache, length)."""
    B, S = tokens.shape
    cd = cfg.compute_dtype
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_kv_cache(cfg, B, max_seq, x.device)
    for i in range(cfg.n_layers):
        x, (k, v), _ = _layer(cfg, x, _layer_params(params, i), positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = rms_norm(x, params["ln_f"], cfg.norm_eps).to(cd)
    logits = x[:, -1] @ _head(params, cfg).to(cd)
    return logits, cache, S


@torch.no_grad()
def decode_step(params, cache: dict, tokens: torch.Tensor, pos, cfg: TransformerConfig):
    """One decode step: tokens [B] at absolute position ``pos`` (an int);
    attends over cache[:pos+1]. Returns (logits [B,V], the cache, written in
    place at ``pos``)."""
    pos = int(pos)
    B = tokens.shape[0]
    cd = cfg.compute_dtype
    x = _embed(params, tokens, cfg)[:, None, :]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        kv = (cache["k"][i], cache["v"][i], pos)
        x, _, _ = _layer(cfg, x, _layer_params(params, i), positions,
                         kv_cache=kv, kv_valid=pos + 1)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps).to(cd)
    logits = x[:, 0] @ _head(params, cfg).to(cd)
    return logits, cache

