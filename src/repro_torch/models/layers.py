"""Model building blocks: init helpers, RMSNorm, RoPE / M-RoPE, GQA
causal attention (optionally sliding-window) with its query-chunked and
online-softmax forms, multi-head latent attention (MLA), the gated MLP,
the sort-based MoE FFN, the depthwise causal conv, the Mamba2 SSD block
and the RG-LRU block (port of ``repro/models/layers.py``).

Everything is a plain function of a flat ``dict[str, Tensor]``. The
operations are the reference's, in its order and dtypes: projections in
the parameters' dtype, attention scores and softmax in float32, norms in
float32 and cast back. Initializers draw with ``repro_torch.random``,
so a leaf equals the reference's bit for bit; the SSD and RG-LRU inits'
constants go through ``xla_math``'s linspace, log and expm1 for the
same reason.

Each mixer also has its one-token decode step and its cache (a flat
dict of tensors with the reference's leaf names): the attention kinds
keep keys, values and positions in a buffer of ``capacity`` slots (a
ring of ``min(capacity, window)`` under a sliding window), MLA only its
normed latent and its RoPE key (the absorbed form), Mamba2 and the
RG-LRU a float32 state and the causal conv's last inputs. ``len``, the
tokens seen, is a 0-d int32 tensor on the cache's device: a step writes
its slot by tensor indexing and reads nothing back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch import xla_math as X

# the query-chunk length of ``attention`` (the reference's module cell)
Q_CHUNK = [1024]

# "chunked": each q-chunk materializes its (Sq, Sk) scores; "online": a
# flash-style running softmax over KV chunks
ATTN_IMPL = ["chunked"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def subtree(params: dict, prefix: str) -> dict:
    """The leaves of a flat dict under ``prefix`` ("mixer/", "shared/"),
    the prefix stripped."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _dense_init(key, shape, dtype, scale=None):
    """normal · 1/sqrt(fan_in), rounded once to ``dtype``; the normal and
    the product are two float32 roundings, as the reference's eager
    ``jax.random.normal(key, shape) * scale``."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (R.normal(key, shape) * scale).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10_000.0, mrope_sections=None):
    """x: (..., S, H, D). positions: (..., S) int, or (..., S, 3) for
    M-RoPE, whose (temporal, height, width) sections of the frequency
    bands each rotate by their own position component."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = _rope_freqs(head_dim, theta, x.device)              # (half,)
    if mrope_sections is not None and positions.dim() == x.dim() - 1:
        sec = mrope_sections
        assert sum(sec) == half, (sec, half)
        comp = [positions[..., i:i + 1].expand(
                    tuple(positions.shape[:-1]) + (s,))
                for i, s in enumerate(sec)]
        pos = torch.cat(comp, dim=-1).float()          # (..., S, half)
        angles = pos * freqs
    else:
        angles = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal, optional sliding window)
# ---------------------------------------------------------------------------

def attention_shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd),
              "wo": (nq * hd, d)}
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def init_attention(key, cfg) -> dict:
    ks = R.split(key, 6)
    shapes = attention_shapes(cfg)
    p = {name: _dense_init(ks[i], shapes[name], cfg.torch_dtype)
         for i, name in enumerate(("wq", "wk", "wv", "wo"))}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.zeros(shapes[name], dtype=cfg.torch_dtype,
                                  device=key.device)
    return p


def _causal_mask(q_pos, k_pos, window):
    """(b, 1, 1, q, k): causal, and inside the window when one is set."""
    qp = q_pos[:, None, None, :, None]
    kp = k_pos[:, None, None, None, :]
    mask = qp >= kp
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return mask


def _attend(q, k, v, q_pos, k_pos, window=None, k_valid=None):
    """q: (B, Sq, Hq, D), k / v: (B, Sk, Hkv, D); scores and softmax in
    float32, masked scores set to -1e30."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(dh)
    mask = _causal_mask(q_pos, k_pos, window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


def _attend_online(q, k, v, q_pos, k_pos, window=None, k_valid=None,
                   kv_chunk=1024):
    """Flash-style attention: a loop over KV chunks carrying the running
    (max, denominator, accumulator), in float32. A row whose keys are all
    masked so far keeps max = -inf, and its terms are guarded so that no
    -inf - -inf reaches an exponential."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kv_chunk = min(kv_chunk, sk)
    if k_valid is None:
        k_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    if sk % kv_chunk:
        pad = kv_chunk - sk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        k_valid = F.pad(k_valid, (0, pad), value=False)
        sk += pad
    nkc = sk // kv_chunk
    qg = q.reshape(b, sq, hkv, group, dh).float()
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((b, hkv, group, sq), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, group, sq), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, v.shape[-1]), device=q.device)
    for c in range(nkc):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        ki, vi, pi, vali = k[:, sl], v[:, sl], k_pos[:, sl], k_valid[:, sl]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ki.float())
        s = s * scale
        mask = _causal_mask(q_pos, pi, window)
        mask = mask & (pi >= 0)[:, None, None, None, :]
        mask = mask & vali[:, None, None, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bhgqk,bkhd->bhgqd", p, vi.float()))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.movedim(3, 1).reshape(b, sq, hq, v.shape[-1])
    return out.to(q.dtype)


def attention(params, cfg, x, positions, *, window=None, q_chunk=None):
    """The train / prefill attention path. positions: (B, S) or, for
    M-RoPE, (B, S, 3). Above ``q_chunk`` queries (when they divide) the
    queries go in chunks against all keys."""
    q_chunk = q_chunk or Q_CHUNK[0]
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    q = torch.einsum("bsd,de->bse", x, params["wq"]).reshape(b, s, nq, hd)
    k = torch.einsum("bsd,de->bse", x, params["wk"]).reshape(b, s, nkv, hd)
    v = torch.einsum("bsd,de->bse", x, params["wv"]).reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    scalar_pos = positions if positions.dim() == 2 else positions[..., 0]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if ATTN_IMPL[0] == "online" and s > 1:
        out = _attend_online(q, k, v, scalar_pos, scalar_pos, window=window)
    elif s <= q_chunk or s % q_chunk:
        out = _attend(q, k, v, scalar_pos, scalar_pos, window=window)
    else:
        outs = [_attend(q[:, c:c + q_chunk], k, v,
                        scalar_pos[:, c:c + q_chunk], scalar_pos,
                        window=window)
                for c in range(0, s, q_chunk)]
        out = torch.cat(outs, dim=1)
    return torch.einsum("bse,ed->bsd", out.reshape(b, s, nq * hd),
                        params["wo"])


def _step_position(cur, b):
    """The (b, 1) int32 positions of the token at ``cur``, a 0-d
    tensor."""
    return cur.to(torch.int32).reshape(1, 1).expand(b, 1)


def attention_decode(params, cfg, x, cache, *, window=None):
    """One-token decode with a KV cache. x: (B, 1, d).

    cache: {"k": (B, L, Hkv, D), "v": ..., "pos": (B, L) int32 absolute
    positions (-1 an empty slot), "len": () int32 tokens seen so far}.
    The token goes to slot ``len mod L``, so under a sliding window the
    cache is a ring buffer of L slots. -> (y (B, 1, d), new cache)."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    cur = cache["len"]
    cap = cache["k"].shape[1]
    q = torch.einsum("bsd,de->bse", x, params["wq"]).reshape(b, 1, nq, hd)
    k = torch.einsum("bsd,de->bse", x, params["wk"]).reshape(b, 1, nkv, hd)
    v = torch.einsum("bsd,de->bse", x, params["wv"]).reshape(b, 1, nkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    pos = _step_position(cur, b)
    if cfg.mrope_sections is not None:
        pos3 = pos[..., None].expand(b, 1, 3)
        q = apply_rope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    # the reference's dynamic_update_slice, out of place, at a slot that
    # stays on the device: no host read in a step
    slot = torch.remainder(cur, cap).long().reshape(1)
    ck = cache["k"].index_copy(1, slot, k)
    cv = cache["v"].index_copy(1, slot, v)
    cpos = cache["pos"].index_copy(1, slot, pos)
    out = _attend(q, ck, cv, pos, cpos, window=window, k_valid=cpos >= 0)
    y = torch.einsum("bse,ed->bsd", out.reshape(b, 1, nq * hd), params["wo"])
    return y, {"k": ck, "v": cv, "pos": cpos, "len": cur + 1}


def init_attention_cache(cfg, batch, capacity, *, window=None,
                         device=None) -> dict:
    """Empty KV cache of ``min(capacity, window)`` slots (``capacity``
    without a window)."""
    hd = cfg.resolved_head_dim
    cap = min(capacity, window) if window else capacity
    kv = (batch, cap, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(kv, dtype=cfg.torch_dtype, device=device),
            "pos": torch.full((batch, cap), -1, dtype=torch.int32,
                              device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------

def mla_shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, r, rd = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    return {"wq": (d, nq * (hd + rd)), "w_dkv": (d, r), "w_uk": (r, nq * hd),
            "w_uv": (r, nq * hd), "w_kr": (d, rd), "wo": (nq * hd, d),
            "kv_norm": (r,)}


def init_mla(key, cfg) -> dict:
    """The key split 7 ways, the first six drawn in the reference's order
    (query, KV down, K up, V up, shared RoPE key, output); ``kv_norm``
    zeros."""
    ks = R.split(key, 7)
    shapes = mla_shapes(cfg)
    p = {name: _dense_init(ks[i], shapes[name], cfg.torch_dtype)
         for i, name in enumerate(("wq", "w_dkv", "w_uk", "w_uv", "w_kr",
                                   "wo"))}
    p["kv_norm"] = torch.zeros(shapes["kv_norm"], dtype=cfg.torch_dtype,
                               device=key.device)
    return p


def mla_attention(params, cfg, x, positions, *, q_chunk=1024):
    """Train / prefill MLA: per-head K and V materialized from the normed
    latent; one RoPE'd key head shared by every head. q and k carry
    hd + rd dims (the softmax scale 1/sqrt(hd + rd)), v hd. Like the
    reference it ignores ``q_chunk`` and attends in one piece."""
    b, s, _ = x.shape
    hd, nq = cfg.resolved_head_dim, cfg.num_heads
    rd = cfg.qk_rope_dim
    q = torch.einsum("bsd,de->bse", x, params["wq"]).reshape(b, s, nq,
                                                            hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    c_kv = rms_norm(torch.einsum("bsd,dr->bsr", x, params["w_dkv"]),
                    params["kv_norm"], cfg.norm_eps)
    k_nope = torch.einsum("bsr,re->bse", c_kv,
                          params["w_uk"]).reshape(b, s, nq, hd)
    v = torch.einsum("bsr,re->bse", c_kv, params["w_uv"]).reshape(b, s, nq,
                                                                  hd)
    k_rope = torch.einsum("bsd,dr->bsr", x, params["w_kr"])[:, :, None, :]
    pos = positions if positions.dim() == 2 else positions[..., 0]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope, pos, cfg.rope_theta)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, nq, rd)], dim=-1)
    out = _attend(qf, kf, v, pos, pos)
    return torch.einsum("bse,ed->bsd", out.reshape(b, s, nq * hd),
                        params["wo"])


def mla_decode(params, cfg, x, cache):
    """Absorbed-form MLA decode: the cache holds only the normed latent
    ``c_kv`` (B, L, r) and the RoPE'd shared key ``k_rope`` (B, L, rd);
    W_uk folds into the query and W_uv into the output, in float32 and
    in the reference's einsum pairs, so no per-head K or V is built."""
    b, s, _ = x.shape
    assert s == 1
    hd, nq = cfg.resolved_head_dim, cfg.num_heads
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    cur = cache["len"]
    cap = cache["c_kv"].shape[1]
    q = torch.einsum("bsd,de->bse", x, params["wq"]).reshape(b, 1, nq,
                                                            hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    pos = _step_position(cur, b)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    c_new = rms_norm(torch.einsum("bsd,dr->bsr", x, params["w_dkv"]),
                     params["kv_norm"], cfg.norm_eps)
    kr_new = apply_rope(
        torch.einsum("bsd,dr->bsr", x, params["w_kr"])[:, :, None, :], pos,
        cfg.rope_theta)[:, :, 0, :]
    slot = torch.remainder(cur, cap).long().reshape(1)
    c_kv = cache["c_kv"].index_copy(1, slot, c_new)
    k_rope = cache["k_rope"].index_copy(1, slot, kr_new)
    cpos = cache["pos"].index_copy(1, slot, pos)
    # W_uk absorbed into q: score = (q_nope W_uk^T) . c + q_rope . k_rope
    w_uk = params["w_uk"].reshape(r, nq, hd).float()
    q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
    scores = (torch.einsum("bqhr,blr->bhql", q_eff, c_kv.float())
              + torch.einsum("bqhr,blr->bhql", q_rope.float(),
                             k_rope.float()))
    scores = scores / math.sqrt(hd + rd)
    mask = (cpos >= 0) & (cpos <= cur)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhql,blr->bqhr", probs, c_kv.float())
    w_uv = params["w_uv"].reshape(r, nq, hd).float()
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
    out = out.reshape(b, 1, nq * hd).to(x.dtype)
    y = torch.einsum("bse,ed->bsd", out, params["wo"])
    return y, {"c_kv": c_kv, "k_rope": k_rope, "pos": cpos, "len": cur + 1}


def init_mla_cache(cfg, batch, capacity, device=None) -> dict:
    dt = cfg.torch_dtype
    return {"c_kv": torch.zeros((batch, capacity, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, capacity, cfg.qk_rope_dim),
                                  dtype=dt, device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_shapes(cfg, d_ff=None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}


def init_mlp(key, cfg, d_ff=None) -> dict:
    ks = R.split(key, 3)
    shapes = mlp_shapes(cfg, d_ff)
    return {name: _dense_init(ks[i], shapes[name], cfg.torch_dtype)
            for i, name in enumerate(("w1", "w3", "w2"))}


def mlp(params, x):
    h = F.silu(torch.einsum("...d,df->...f", x, params["w1"]))
    h = h * torch.einsum("...d,df->...f", x, params["w3"])
    return torch.einsum("...f,fd->...d", h, params["w2"])


# ---------------------------------------------------------------------------
# MoE FFN (sort-based, capacity-constrained dispatch)
# ---------------------------------------------------------------------------

def moe_shapes(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    de = m.d_expert or cfg.d_ff
    shapes = {"router": (d, m.num_experts), "w1": (m.num_experts, d, de),
              "w3": (m.num_experts, d, de), "w2": (m.num_experts, de, d)}
    if m.num_shared:
        shapes.update({f"shared/{k}": s for k, s in
                       mlp_shapes(cfg, de * m.num_shared).items()})
    return shapes


def init_moe(key, cfg) -> dict:
    """Router and the (E, ·, ·) expert stacks from a 5-way split, the
    shared experts one gated MLP of width d_e · num_shared from the fifth
    key. ``_dense_init`` takes fan_in = shape[0], which is E for the
    stacks, as in the reference."""
    m = cfg.moe
    ks = R.split(key, 5)
    shapes = moe_shapes(cfg)
    p = {name: _dense_init(ks[i], shapes[name], cfg.torch_dtype)
         for i, name in enumerate(("router", "w1", "w3", "w2"))}
    if m.num_shared:
        de = m.d_expert or cfg.d_ff
        p.update({f"shared/{k}": v for k, v in
                  init_mlp(ks[4], cfg, d_ff=de * m.num_shared).items()})
    return p


class _RouterSoftmax(torch.autograd.Function):
    """float32 softmax over the last axis whose values are those of the
    reference's compiled ``jax.nn.softmax`` (XLA's exp of x − max, the
    lane sum in XLA's order, a true division), so that the routing and
    its ties are the reference's; its gradient is the softmax's,
    p · (g − Σ g·p). Under ``torch.func.vmap`` the forward runs on the
    whole batch at once: ``xla_math``'s bit manipulations have no
    batching rule in every PyTorch release."""

    @staticmethod
    def forward(logits):
        ex = X.exp(logits - logits.amax(dim=-1, keepdim=True))
        return ex / X.xla_sum_lanes(ex)[..., None]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        return p * (g - (g * p).sum(dim=-1, keepdim=True))

    @staticmethod
    def vmap(info, in_dims, logits):
        if in_dims[0] is None:
            return _RouterSoftmax.forward(logits), None
        return _RouterSoftmax.forward(logits.movedim(in_dims[0], 0)), 0


def moe_route(logits, k: int, cap: int) -> dict:
    """The reference's routing of t tokens to k of e experts from float32
    logits (t, e): the top k probabilities by a stable descending sort
    (``lax.top_k``'s order: the lower index first among equal values),
    the gates renormalized, the (token, expert) assignments stably sorted
    by expert, each one's rank within its expert, and its slot
    ``expert · cap + rank`` where the rank is under ``cap``, else the
    overflow slot e · cap. Counts are a scatter-add into zeros (it has a
    batching rule under ``torch.func.vmap``; ``bincount`` has none).
    -> {probs, gate, idx, counts, se, st, sg, keep, dest}."""
    t, e = logits.shape
    dev = logits.device
    probs = _RouterSoftmax.apply(logits)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], order[:, :k]
    gate = gate / torch.clamp(X.xla_sum_lanes(gate), min=1e-9)[:, None]
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    by_expert = torch.argsort(flat_e, stable=True)
    se, st = flat_e[by_expert], flat_t[by_expert]
    sg = gate.reshape(-1)[by_expert]
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[se]
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)
    return {"probs": probs, "gate": gate, "idx": idx, "counts": counts,
            "se": se, "st": st, "sg": sg, "keep": keep, "dest": dest}


def moe_ffn(params, cfg, x):
    """Sort-based capacity-constrained MoE: x (B, S, d) -> (y, aux), aux
    the Switch load-balance loss E · Σ_e f_e · P_e times the aux weight.
    Each token's row goes to its slot of an (E · cap + 1, d) buffer (the
    last row takes every dropped assignment and is cut off before the
    experts, so it gets no gradient), the experts run as one batched
    product per matrix, and each kept assignment's output, times its
    gate, is added back to its token. The buffer and the combine are
    ``index_put`` into fresh zeros; the combine and the backward of the
    gathers accumulate in index order, so a round repeats on the card."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d)
    logits = torch.einsum("td,de->te", xf, params["router"]).float()
    cap = int(m.capacity_factor * t * k / e) + 1
    r = moe_route(logits, k, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype,
                      device=xf.device).index_put((r["dest"],), xf[r["st"]])
    ex_in = buf[:-1].reshape(e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", ex_in, params["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", ex_in, params["w3"])
    ex_out = torch.einsum("ecf,efd->ecd", h, params["w2"])
    picked = ex_out.reshape(e * cap, d)[torch.clamp(r["dest"],
                                                    max=e * cap - 1)]
    picked = picked * (r["keep"] * r["sg"])[:, None].to(picked.dtype)
    yf = torch.zeros((t, d), dtype=xf.dtype, device=xf.device).index_put(
        (r["st"],), picked, accumulate=True)
    y = yf.reshape(b, s, d)
    if m.num_shared:
        y = y + mlp(subtree(params, "shared/"), x)
    frac = r["counts"].float() / (t * k)
    pmean = r["probs"].mean(dim=0)
    aux = e * torch.sum(frac * pmean) * m.router_aux_weight
    return y, aux


# ---------------------------------------------------------------------------
# depthwise causal conv1d (shared by the Mamba2 and RG-LRU blocks)
# ---------------------------------------------------------------------------

def _fma64(a, b, c):
    """a·b + c rounded once to float32, as the reference's compiled code
    fuses it: the float32 product is exact in float64, and so is the sum
    but where the operands' exponents lie far apart; there the float64
    sum can round onto a float32 tie (about 2⁻²⁹ of such inputs) and
    round twice. It runs under ``torch.func``'s vmap and grad, which
    ``attacks.fma_f32``'s bit view does not in every PyTorch release."""
    return (a.double() * b.double() + c.double()).float()


def causal_conv1d(x, w):
    """x: (B, T, C); w: (W, C) depthwise causal filter. The taps add in
    float32 from the first, as the reference's loop adds them from zeros;
    XLA drops the zeros and fuses each later tap's product into its sum,
    the first tap's product into the second's sum. In bfloat16 every
    product is exact in float32, so the plain sum is that sum."""
    width, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0)).float()
    wf = w.float()
    taps = [xp[:, i:i + t, :] for i in range(width)]
    if x.dtype != torch.float32:
        out = taps[0] * wf[0]
        for i in range(1, width):
            out = out + taps[i] * wf[i]
        return out.to(x.dtype)
    out = taps[0] * wf[0] if width == 1 else _fma64(taps[0], wf[0],
                                                    taps[1] * wf[1])
    for i in range(2, width):
        out = _fma64(taps[i], wf[i], out)
    return out


def causal_conv1d_step(x, w, conv_state):
    """x: (B, 1, C); conv_state: (B, W-1, C), the previous inputs. ->
    (out (B, 1, C), the new state): the window's taps summed in float32
    as one contraction over W, as the reference's einsum."""
    window = torch.cat([conv_state, x], dim=1)            # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    return out[:, None, :].to(x.dtype), window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba2 SSD block (arXiv:2405.21060): chunked state-space duality
# ---------------------------------------------------------------------------

def mamba2_shapes(cfg) -> dict:
    d = cfg.d_model
    di, n = cfg.ssm_expand * d, cfg.ssm_state
    nh = di // cfg.ssm_headdim
    return {"w_in": (d, 2 * di + 2 * n + nh),
            "conv_w": (cfg.conv_width, di + 2 * n), "a_log": (nh,),
            "dt_bias": (nh,), "d_skip": (nh,), "out_norm": (di,),
            "w_out": (di, d)}


def ssd_a_log(nh: int, device=None):
    """float32 log(linspace(1, 16, nh)) as the reference's eager init
    computes it (XLA's linspace and log)."""
    return X.log(X.linspace(1.0, 16.0, nh, device=device))


def init_mamba2(key, cfg) -> dict:
    """The key split 6 ways, the first three drawn (in_proj, conv, out);
    ``a_log`` from ``ssd_a_log``."""
    ks = R.split(key, 6)
    shapes = mamba2_shapes(cfg)
    dt, dev = cfg.torch_dtype, key.device
    nh = shapes["a_log"][0]
    return {
        "w_in": _dense_init(ks[0], shapes["w_in"], dt),
        "conv_w": _dense_init(ks[1], shapes["conv_w"], dt, scale=0.5),
        "a_log": ssd_a_log(nh, dev).to(dt),
        "dt_bias": torch.zeros((nh,), dtype=dt, device=dev),
        "d_skip": torch.ones((nh,), dtype=dt, device=dev),
        "out_norm": torch.zeros(shapes["out_norm"], dtype=dt, device=dev),
        "w_out": _dense_init(ks[2], shapes["w_out"], dt),
    }


def _inter_chunk(cr, prev_states, decay_in):
    """y_inter = Σ_n C · prev · exp(cum), the reference's three-operand
    einsum in the pair order ``jnp.einsum`` takes (opt_einsum's cheapest
    by flops: the outer product of decay and C first while the state
    width n is under the head width p, else C against the states over n
    first)."""
    if cr.shape[-1] < prev_states.shape[-1]:
        outer = torch.einsum("bcqh,bcqn->bcqhn", decay_in, cr)
        return torch.einsum("bcqhn,bchnp->bcqhp", outer, prev_states)
    cs = torch.einsum("bchnp,bcqn->bchpq", prev_states, cr)
    return torch.einsum("bcqh,bchpq->bcqhp", decay_in, cs)


def _ssd_chunked(xh, bmat, cmat, dt, a_log, chunk=64):
    """SSD over chunks. xh: (B, T, H, P), bmat / cmat: (B, T, N), dt:
    (B, T, H).

    h_t = exp(dt_t · A_h) h_{t-1} + dt_t · B_t ⊗ x_t ;  y_t = C_t · h_t.
    Returns y (B, T, H, P) and the final state (B, H, N, P), float32. The
    chunks' states pass on in a sequential loop, as the reference's scan
    passes them. The within-chunk cumsum takes XLA's order: the decays
    exp(cum_q − cum_k) difference running sums of up to some 700, where
    an ulp of the sum is most of the difference's error."""
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    chunk = min(chunk, t)
    nc = t // chunk
    assert t % chunk == 0, (t, chunk)
    a = -torch.exp(a_log.float())                        # (H,) negative
    dt = dt.float()
    da = dt * a                                          # log decay
    xr = xh.reshape(b, nc, chunk, h, p).float()
    br = bmat.reshape(b, nc, chunk, n).float()
    cr = cmat.reshape(b, nc, chunk, n).float()
    dar = da.reshape(b, nc, chunk, h)
    dtr = dt.reshape(b, nc, chunk, h)
    cum = X.cumsum(dar, dim=2)                           # (B, nc, Lc, H)
    # intra-chunk, quadratic within the chunk
    g = torch.einsum("bcqn,bckn->bcqk", cr, br)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # q - k
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    # masked in log space before the exp: the exp of an acausal (positive)
    # rel would overflow, and inf · 0 poison the gradient through the where
    rel = torch.where(causal[None, None, :, :, None], rel, -math.inf)
    decay = torch.exp(rel)
    m = g[..., None] * decay * dtr[:, :, None, :, :]      # (B, nc, q, k, H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xr)
    # the chunks' states
    tail = cum[:, :, -1:, :] - cum                       # decay to chunk end
    sx = xr * (dtr * torch.exp(tail))[..., None]
    states = torch.einsum("bckn,bckhp->bchnp", br, sx)   # (B, nc, H, N, P)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B, nc, H)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    y_inter = _inter_chunk(cr, torch.stack(prevs, dim=1), torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, t, h, p)
    return y, state


def mamba2_block(params, cfg, x, *, chunk=64):
    b, t, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.ssm_headdim
    ph = cfg.ssm_headdim
    zxbcdt = torch.einsum("btd,de->bte", x, params["w_in"])
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc = causal_conv1d(F.silu(xbc), params["conv_w"])
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())
    xh = xi.reshape(b, t, nh, ph)
    y, _ = _ssd_chunked(xh, bmat, cmat, dt, params["a_log"], chunk=chunk)
    y = y + xh.float() * params["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, t, di).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    return torch.einsum("bte,ed->btd", y, params["w_out"])


def mamba2_decode(params, cfg, x, cache):
    """O(1) recurrent decode of one token. cache: {"h": (B, H, N, P)
    float32, "conv": (B, W-1, di + 2N), "len"}. SiLU before the conv
    step, as in ``mamba2_block``; h ← exp(dt·A)·h + dt·B ⊗ x."""
    b, s, d = x.shape
    assert s == 1
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    nh = di // cfg.ssm_headdim
    ph = cfg.ssm_headdim
    zxbcdt = torch.einsum("btd,de->bte", x, params["w_in"])
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    xbc, conv_state = causal_conv1d_step(F.silu(xbc), params["conv_w"],
                                         cache["conv"])
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())[:, 0]  # (B, H)
    a = -torch.exp(params["a_log"].float())
    dec = torch.exp(dt * a)                                       # (B, H)
    xh = xi[:, 0].reshape(b, nh, ph).float()
    bm = bmat[:, 0].float()                                       # (B, N)
    cm = cmat[:, 0].float()
    hnew = (cache["h"] * dec[..., None, None]
            + torch.einsum("bn,bhp,bh->bhnp", bm, xh, dt))
    y = torch.einsum("bn,bhnp->bhp", cm, hnew)
    y = y + xh * params["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    out = torch.einsum("bte,ed->btd", y, params["w_out"])
    return out, {"h": hnew, "conv": conv_state, "len": cache["len"] + 1}


def init_mamba2_cache(cfg, batch, device=None) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_headdim
    return {"h": torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_headdim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1,
                                 di + 2 * cfg.ssm_state),
                                dtype=cfg.torch_dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _softplus(x):
    """``jax.nn.softplus``: log(eˣ + 1) as ``logaddexp(x, 0)``, with no
    switch to x above a threshold as ``F.softplus`` has."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_shapes(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru_width or d
    return {"w_gate_branch": (d, w), "w_rec_branch": (d, w),
            "conv_w": (cfg.conv_width, w), "w_a": (w, w), "b_a": (w,),
            "w_i": (w, w), "b_i": (w,), "lam": (w,), "w_out": (w, d)}


def rglru_lambda(w: int, device=None):
    """float32 Λ = log(expm1(−log(linspace(0.9, 0.999, w)) / c)), so that
    a = exp(−c·softplus(Λ)) spans [0.9, 0.999], as the reference's eager
    init computes it (XLA's linspace, log and expm1)."""
    return X.log(X.expm1(-X.log(X.linspace(0.9, 0.999, w, device=device))
                         / _RGLRU_C))


def init_rglru(key, cfg) -> dict:
    """The key split 7 ways, the first six drawn; Λ from
    ``rglru_lambda``."""
    ks = R.split(key, 7)
    shapes = rglru_shapes(cfg)
    dt, dev = cfg.torch_dtype, key.device
    w = shapes["lam"][0]
    p = {name: _dense_init(ks[i], shapes[name], dt,
                           scale=0.5 if name == "conv_w" else None)
         for i, name in enumerate(("w_gate_branch", "w_rec_branch",
                                   "conv_w", "w_a", "w_i", "w_out"))}
    p["b_a"] = torch.zeros((w,), dtype=dt, device=dev)
    p["b_i"] = torch.zeros((w,), dtype=dt, device=dev)
    p["lam"] = rglru_lambda(w, dev).to(dt)
    return p


def _rglru_gates(params, u):
    """-> (a, gated), float32: the recurrence and input gates, a =
    exp(−c·softplus(Λ)·r) and √max(1 − a², 1e-12) · i · u."""
    r = torch.sigmoid(torch.einsum("btw,wv->btv", u, params["w_a"]).float()
                      + params["b_a"].float())
    i = torch.sigmoid(torch.einsum("btw,wv->btv", u, params["w_i"]).float()
                      + params["b_i"].float())
    log_a = -_RGLRU_C * _softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u.float())
    return a, gated


def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1·a2, a2·b1 + b2), the sum
    fused as XLA fuses it."""
    return a1 * a2, _fma64(a2, b1, b2)


def _linear_scan(a, b):
    """h_t = a_t · h_{t-1} + b_t over axis 1, from h = 0: the recursion of
    ``lax.associative_scan`` (pairs combined, the odd positions scanned
    recursively, the even ones combined from them, then interleaved), so
    each h_t has the reference's rounding tree, in about 2·log₂ T levels
    of strided slices."""
    t = a.shape[1]
    if t < 2:
        return a, b
    ra, rb = _combine(a[:, 0:t - 1:2], b[:, 0:t - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _linear_scan(ra, rb)
    k = oa.shape[1] - (1 if t % 2 == 0 else 0)
    ea, eb = _combine(oa[:, :k], ob[:, :k], a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (even may be one
    longer)."""
    m = odd.shape[1]
    pairs = torch.stack([even[:, :m], odd], dim=2)
    out = pairs.reshape((pairs.shape[0], 2 * m) + tuple(pairs.shape[3:]))
    return torch.cat([out, even[:, m:]], dim=1)


def rglru_block(params, cfg, x):
    """Griffin's recurrent block: gelu(gate branch) · RG-LRU(conv(recurrent
    branch)). ``jax.nn.gelu`` is the tanh form."""
    gate = F.gelu(torch.einsum("btd,dw->btw", x, params["w_gate_branch"]),
                  approximate="tanh")
    u = torch.einsum("btd,dw->btw", x, params["w_rec_branch"])
    u = causal_conv1d(u, params["conv_w"])
    a, gated = _rglru_gates(params, u)
    _, h = _linear_scan(a, gated)
    y = h.to(x.dtype) * gate
    return torch.einsum("btw,wd->btd", y, params["w_out"])


def rglru_decode(params, cfg, x, cache):
    """One token of the recurrent block: the conv step, the gates of
    ``_rglru_gates``, h ← a·h + gated in float32."""
    gate = F.gelu(torch.einsum("btd,dw->btw", x, params["w_gate_branch"]),
                  approximate="tanh")
    u = torch.einsum("btd,dw->btw", x, params["w_rec_branch"])
    u, conv_state = causal_conv1d_step(u, params["conv_w"], cache["conv"])
    a, gated = _rglru_gates(params, u)
    h = a[:, 0] * cache["h"] + gated[:, 0]                       # (B, W)
    y = h[:, None, :].to(x.dtype) * gate
    out = torch.einsum("btw,wd->btd", y, params["w_out"])
    return out, {"h": h, "conv": conv_state, "len": cache["len"] + 1}


def init_rglru_cache(cfg, batch, device=None) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=cfg.torch_dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}
