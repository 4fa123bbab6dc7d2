"""Model building blocks of the dense decoders: init helpers, RMSNorm,
RoPE / M-RoPE, GQA causal attention (optionally sliding-window) with its
query-chunked and online-softmax forms, and the gated MLP (port of the
dense part of ``repro/models/layers.py``).

Everything is a plain function of a flat ``dict[str, Tensor]``. The
operations are the reference's, in its order and dtypes: projections in
the parameters' dtype, attention scores and softmax in float32, norms in
float32 and cast back. Initializers draw with ``repro_torch.random``,
so a leaf equals the reference's bit for bit.

MLA, MoE, the Mamba2 SSD and RG-LRU blocks and the decode caches are not
ported yet (``models.transformer`` names their ROADMAP items).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import random as R

# the query-chunk length of ``attention`` (the reference's module cell)
Q_CHUNK = [1024]

# "chunked": each q-chunk materializes its (Sq, Sk) scores; "online": a
# flash-style running softmax over KV chunks
ATTN_IMPL = ["chunked"]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

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
