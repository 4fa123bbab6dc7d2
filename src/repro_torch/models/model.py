"""The model: init, forward, loss (port of ``repro/models/model.py``).

Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's
tree paths joined with ``/`` (``embed``, ``final_norm``,
``groups/0/mixer/wq``, ..., ``unembed``): walked in sorted key order they
are ``jax.tree.flatten``'s leaves of the reference's nested tree, so a
per-leaf key schedule (RandK's ``fold_in(key, i)``) draws what the
reference draws.

Batch dict convention (the reference's)::

    tokens    (B, S) int           or (B, S, K) for codebook archs
    labels    (B, S[, K]) int      -1 marks masked positions
    frontend  (B, F, d_model)      stubbed modality embeddings (vlm, audio)
    positions optional (B, S) or (B, S, 3) for M-RoPE

For frontend archs the whole sequence is F + S_text; the loss reads the
text positions only.

Serving: ``init_cache`` gives the decode caches as a flat dict keyed by
the reference's cache tree paths (``groups/0/k``, ``tail/1/h``), so
``convert.flatten_tree`` of the reference's cache has the same keys,
shapes and dtypes; ``decode_step`` takes one token a sequence and
returns the logits and a new cache. ``param_specs`` and ``cache_specs``
(the model-parallel shardings) wait for ``launch/mesh.py`` (ROADMAP
queue 1, item 11).
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_shapes(cfg) -> dict:
    """{flat key: shape} of ``init_params(key, cfg)``, without drawing
    (the port's ``jax.eval_shape`` of the init), for every registered
    config."""
    d, v, kk = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    shapes = {"embed": (v, d) if kk == 1 else (kk, v, d),
              "final_norm": (d,), **T.stack_shapes(cfg)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, v) if kk == 1 else (kk, d, v)
    return dict(sorted(shapes.items()))


def init_params(key, cfg) -> dict:
    """The reference's init, leaf by leaf, on the key's device."""
    T.check_supported(cfg)
    k_embed, k_stack, k_out = R.split(key, 3)
    d, v, kk = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    embed_shape = (v, d) if kk == 1 else (kk, v, d)
    params = {"embed": (R.normal(k_embed, embed_shape) * 0.02
                        ).to(cfg.torch_dtype),
              "final_norm": torch.zeros((d,), dtype=cfg.torch_dtype,
                                        device=key.device),
              **T.init_stack(k_stack, cfg)}
    if not cfg.tie_embeddings:
        un_shape = (d, v) if kk == 1 else (kk, d, v)
        params["unembed"] = (R.normal(k_out, un_shape) * (1.0 / d ** 0.5)
                             ).to(cfg.torch_dtype)
    return dict(sorted(params.items()))


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    if cfg.num_codebooks == 1:
        return params["embed"][tokens]
    # (B, S, K) -> sum_k embed[k][tok_k]
    return sum(params["embed"][k][tokens[..., k]]
               for k in range(cfg.num_codebooks))


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        table = params["embed"]
        if cfg.num_codebooks == 1:
            return torch.einsum("bsd,vd->bsv", x, table)
        return torch.einsum("bsd,kvd->bskv", x, table)
    if cfg.num_codebooks == 1:
        return torch.einsum("bsd,dv->bsv", x, params["unembed"])
    return torch.einsum("bsd,kdv->bskv", x, params["unembed"])


def _positions(cfg, batch, total_len, device):
    pos = batch.get("positions")
    if pos is not None:
        return pos
    b = batch["tokens"].shape[0]
    base = torch.arange(total_len, device=device).expand(b, total_len)
    if cfg.mrope_sections is not None:
        # text default: t = h = w = index (plain RoPE)
        return base[..., None].expand(b, total_len, 3)
    return base


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def hidden(params, cfg, batch, *, remat: bool = False):
    """Final hidden states on the text positions, (B, S_text, d), and the
    float32 auxiliary loss."""
    x = _embed(params, cfg, batch["tokens"])
    n_front = 0
    if cfg.frontend_tokens and "frontend" in batch:
        fe = batch["frontend"].to(x.dtype)
        n_front = fe.shape[1]
        x = torch.cat([fe, x], dim=1)
    positions = _positions(cfg, batch, x.shape[1], x.device)
    x, aux = T.apply_stack(params, cfg, x, positions, remat=remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_front:
        x = x[:, n_front:, :]
    return x, aux


def forward(params, cfg, batch, *, remat: bool = False):
    """Logits on the text positions, and the auxiliary loss (the MoE
    layers' load-balance loss; 0 for the dense decoders)."""
    x, aux = hidden(params, cfg, batch, remat=remat)
    return _logits(params, cfg, x), aux


def _chunk_nll(params, cfg, xc, labels_c):
    """xc (B, C, d), labels_c (B, C[, K]) -> (nll sum, mask sum)."""
    logits = _logits(params, cfg, xc)
    mask = (labels_c >= 0).float()
    safe = torch.clamp(labels_c, min=0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, cfg, batch, *, remat: bool = False,
            xent_chunk: int = 1024):
    """Sequence-chunked cross entropy: above ``xent_chunk`` positions (when
    they divide) the (B, C, V) logits go chunk by chunk and their sums
    add in chunk order, as the reference's scan adds them. The reference
    rematerializes each chunk in the backward pass; torch.func's grad
    refuses checkpoint hooks, so here each chunk's logits stay alive
    until the backward pass. The auxiliary loss is added in float32."""
    x, aux = hidden(params, cfg, batch, remat=remat)
    labels = batch["labels"]
    s = x.shape[1]
    if s <= xent_chunk or s % xent_chunk:
        nll, msk = _chunk_nll(params, cfg, x, labels)
    else:
        nll = torch.zeros((), device=x.device)
        msk = torch.zeros((), device=x.device)
        for c in range(0, s, xent_chunk):
            n, m = _chunk_nll(params, cfg, x[:, c:c + xent_chunk],
                              labels[:, c:c + xent_chunk])
            nll, msk = nll + n, msk + m
    return nll / torch.clamp(msk, min=1.0) + aux.float()


def model_logits_last(params, cfg, x):
    """Last-position logits only (prefill output)."""
    return _logits(params, cfg, x[:, -1:, :])[:, 0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, capacity, device=None) -> dict:
    """Empty decode caches for ``batch`` sequences of up to ``capacity``
    tokens, on ``device`` (the CPU by default)."""
    return dict(sorted(T.init_stack_cache(cfg, batch, capacity,
                                          device).items()))


def decode_step(params, cfg, cache, tokens):
    """One decode step. tokens: (B,) int, or (B, K) for codebook archs.
    -> (logits (B, V) or (B, K, V), new cache)."""
    tok = tokens[:, None] if cfg.num_codebooks == 1 else tokens[:, None, :]
    x = _embed(params, cfg, tok)
    x, cache = T.decode_stack(params, cfg, x, cache)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], dict(sorted(cache.items()))
