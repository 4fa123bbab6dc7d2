"""The synthetic data of the two tasks (port of
``repro/data/synthetic.py``).

``LogRegData`` is the a9a-like synthetic dataset of the paper's
experiments; minibatches are drawn with ``repro_torch.random.randint``
(uniform) or ``random.choice`` (importance sampling) so they equal the
reference's index for index. ``TokenStream`` is the LM task's token
stream, drawn with the same generator, so its tokens, labels and
frontend embeddings equal the reference's; ``corrupt_labels_lm`` is its
label-flipping attack.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as R
from repro_torch import xla_math as X
from repro_torch.core.attacks import fma_f32


@dataclasses.dataclass
class LogRegData:
    features: torch.Tensor      # (N, d) float32
    labels: torch.Tensor        # (N,) float32 in {0, 1}
    n_workers: int
    homogeneous: bool = True

    @classmethod
    def from_numpy(cls, features, labels, n_workers: int,
                   homogeneous: bool = True, device="cpu") -> "LogRegData":
        """Wrap arrays made elsewhere (e.g. by the reference package)."""
        return cls(torch.as_tensor(np.asarray(features), device=device),
                   torch.as_tensor(np.asarray(labels), device=device),
                   n_workers, homogeneous)

    @property
    def per_worker(self) -> int:
        if self.homogeneous:
            return self.features.shape[0]
        return self.features.shape[0] // self.n_workers

    def worker_slice(self, i):
        """Static worker shard (heterogeneous) or the full set."""
        if self.homogeneous:
            return self.features, self.labels
        m = self.per_worker
        return (self.features[i * m:(i + 1) * m],
                self.labels[i * m:(i + 1) * m])

    def stacked(self) -> dict:
        """(n, m, d) / (n, m) stacked per-worker datasets (the anchor)."""
        parts = [self.worker_slice(i) for i in range(self.n_workers)]
        return {"x": torch.stack([x for x, _ in parts]),
                "y": torch.stack([y for _, y in parts])}

    def sample_batches(self, key, batch_size: int) -> dict:
        """(n, b, d) minibatches, uniform with replacement."""
        n, m = self.n_workers, self.per_worker
        idx = R.randint(key, (n, batch_size), 0, m)
        if self.homogeneous:
            return {"x": self.features[idx], "y": self.labels[idx]}
        full = self.stacked()
        x = torch.gather(full["x"], 1,
                         idx[..., None].expand(-1, -1, full["x"].shape[-1]))
        return {"x": x, "y": torch.gather(full["y"], 1, idx)}

    def sample_batches_importance(self, key, batch_size: int,
                                  probs) -> dict:
        """(n, b, d) minibatches drawn with replacement by ``probs`` (m,)
        (Example E.2), worker i under fold_in(key, i), with the
        inverse-propensity weights w_j = 1/(m·p_j) under ``"w"`` so the
        weighted minibatch gradient stays unbiased."""
        n, m = self.n_workers, self.per_worker
        keys = R.fold_in(key, torch.arange(n, device=key.device))
        idx = R.choice(keys, m, (batch_size,), probs)
        w = 1.0 / (m * probs[idx])
        if self.homogeneous:
            return {"x": self.features[idx], "y": self.labels[idx], "w": w}
        full = self.stacked()
        x = torch.gather(full["x"], 1,
                         idx[..., None].expand(-1, -1, full["x"].shape[-1]))
        return {"x": x, "y": torch.gather(full["y"], 1, idx), "w": w}


def make_logreg_data(key, *, n_samples=2000, dim=50, n_workers=5,
                     homogeneous=True, noise=0.1) -> LogRegData:
    """Synthetic, roughly separable binary data with ~60% zero features
    (the a9a stand-in), on ``key``'s device."""
    k1, k2, k3, k4 = R.split(key, 4)
    w_true = R.normal(k1, (dim,))
    x = R.normal(k2, (n_samples, dim))
    x = torch.where(R.bernoulli(k3, 0.4, x.shape), x, 0.0)
    logits = x @ w_true + noise * R.normal(k4, (n_samples,))
    y = (logits > 0).float()
    return LogRegData(features=x, labels=y, n_workers=n_workers,
                      homogeneous=homogeneous)


def xla_softplus(logits):
    """``jax.nn.softplus`` as XLA compiles it on the CPU: logaddexp(l, 0)
    = max(l, 0) + log1p(exp(−|l|)), NaN kept, in ``xla_math``'s exp and
    log1p."""
    return torch.where(torch.isnan(logits), logits,
                       torch.clamp(logits, min=0.0)
                       + X.log1p(X.exp(-logits.abs())))


def xla_softplus_cotangent(logits, sp, y, cot):
    """The logits' cotangent of Σ cot·(softplus(l) − y·l), as XLA fuses
    logaddexp's derivative: cot·exp(l − softplus(l)) − cot·y in one
    rounding (a subnormal flushed to zero), an infinite l or softplus read
    as 0."""
    inf = float("inf")
    e = X.exp(torch.where(logits == inf, 0.0, logits)
              - torch.where(sp == inf, 0.0, sp))
    return X.ftz(fma_f32(e, cot, -(y * cot)))


def _batched(info, in_dims, *args):
    """The arguments of a vmapped call with the batch axis first (unbatched
    ones expanded to it)."""
    return [a.movedim(d, 0) if d is not None
            else a.expand((info.batch_size,) + tuple(a.shape))
            for a, d in zip(args, in_dims)]


class _XlaLogisticCE(torch.autograd.Function):
    """Mean logistic cross-entropy of a (..., B, d) batch and its gradient
    in the reference's compiled order on the CPU (read from XLA's object
    code for ``jax.jit(vmap(value_and_grad))``): softplus and its
    derivative in XLA's exp and log1p; the mean a sum in XLA's windows
    times the rounded 1/B; the bias' gradient a sum over the rows. The two
    products are PyTorch's: the logits x·w, which XLA's loop fusion lets
    LLVM reassociate into an order that depends on d and the host's vector
    width (ROADMAP queue 3), and the weights' gradient, XLA's column-major
    product (one fused multiply-add a row in row order,
    ``aggregators.weighted_rows``), which a Python loop over the rows would
    repeat at three times the cost of a CPU round while the logits already
    part from XLA's by an ulp.

    Under ``torch.func.vmap`` the forward and the backward
    (``_XlaLogisticGrad``) run on the whole batch of workers at once: the
    bit manipulations of ``xla_math`` have no batching rule in every
    PyTorch release."""

    @staticmethod
    def forward(x, w, b, y):
        from repro_torch.core.aggregators import xla_sum_lanes
        logits = (x @ w[..., :, None])[..., 0] + b[..., None]
        sp = xla_softplus(logits)
        ce = xla_sum_lanes(sp - y * logits) * (1.0 / y.shape[-1])
        return ce, logits, sp

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, _, y = inputs
        _, logits, sp = output
        ctx.save_for_backward(x, y, logits, sp)
        ctx.mark_non_differentiable(logits, sp)

    @staticmethod
    def backward(ctx, g, _g_logits, _g_sp):
        x, y, logits, sp = ctx.saved_tensors
        g_w, g_b = _XlaLogisticGrad.apply(x, y, logits, sp, g)
        return None, g_w, g_b, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, y):
        return (_XlaLogisticCE.forward(*_batched(info, in_dims, x, w, b, y)),
                (0, 0, 0))


class _XlaLogisticGrad(torch.autograd.Function):
    """The weights' and the bias' gradient of ``_XlaLogisticCE`` from the
    saved logits and the upstream gradient g (...,)."""

    @staticmethod
    def forward(x, y, logits, sp, g):
        from repro_torch.core.aggregators import xla_sum_lanes
        g_logits = xla_softplus_cotangent(
            logits, sp, y, (g * (1.0 / y.shape[-1]))[..., None])
        return (g_logits[..., None, :] @ x)[..., 0, :], xla_sum_lanes(g_logits)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the logistic gradient has no gradient")

    @staticmethod
    def vmap(info, in_dims, x, y, logits, sp, g):
        return (_XlaLogisticGrad.forward(
            *_batched(info, in_dims, x, y, logits, sp, g)), (0, 0))


def logreg_loss(lam: float = 0.01, nonconvex: bool = False):
    """ℓ2-regularized logistic loss; ``nonconvex=True`` takes the
    regularizer λ Σ w²/(1+w²) instead. On the CPU the value and its
    gradient follow the reference's compiled code op for op but for the
    logits' dot product (``_XlaLogisticCE``, the squares summed in XLA's
    windows); on the card they are PyTorch's (``F.softplus``, cuBLAS)."""

    def loss_fn(params, batch, key=None):
        w = params["w"]
        y = batch["y"]
        if w.device.type == "cpu" and "w" not in batch:
            from repro_torch.core.aggregators import xla_sum_lanes
            ce = _XlaLogisticCE.apply(batch["x"], w, params["b"], y)[0]
            sq = w * w
            if nonconvex:
                sq = sq / (1.0 + sq)
            return ce + lam * xla_sum_lanes(sq)
        logits = batch["x"] @ w + params["b"]
        per = F.softplus(logits) - y * logits
        if "w" in batch:                      # importance-sampling weights
            per = per * batch["w"]
        ce = per.mean()
        if nonconvex:
            reg = lam * (w * w / (1.0 + w * w)).sum()
        else:
            reg = lam * (w * w).sum()
        return ce + reg

    return loss_fn


def init_logreg_params(dim: int, device="cpu") -> dict:
    return {"w": torch.zeros(dim, dtype=torch.float32, device=device),
            "b": torch.zeros((), dtype=torch.float32, device=device)}


def corrupt_labels_logreg(batch, byz_mask):
    """LF attack: y -> 1 - y on byzantine workers."""
    m = byz_mask.reshape((-1,) + (1,) * (batch["y"].dim() - 1))
    return {**batch, "y": torch.where(m, 1.0 - batch["y"], batch["y"])}


# ---------------------------------------------------------------------------
# synthetic LM token stream
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Per-round (n_workers, batch, seq_len[, num_codebooks]) token
    batches: ``minibatch(step)`` from fold_in(PRNGKey(seed), step),
    ``anchor(step)`` (``anchor_batches`` times the minibatch) from
    fold_in(PRNGKey(seed + 1), step), on ``device``."""
    vocab_size: int
    seq_len: int
    n_workers: int
    per_worker_batch: int
    num_codebooks: int = 1
    frontend_tokens: int = 0
    d_model: int = 0
    anchor_batches: int = 2
    seed: int = 0
    heterogeneous: bool = False  # shift each worker's token distribution
    device: str = "cpu"

    def _tokens(self, key, batch):
        shape = (self.n_workers, batch, self.seq_len)
        if self.num_codebooks > 1:
            shape = shape + (self.num_codebooks,)
        toks = R.randint(key, shape, 0, self.vocab_size)
        if self.heterogeneous:
            # a worker-dependent vocabulary shift: heterogeneity ζ² > 0
            shift = (torch.arange(self.n_workers, device=toks.device)
                     * 17)[:, None, None]
            if self.num_codebooks > 1:
                shift = shift[..., None]
            toks = (toks + shift) % self.vocab_size
        return toks

    def _with_extras(self, key, toks):
        batch = {"tokens": toks, "labels": _shifted_labels(toks)}
        if self.frontend_tokens:
            kf = R.fold_in(key, 7)
            batch["frontend"] = 0.02 * R.normal(
                kf, tuple(toks.shape[:2])
                + (self.frontend_tokens, self.d_model))
        return batch

    def _key(self, seed: int, step: int):
        return R.fold_in(R.PRNGKey(seed, device=self.device), step)

    def minibatch(self, step: int) -> dict:
        key = self._key(self.seed, step)
        return self._with_extras(key, self._tokens(key,
                                                   self.per_worker_batch))

    def anchor(self, step: int) -> dict:
        key = self._key(self.seed + 1, step)
        toks = self._tokens(key, self.per_worker_batch * self.anchor_batches)
        return self._with_extras(key, toks)


def _shifted_labels(toks):
    """Next-token labels; the last position masked with -1."""
    lab = torch.roll(toks, -1, dims=2)
    lab[:, :, -1] = -1
    return lab


def corrupt_labels_lm(batch, byz_mask):
    """LF for LM data: byzantine workers train on labels rolled by 3."""
    lab = batch["labels"]
    m = byz_mask.reshape((-1,) + (1,) * (lab.dim() - 1))
    wrong = torch.roll(lab, 3, dims=2)
    return {**batch, "labels": torch.where(m & (lab >= 0), wrong, lab)}
