"""The logistic-regression data of the paper's experiments (port of the
logreg part of ``repro/data/synthetic.py``).

``LogRegData`` is the a9a-like synthetic dataset; minibatches are drawn
with ``repro_torch.random.randint`` so they equal the reference's index
for index. ``TokenStream`` and the LM label corruption are not ported yet
(ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as R


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


def logreg_loss(lam: float = 0.01, nonconvex: bool = False):
    """ℓ2-regularized logistic loss; ``nonconvex=True`` takes the
    regularizer λ Σ w²/(1+w²) instead."""

    def loss_fn(params, batch, key=None):
        w = params["w"]
        logits = batch["x"] @ w + params["b"]
        y = batch["y"]
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
