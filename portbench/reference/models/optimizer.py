"""Per-leaf Adam with torch semantics, as a functional update.

Parity: `vtgaussian_slam_tpu/models/optimizer.py`: p -= lr * m_hat /
(sqrt(v_hat) + eps), with a matching list of per-leaf learning rates
(scalars or broadcastable tensors). Leaves with lr == 0 still update their
moments, like torch.optim.Adam. eps is 1e-8 for tracking and 1e-15 for
mapping (the reference's mapping optimizer).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

TRACK_EPS = 1e-8
MAP_EPS = 1e-15


@dataclass
class AdamState:
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int


def adam_init(params: list[torch.Tensor]) -> AdamState:
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params], count=0)


@torch.no_grad()
def adam_step(params: list[torch.Tensor], grads: list[torch.Tensor],
              state: AdamState, lrs: list, b1: float = 0.9,
              b2: float = 0.999, eps: float = TRACK_EPS
              ) -> tuple[list[torch.Tensor], AdamState]:
    """One Adam step; returns new parameter tensors and state."""
    count = state.count + 1
    t = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    mu = [b1 * m + (1 - b1) * g for m, g in zip(state.mu, grads)]
    nu = [b2 * v + (1 - b2) * g * g for v, g in zip(state.nu, grads)]
    new = [p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
           for p, m, v, lr in zip(params, mu, nu, lrs)]
    return new, AdamState(mu=mu, nu=nu, count=count)
