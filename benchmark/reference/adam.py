"""Adam (Kingma and Ba; betas 0.9, 0.999, eps 1e-8) on plain tensors."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t, self.m, self.v = 0, None, None

    def step(self, param: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """The parameter after one update with ``grad``."""
        if self.m is None:
            self.m, self.v = torch.zeros_like(grad), torch.zeros_like(grad)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * grad
        self.v = self.b2 * self.v + (1 - self.b2) * grad * grad
        m_hat = self.m / (1 - self.b1 ** self.t)
        denom = torch.sqrt(self.v) / math.sqrt(1 - self.b2 ** self.t) + self.eps
        return param - self.lr * m_hat / denom
