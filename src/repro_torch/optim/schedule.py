"""LR schedules, as the JAX package's: cosine (the default) and WSD
(warmup-stable-decay, MiniCPM).  Each returns ``lr(step)``, an fp32
scalar tensor (on the CPU) computed as JAX computes it."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(_f32(math.pi) * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 min_ratio: float = 0.01):
    """MiniCPM warmup-stable-decay: linear warmup → constant → exp decay."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        in_decay = torch.clip((step - warmup - stable) / max(decay, 1),
                              0.0, 1.0)
        dec = peak_lr * torch.pow(_f32(min_ratio), in_decay)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       _f32(peak_lr), dec))
    return lr
