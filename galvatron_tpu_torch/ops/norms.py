"""Normalisation ops with fp32 math, cast back to the input dtype.

Port of ``galvatron_tpu/ops/norms.py``; the cast order is the reference's
(upcast, normalise and scale in fp32, one cast back), so bf16 results round
at the same place."""

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * scale.float() + bias.float()
    return y.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps)) * scale.float()
    return y.to(dtype)
