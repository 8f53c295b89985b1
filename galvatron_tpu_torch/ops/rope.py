"""Rotary position embeddings.

Port of ``galvatron_tpu/ops/rope.py``: per-token ``positions`` (B, S) rotate
(B, S, n_heads, head_dim) activations; fp32 math, result cast back to the
input dtype."""

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
                 interleaved: bool = False) -> torch.Tensor:
    """Rotate (B, S, n_heads, head_dim) by per-token positions (B, S).

    `interleaved=False` is the HF/LLaMA half-split convention
    (rotate_half); `interleaved=True` pairs adjacent dims (GPT-NeoX style)."""
    dtype = x.dtype
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * inv_freq  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    if interleaved:
        x1 = x32[..., 0::2]
        x2 = x32[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    else:
        x1 = x32[..., : head_dim // 2]
        x2 = x32[..., head_dim // 2:]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        out = torch.cat([r1, r2], dim=-1)
    return out.to(dtype)
