"""KV cache for serving.

Port of ``galvatron_tpu/serve/kv_cache.py`` for one device. The cache is a
dict of preallocated buffers — one (k, v) pair per layer, each shaped
``(max_slots, max_ctx, num_kv_heads, head_dim)`` — plus a ``lengths`` vector
of how many valid tokens each slot holds. Context lengths are bucketed into
pages: a request occupies ``bucket_pages(len) * page_size`` columns, and
serve/engine.py keeps one step function per page count, so the prefill
shapes stay multiples of ``page_size``.

Unlike the reference, whose buffers are immutable and donated, the port
updates the cache in place. The per-layer sharding specs come with the
tp/dp slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

# Matches models/base.padding_attn_bias and the plain attention path's
# additive masking contract: exp(-1e9) == 0.0 in fp32.
MASK_VALUE = -1e9


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static serving-cache geometry (fixed at engine build time)."""

    max_slots: int = 8  # max concurrent requests (cache rows)
    page_size: int = 16  # context-length quantum (bucket granularity)
    max_pages: int = 4  # max_ctx = page_size * max_pages

    @property
    def max_ctx(self) -> int:
        return self.page_size * self.max_pages

    def __post_init__(self):
        if self.max_slots < 1 or self.page_size < 1 or self.max_pages < 1:
            raise ValueError("KVCacheConfig fields must be >= 1: %s" % (self,))


def bucket_pages(length: int, page_size: int, max_pages: int) -> int:
    """Smallest page count whose context covers `length` tokens PLUS the one
    being decoded into it. Raises when the request cannot fit at all."""
    pages = -(-(int(length) + 1) // page_size)
    if pages > max_pages:
        raise ValueError(
            "request length %d needs %d pages > max_pages %d"
            % (length, pages, max_pages)
        )
    return max(1, pages)


def request_fits(kv_cfg: KVCacheConfig, prompt_len: int, max_new_tokens: int) -> bool:
    """Admission/replay feasibility: the prompt plus every token the request
    may still generate must fit in max_ctx."""
    return int(prompt_len) + int(max_new_tokens) <= kv_cfg.max_ctx


def init_kv_cache(cfg, kv_cfg: KVCacheConfig, device, dtype: Any = None) -> Dict[str, Any]:
    """Allocate the zeroed cache on `device`."""
    dtype = dtype or cfg.compute_dtype
    shape = (kv_cfg.max_slots, kv_cfg.max_ctx, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.num_layers)],
        "lengths": torch.zeros((kv_cfg.max_slots,), dtype=torch.int32, device=device),
    }


def length_bias(lengths: torch.Tensor, ctx: int,
                write_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive attention bias (B, 1, 1, ctx) admitting cache columns
    ``0 .. write_pos`` inclusive (default ``write_pos = lengths``: the decode
    step attends over everything cached so far plus the k/v it just wrote at
    position `lengths`). Carries BOTH causality and slot-length masking, so
    decode attention runs with causal=False."""
    if write_pos is None:
        write_pos = lengths
    cols = torch.arange(ctx, dtype=torch.int32, device=lengths.device)
    keep = cols[None, :] <= write_pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(keep, zero, MASK_VALUE)[:, None, None, :]


def kv_bytes_per_slot(cfg, max_ctx: int, dtype_bytes: int = 2) -> int:
    """Total KV bytes one request slot pins across all layers (k AND v)."""
    return 2 * cfg.num_layers * max_ctx * cfg.num_kv_heads * cfg.head_dim * dtype_bytes


def write_prompt_kv(
    cache: Dict[str, Any],
    kvs: List[Tuple[torch.Tensor, torch.Tensor]],
    slot: int,
    prompt_len: int,
) -> Dict[str, Any]:
    """Write a prefill's per-layer (1, S_bucket, nkv, hd) k/v blocks into row
    `slot`, columns [0, S_bucket), and set lengths[slot] = prompt_len, in
    place. Columns past prompt_len hold padding garbage; they are masked by
    length_bias until overwritten by decode steps."""
    for li, (k, v) in enumerate(kvs):
        s_b = k.shape[1]
        cache["k"][li][slot, :s_b] = k[0].to(cache["k"][li].dtype)
        cache["v"][li][slot, :s_b] = v[0].to(cache["v"][li].dtype)
    cache["lengths"][slot] = int(prompt_len)
    return cache
