"""Strategy-sharded KV cache for serving.

Port of ``galvatron_tpu/serve/kv_cache.py``. The cache is a dict of
preallocated buffers — one (k, v) pair per layer, each the rank's shard of
a ``(max_slots, max_ctx, num_kv_heads, head_dim)`` buffer — plus a
``lengths`` vector (every slot's, on every rank) of how many valid tokens
each slot holds. A layer's placement (`layer_kv_spec`) comes from its
searched strategy, as the reference's:

- slot dim: over the layer's dp axes (each data-parallel group owns a
  subset of the concurrent requests), when dp divides ``max_slots``, else
  replicated;
- kv-head dim: over the layer's tp axes, as the kv projection is, when tp
  divides the kv heads; else (GQA with fewer kv heads than tp) the
  projection is replicated and the rank holds the ONE kv head its query
  heads share (``models/base._kv_replicated``), where the reference keeps
  every kv head on every device;
- sequence ("page") dim: whole.

Ring context parallelism (cp>1) and Ulysses refuse (GLS014), in the
reference's words. Context lengths are bucketed into pages: a request
occupies ``bucket_pages(len) * page_size`` columns, and serve/engine.py
keeps one step function per page count, so the prefill shapes stay
multiples of ``page_size``.

Unlike the reference, whose buffers are immutable and donated, the port
updates the cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from galvatron_tpu_torch.parallel.mesh import layer_axes

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


def layer_kv_spec(hp, layer_idx: int, mesh, cfg, max_slots: Optional[int] = None):
    """Placement of one layer's (slots, ctx, nkv, hd) cache buffer, from
    that layer's strategy (a ``parallel.spec`` placement: one tuple of
    sub-axes per dim; `mesh` a ``RankMesh`` of `hp`, used for sizes only).
    `max_slots` (when known) gates the slot-dim dp sharding on
    divisibility: an off-grid concurrency replicates slots rather than
    refusing (the search only writes divisible ones; a hand-set
    ``--serve_max_concurrency`` may not)."""
    axes = layer_axes(hp, layer_idx)
    s = hp.layers[layer_idx]
    if s.cp > 1:
        raise ValueError(
            "layer %d: decode KV cache cannot realise ring context "
            "parallelism (cp=%d) — serve layouts require cp=1 (GLS014)"
            % (layer_idx, s.cp))
    if axes.ulysses:
        raise ValueError(
            "layer %d: Ulysses sequence parallelism repurposes the tp axes "
            "for sequence all-to-alls; a length-1 decode query cannot use "
            "them — serve layouts require sp=0 (GLS014)" % layer_idx)
    tp_ax = tuple(axes.tp)
    if tp_ax and cfg.num_kv_heads % max(mesh.size(tp_ax), 1):
        # GQA with fewer kv heads than the tp degree: the projection is
        # replicated over tp (the rank keeps the kv head it shares)
        tp_ax = ()
    dp_ax = tuple(axes.dp)
    if dp_ax and max_slots is not None and max_slots % max(mesh.size(dp_ax), 1):
        dp_ax = ()
    return (dp_ax, (), tp_ax, ())


@dataclasses.dataclass(frozen=True)
class LayerShard:
    """This rank's part of one layer's cache: the slot axes (the layer's dp
    axes, or none where the slots are replicated), its slots
    ``[start, start + slots)`` and its kv heads. The decode activation of
    the layer is placed as `act`: its slots over the slot axes."""

    slot_axes: Tuple[str, ...]
    start: int
    slots: int
    heads: int

    @property
    def act(self):
        return (self.slot_axes, (), ())

    def owns(self, slot: int) -> bool:
        return self.start <= slot < self.start + self.slots


def layer_shards(cfg, kv_cfg: KVCacheConfig, hp, mesh) -> List[LayerShard]:
    """Per layer, this rank's `LayerShard` under `hp` on `mesh`."""
    out = []
    for i in range(cfg.num_layers):
        slot_ax, _, head_ax, _ = layer_kv_spec(hp, i, mesh, cfg, kv_cfg.max_slots)
        n = mesh.size(slot_ax)
        tp = hp.layers[i].tp
        heads = cfg.num_kv_heads // mesh.size(head_ax) if head_ax or tp == 1 or \
            cfg.fused_qkv else 1
        out.append(LayerShard(slot_axes=slot_ax, start=mesh.shard_index(slot_ax) * (
            kv_cfg.max_slots // n), slots=kv_cfg.max_slots // n, heads=heads))
    return out


def init_kv_cache(cfg, kv_cfg: KVCacheConfig, device, dtype: Any = None,
                  shards: Optional[List[LayerShard]] = None) -> Dict[str, Any]:
    """Allocate the zeroed cache on `device`: whole, or under a strategy
    this rank's `shards` (`layer_shards`)."""
    dtype = dtype or cfg.compute_dtype

    def shape(i):
        if shards is None:
            return (kv_cfg.max_slots, kv_cfg.max_ctx, cfg.num_kv_heads, cfg.head_dim)
        return (shards[i].slots, kv_cfg.max_ctx, shards[i].heads, cfg.head_dim)

    return {
        "k": [torch.zeros(shape(i), dtype=dtype, device=device) for i in range(cfg.num_layers)],
        "v": [torch.zeros(shape(i), dtype=dtype, device=device) for i in range(cfg.num_layers)],
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
    shards: Optional[List[LayerShard]] = None,
) -> Dict[str, Any]:
    """Write a prefill's per-layer (1, S_bucket, nkv, hd) k/v blocks into row
    `slot`, columns [0, S_bucket), and set lengths[slot] = prompt_len, in
    place. Columns past prompt_len hold padding garbage; they are masked by
    length_bias until overwritten by decode steps. Under a strategy
    (`shards`) each layer's block is the rank's kv heads, and only the rank
    whose slot shard holds `slot` keeps it."""
    for li, (k, v) in enumerate(kvs):
        row = slot
        if shards is not None:
            if not shards[li].owns(slot):
                continue
            row = slot - shards[li].start
        s_b = k.shape[1]
        cache["k"][li][row, :s_b] = k[0].to(cache["k"][li].dtype)
        cache["v"][li][row, :s_b] = v[0].to(cache["v"][li].dtype)
    cache["lengths"][slot] = int(prompt_len)
    return cache
