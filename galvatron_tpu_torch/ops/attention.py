"""Core attention with plain / flash dispatch.

Port of ``galvatron_tpu/ops/attention.py``. Layouts are (batch, seq, heads,
head_dim) ("BSNH") throughout; the flash kernel reads them in place.

The dispatch rule is the reference's, with "on TPU" replaced by "the
tensors are on CUDA": flash-eligible shapes (seq a multiple of 128,
head_dim >= 128, no bias or a key-padding bias) go to
`ops.flash_attention.flash_attention_fwd`, which launches the hand-written
kernel on CUDA tensors and computes the kernel's plain version on CPU
tensors. Everything else goes to `_xla_attention`, the plain einsum path
(named after the reference's XLA path it mirrors).
"""

from __future__ import annotations

from typing import Optional

import torch

from galvatron_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    SegmentIds,
    flash_attention_fwd,
)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand (B, S, n_kv, hd) to (B, S, n_kv*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, nkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, nkv, n_rep, hd).reshape(b, s, nkv * n_rep, hd)


def _xla_attention(q, k, v, *, causal: bool, sm_scale: float, bias=None, q_offset: int = 0):
    """Einsum attention with fp32 logits and softmax: products of the inputs
    accumulate in fp32 (the reference's preferred_element_type=float32), the
    probabilities are cast back to q's dtype for the value product.
    `q_offset` shifts the causal mask for cross-shard blocks."""
    sq, sk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * sm_scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def padding_bias_to_segment_ids(bias: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, Sk) additive 0/-1e9 key-padding bias -> int32 (B, Sk)
    segment ids: valid tokens 1, padded tokens 0. The kernel attends only
    within equal segments, which reproduces the padding semantics exactly on
    valid rows; padded QUERY rows attend within the pad segment instead —
    their outputs are garbage under both schemes and masked downstream."""
    return (bias[:, 0, 0, :] > -1e8).to(torch.int32).contiguous()


def core_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    impl: str = "auto",
    bias_type: str = "additive",
) -> torch.Tensor:
    """Multi-head attention on (B, S, nh, hd) tensors (kv may have fewer
    heads: GQA is expanded here). bias_type="key_padding" declares `bias` to
    be the (B, 1, 1, Sk) 0/-1e9 key-padding bias of a SELF-attention call;
    the flash path lowers it to segment ids. A generic additive bias keeps
    the plain path."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if bias_type == "key_padding" and q.shape[1] != k.shape[1]:
        raise ValueError(
            "bias_type='key_padding' is a SELF-attention contract (query and "
            "key padding assumed identical); got q_len=%d != kv_len=%d — use "
            "the default additive bias_type for cross-attention"
            % (q.shape[1], k.shape[1])
        )
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2] != 0:
            raise ValueError("q heads (%d) must be a multiple of kv heads (%d)"
                             % (q.shape[2], k.shape[2]))
        n_rep = q.shape[2] // k.shape[2]
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)
    seg_flash_ok = (
        bias is not None and bias_type == "key_padding"
        and bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1
        and bias.shape[3] == k.shape[1] and q.shape[1] == k.shape[1]
        and q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
    )
    if impl == "auto":
        ok_shapes = (
            q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0 and q.shape[3] >= 128
            and (bias is None or seg_flash_ok)
        )
        impl = "flash" if ok_shapes else "xla"
    if impl == "flash":
        if bias is not None and not seg_flash_ok:
            # the kernel takes no generic additive bias: keep the plain path
            # rather than silently dropping it
            return _xla_attention(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias)
        seg = None
        if bias is not None:
            ids = padding_bias_to_segment_ids(bias)
            seg = SegmentIds(q=ids, kv=ids)
        out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                     segment_ids=seg)
        return out
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias)
    raise ValueError("unknown attention impl %r" % impl)
