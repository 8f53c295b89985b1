"""Generic decoder transformer: config, parameters, forward, loss and decode.

Port of ``galvatron_tpu/models/base.py`` for the token-input causal LM. The model's
parameters are ``nn.Module``s whose state-dict names are the reference's
param-tree paths (``embed.wte``, ``layers.<i>.ln1.scale``,
``layers.<i>.wqkv.kernel``, ``final_norm.scale``, ``lm_head.kernel``), with
the reference's head-major shapes:

- fused QKV ``wqkv.kernel (h, 3, nh, hd)``, or ``wq.kernel (h, nh, hd)`` +
  ``wkv.kernel (h, 2, nkv, hd)`` for GQA;
- ``wo.kernel (nh*hd, h)``, ``wi.kernel (h, 2, ffn)`` for SwiGLU (``(h,
  ffn)`` otherwise) and ``wo_mlp.kernel (ffn, h)``.

Forward code is plain functions over those modules and tensors, each the
counterpart of the reference function of the same name. Parameters are
kept in ``param_dtype`` (fp32) and cast to ``compute_dtype`` (bf16) at every
use, as in the reference. The port runs one device: there are no sharding
constraints. Per-layer remat follows the strategy (`run_layers`): the
reference's ``jax.checkpoint`` policies become ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.ops.attention import core_attention
from galvatron_tpu_torch.ops.norms import layer_norm, rms_norm
from galvatron_tpu_torch.ops.rope import apply_rotary


@dataclass
class TransformerConfig:
    hidden_size: int
    num_heads: int
    num_layers: int
    vocab_size: int
    max_seq_len: int = 2048
    num_kv_heads: Optional[int] = None
    ffn_hidden: Optional[int] = None
    head_dim: Optional[int] = None
    norm_type: str = "layernorm"  # layernorm | rmsnorm
    activation: str = "gelu"  # gelu | gelu_exact | relu | swiglu
    position_type: str = "learned"  # learned | rope | none
    causal: bool = True
    pre_norm: bool = True
    tie_embeddings: bool = True
    qkv_bias: bool = True
    mlp_bias: bool = True
    out_bias: bool = True
    layernorm_eps: float = 1e-5
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"
    init_std: float = 0.02
    # encoder-family extensions of the reference config; this slice ports
    # the token-input causal-LM path only and refuses the rest at init
    type_vocab_size: int = 0
    embed_norm: bool = False
    head_type: str = "lm"
    num_classes: int = 0
    pool_type: str = "cls"
    input_type: str = "tokens"
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    use_cls_token: bool = False

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.input_type == "patches":
            n_patches = (self.image_size // self.patch_size) ** 2
            self.max_seq_len = n_patches + (1 if self.use_cls_token else 0)

    @property
    def fused_qkv(self) -> bool:
        return self.num_kv_heads == self.num_heads

    @property
    def mlp_fan_in(self) -> tuple:
        """MLP input-projection kernel trailing dims: (2, ffn) for swiglu
        (fused gate+up) else (ffn,)."""
        return (2, self.ffn_hidden) if self.activation == "swiglu" else (self.ffn_hidden,)


# ================================================================= parameters
def _param(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


class Dense(nn.Module):
    """A projection: ``kernel`` (in, *out) and an optional ``bias`` (*out)."""

    def __init__(self, kernel_shape, bias_shape, cfg: TransformerConfig, device):
        super().__init__()
        self.kernel = _param(kernel_shape, cfg, device)
        self.bias = _param(bias_shape, cfg, device) if bias_shape is not None else None


class Norm(nn.Module):
    """``scale`` (h), plus ``bias`` (h) for layernorm."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.scale = _param((cfg.hidden_size,), cfg, device)
        self.bias = _param((cfg.hidden_size,), cfg, device) if cfg.norm_type == "layernorm" else None


class TransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        h, hd, nh, nkv = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        self.ln1 = Norm(cfg, device)
        self.ln2 = Norm(cfg, device)
        if cfg.fused_qkv:
            self.wqkv = Dense((h, 3, nh, hd), (3, nh, hd) if cfg.qkv_bias else None, cfg, device)
        else:
            self.wq = Dense((h, nh, hd), (nh, hd) if cfg.qkv_bias else None, cfg, device)
            self.wkv = Dense((h, 2, nkv, hd), (2, nkv, hd) if cfg.qkv_bias else None, cfg, device)
        self.wo = Dense((nh * hd, h), (h,) if cfg.out_bias else None, cfg, device)
        self.wi = Dense((h,) + cfg.mlp_fan_in, cfg.mlp_fan_in if cfg.mlp_bias else None, cfg, device)
        self.wo_mlp = Dense((cfg.ffn_hidden, h), (h,) if cfg.mlp_bias else None, cfg, device)


class Embed(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.wte = _param((cfg.vocab_size, cfg.hidden_size), cfg, device)
        self.wpe = (_param((cfg.max_seq_len, cfg.hidden_size), cfg, device)
                    if cfg.position_type == "learned" else None)


class TransformerLM(nn.Module):
    """The causal-LM parameter tree: ``embed``, ``layers``, ``final_norm``
    (pre-norm models) and ``lm_head`` (untied models)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        unsupported = [name for name, bad in (
            ("input_type=%r" % cfg.input_type, cfg.input_type != "tokens"),
            ("head_type=%r" % cfg.head_type, cfg.head_type != "lm"),
            ("type_vocab_size", cfg.type_vocab_size != 0),
            ("embed_norm", cfg.embed_norm),
        ) if bad]
        if unsupported:
            raise ValueError(
                "this slice of the port builds token-input causal LMs only; "
                "unsupported config fields: %s (the encoder families come with "
                "a later slice)" % ", ".join(unsupported))
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(TransformerLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, device) if cfg.pre_norm else None
        self.lm_head = (Dense((cfg.hidden_size, cfg.vocab_size), None, cfg, device)
                        if not cfg.tie_embeddings else None)


# ===================================================================== init
def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    # sample in fp32 (as the reference does), then cast to the param dtype
    t.copy_(torch.randn(t.shape, generator=gen, dtype=torch.float32, device=t.device) * std)


@torch.no_grad()
def init_model_params(cfg: TransformerConfig, generator: torch.Generator,
                      device=None) -> TransformerLM:
    """Fresh parameters with the reference's initializer scales: normal
    kernels at ``init_std`` (output projections at ``init_std /
    sqrt(2 * num_layers)``), unit norm scales, zero biases. The numbers
    differ from ``jax.random``'s; tests transplant weights instead
    (`tools/from_jax.py`)."""
    device = torch.device(device) if device is not None else generator.device
    model = TransformerLM(cfg, device)
    proj_std = cfg.init_std / math.sqrt(2 * cfg.num_layers)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif name.endswith("wo.kernel") or name.endswith("wo_mlp.kernel"):
            _normal_(p, proj_std, generator)
        else:
            _normal_(p, cfg.init_std, generator)
    return model


# ================================================================ primitives
def _norm(x, p: Norm, cfg: TransformerConfig):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, p.scale, cfg.layernorm_eps)
    return layer_norm(x, p.scale, p.bias, cfg.layernorm_eps)


def _proj(y: torch.Tensor, p: Dense, dtype) -> torch.Tensor:
    """``einsum("bs h, h ... -> bs ...")``: contract y's last dim with the
    kernel's first; the kernel is cast to the compute dtype at every use."""
    kernel = p.kernel.to(dtype)
    out = (y @ kernel.reshape(kernel.shape[0], -1)).reshape(*y.shape[:-1], *kernel.shape[1:])
    if p.bias is not None:
        out = out + p.bias.to(dtype)
    return out


def _activation(x, cfg: TransformerConfig):
    # swiglu is handled at the call site on the fused (..., 2, ffn) layout
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.activation == "gelu_exact":
        return F.gelu(x)
    if cfg.activation == "relu":
        return F.relu(x)
    raise ValueError(cfg.activation)


def qkv_projection(p: TransformerLayer, y: torch.Tensor, cfg: TransformerConfig, dtype):
    """y: (B, S, H) -> q (B, S, nh, hd), k/v (B, S, nkv, hd)."""
    if cfg.fused_qkv:
        qkv = _proj(y, p.wqkv, dtype)  # (B, S, 3, nh, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _proj(y, p.wq, dtype)
    kv = _proj(y, p.wkv, dtype)  # (B, S, 2, nkv, hd)
    return q, kv[:, :, 0], kv[:, :, 1]


def _mlp(p: TransformerLayer, x, cfg: TransformerConfig, dtype):
    residual = x
    y = _norm(x, p.ln2, cfg) if cfg.pre_norm else x
    wi_out = _proj(y, p.wi, dtype)
    if cfg.activation == "swiglu":
        hmid = F.silu(wi_out[:, :, 0]) * wi_out[:, :, 1]
    else:
        hmid = _activation(wi_out, cfg)
    x = residual + _proj(hmid, p.wo_mlp, dtype)
    if not cfg.pre_norm:
        x = _norm(x, p.ln2, cfg)
    return x


# ============================================================== layer forward
def layer_forward(
    p: TransformerLayer,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    *,
    attn_bias: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """One transformer block on (B, S, H) activations. ``return_kv``
    additionally returns this layer's post-rope (k, v) — the serving
    prefill's cache-write side outputs."""
    dtype = cfg.compute_dtype
    residual = x
    y = _norm(x, p.ln1, cfg) if cfg.pre_norm else x
    q, k, v = qkv_projection(p, y, cfg, dtype)
    if cfg.position_type == "rope":
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    # attn_bias is always padding_attn_bias output, so the flash path may
    # lower it to segment ids
    attn = core_attention(q, k, v, causal=cfg.causal, bias=attn_bias,
                          impl=cfg.attn_impl, bias_type="key_padding")
    attn = attn.reshape(attn.shape[0], attn.shape[1], cfg.num_heads * cfg.head_dim)
    x = residual + _proj(attn, p.wo, dtype)
    if not cfg.pre_norm:
        x = _norm(x, p.ln1, cfg)
    x = _mlp(p, x, cfg, dtype)
    if return_kv:
        return x, (k, v)
    return x


def _append_token_kv(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write the (B, 1, nkv, hd) `new` k/v at per-row position `idx` of the
    (B, S_cache, nkv, hd) cache, IN PLACE (the reference returns an updated
    copy and donates the old buffer to XLA instead). The index is clamped to
    the cache like ``lax.dynamic_update_slice`` clamps it, so an inactive
    slot whose frozen length lies past this bucket writes its masked garbage
    at the last column, as in the reference."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long().clamp(0, cache.shape[1] - 1)] = new[:, 0]


def decode_layer_forward(
    p: TransformerLayer,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    *,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    write_index: torch.Tensor,
    attn_bias: Optional[torch.Tensor] = None,
):
    """One transformer block for single-token decode over a preallocated KV
    cache. ``x``: (B, 1, H); ``k_cache`` / ``v_cache``: (B, S_cache, nkv, hd)
    views into the cache, updated in place; ``write_index``: (B,) the new
    token's position per slot. ``attn_bias`` (serve/kv_cache.length_bias)
    carries both causality and slot-length masking, so attention runs with
    causal=False. Every other op mirrors ``layer_forward``."""
    dtype = cfg.compute_dtype
    residual = x
    y = _norm(x, p.ln1, cfg) if cfg.pre_norm else x
    q, k, v = qkv_projection(p, y, cfg, dtype)
    if cfg.position_type == "rope":
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    _append_token_kv(k_cache, k.to(k_cache.dtype), write_index)
    _append_token_kv(v_cache, v.to(v_cache.dtype), write_index)
    attn = core_attention(q, k_cache.to(dtype), v_cache.to(dtype), causal=False,
                          bias=attn_bias, impl=cfg.attn_impl)
    attn = attn.reshape(attn.shape[0], attn.shape[1], cfg.num_heads * cfg.head_dim)
    x = residual + _proj(attn, p.wo, dtype)
    if not cfg.pre_norm:
        x = _norm(x, p.ln1, cfg)
    x = _mlp(p, x, cfg, dtype)
    return x, k_cache, v_cache


# ============================================================== model forward
def embed_tokens(p_embed: Embed, tokens: torch.Tensor, positions: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Token (+ learned position) embedding. The lookup happens before the
    cast to the compute dtype — the same values as the reference's
    cast-then-gather, without casting the whole table."""
    x = p_embed.wte[tokens].to(cfg.compute_dtype)
    if cfg.position_type == "learned":
        x = x + p_embed.wpe[positions].to(cfg.compute_dtype)
    return x


def lm_logits(params: TransformerLM, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.pre_norm:
        x = _norm(x, params.final_norm, cfg)
    if cfg.tie_embeddings:
        kernel = params.embed.wte.to(cfg.compute_dtype).t()
    else:
        kernel = params.lm_head.kernel.to(cfg.compute_dtype)
    return x @ kernel


def model_head(params: TransformerLM, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The family's output head. The port builds causal LMs only, so this
    is the reference's ``lm`` branch; the ``mlm`` and ``classification``
    heads come with the encoder families (TransformerLM refuses them)."""
    if cfg.head_type != "lm":
        raise ValueError("head_type %r is not ported yet" % cfg.head_type)
    return lm_logits(params, x, cfg)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32, loss-mask weighted. The label logit
    is taken with a masked sum over the vocab, as in the reference (whose
    form lets a vocab-sharded layout reduce shard-locally)."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.where(vocab_iota == labels[..., None], logits32, 0.0).sum(dim=-1)
    losses = lse - label_logit
    if loss_mask is None:
        return losses.mean()
    loss_mask = loss_mask.float()
    return (losses * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)


# ----------------------------------------------------------------- remat
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _remat(fn, policy: str):
    """The reference's ``jax.checkpoint`` with a saveable policy, as
    non-reentrant ``torch.utils.checkpoint``: "full" and "nothing_saveable"
    save nothing and recompute the layer in the backward; "dots_saveable"
    keeps the matrix-product outputs (aten mm/bmm/addmm) and recomputes the
    rest. The flash-attention kernel is no aten op, so it is recomputed
    under every policy, as jax recomputes the opaque ``pallas_call``."""
    if policy in ("full", "nothing_saveable"):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots_saveable":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(list(_DOTS)))
    raise ValueError("unknown remat policy %r" % policy)


def run_layers(
    params: TransformerLM,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    hp: Optional[HybridParallelConfig] = None,
    attn_bias: Optional[torch.Tensor] = None,
    collect_kv: bool = False,
):
    """The layer stack, one layer after another (the reference's scan over
    same-strategy layer runs is a Python loop here). With a strategy `hp`
    and gradients enabled, each layer runs under its own effective remat
    policy (``hp.layers[i].effective_remat_policy``, "none" runs it plainly).
    ``collect_kv=True`` additionally returns one post-rope (k, v) pair per
    layer, in layer order — the serving prefill's cache contents; that path
    is forward-only and never remats."""
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i, lp in enumerate(params.layers):
        if collect_kv:
            x, kv = layer_forward(lp, x, positions, cfg, attn_bias=attn_bias, return_kv=True)
            kvs.append(kv)
            continue
        policy = hp.layers[i].effective_remat_policy if hp is not None else "none"
        if policy == "none" or not torch.is_grad_enabled():
            x = layer_forward(lp, x, positions, cfg, attn_bias=attn_bias)
        else:
            x = _remat(lambda x_, _lp=lp: layer_forward(_lp, x_, positions, cfg,
                                                        attn_bias=attn_bias), policy)(x)
    if collect_kv:
        return x, kvs
    return x


def padding_attn_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 1/0 key-validity mask -> additive (B, 1, 1, S) bias."""
    return (1.0 - attn_mask.float())[:, None, None, :] * -1e9


def model_forward(
    params: TransformerLM,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor],
    cfg: TransformerConfig,
    attn_mask: Optional[torch.Tensor] = None,
    hp: Optional[HybridParallelConfig] = None,
) -> torch.Tensor:
    """Full forward to logits."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    x = embed_tokens(params.embed, tokens, positions, cfg)
    bias = padding_attn_bias(attn_mask) if attn_mask is not None else None
    x = run_layers(params, x, positions, cfg, hp, attn_bias=bias)
    return model_head(params, x, cfg)


def lm_loss_fn(params: TransformerLM, batch: dict, cfg: TransformerConfig,
               hp: Optional[HybridParallelConfig] = None) -> torch.Tensor:
    """batch: dict(tokens, positions, labels, loss_mask?, attn_mask?) ->
    scalar fp32 token-mean cross entropy."""
    logits = model_forward(params, batch["tokens"], batch["positions"], cfg,
                           attn_mask=batch.get("attn_mask"), hp=hp)
    return vocab_parallel_cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
