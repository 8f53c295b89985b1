"""Generic transformer: config, parameters, forward, loss and decode.

Port of ``galvatron_tpu/models/base.py``: the token-input causal LM (GPT,
LLaMA), the bidirectional post-norm encoder with token types, an embedding
norm and an MLM head (BERT), and the patch-input encoder with a cls token
and a classification head (ViT). The model's parameters are ``nn.Module``s
whose state-dict names are the reference's param-tree paths (``embed.wte``,
``embed.tte``, ``embed.patch.kernel``, ``embed.cls_token``,
``embed.norm.scale``, ``layers.<i>.ln1.scale``, ``layers.<i>.wqkv.kernel``,
``final_norm.scale``, ``head.transform.kernel``, ``head.bias``,
``lm_head.kernel``), with the reference's head-major shapes:

- fused QKV ``wqkv.kernel (h, 3, nh, hd)``, or ``wq.kernel (h, nh, hd)`` +
  ``wkv.kernel (h, 2, nkv, hd)`` for GQA;
- ``wo.kernel (nh*hd, h)``, ``wi.kernel (h, 2, ffn)`` for SwiGLU (``(h,
  ffn)`` otherwise) and ``wo_mlp.kernel (ffn, h)``.

Forward code is plain functions over those modules and tensors, each the
counterpart of the reference function of the same name. Parameters are
kept in ``param_dtype`` (fp32) and cast to ``compute_dtype`` (bf16) at every
use, as in the reference. Per-layer remat follows the strategy
(`run_layers`): the reference's ``jax.checkpoint`` policies become
``torch.utils.checkpoint``.

Under a strategy (`build_layouts`), each rank holds the shard of every
parameter that `model_param_specs` places on it (the reference's
``layer_param_specs`` / ``model_param_specs``, entry for entry) and the
forward runs on the rank's shards: `run_layers` re-lays the activation
wherever ``act_spec`` changes between layers, a layer runs Megatron TP (with
Megatron-SP) over its tp group (`parallel.tensor_parallel`), ZeRO-3 layers
gather their weights over their dp group at entry (again in the remat
replay) and reduce-scatter the gradients, and the embedding, the head and
the cross entropy are vocab-parallel over the vocab tp group. A layer with
cp > 1 runs ring attention over its cp group (``ops/ring_attention.py``),
a Ulysses layer its attention between two all-to-alls over tp, and vocab
sp / vocab cp shard the embedding's and the loss's sequence. Where the
reference states a sharding constraint and lets XLA insert the collective,
the port calls it (`parallel.comm`).
"""

from __future__ import annotations

import dataclasses
import math
import types
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.ops.attention import core_attention, padding_bias_to_segment_ids, repeat_kv
from galvatron_tpu_torch.ops.norms import layer_norm, rms_norm
from galvatron_tpu_torch.ops.ring_attention import P2PRing, RingTransport, ring_attention
from galvatron_tpu_torch.ops.rope import apply_rotary
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel import spec as S
from galvatron_tpu_torch.parallel import tensor_parallel as T
from galvatron_tpu_torch.parallel.mesh import LayerAxes, RankMesh, layer_axes, vocab_axes


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
    # encoder-family extensions (BERT, ViT)
    type_vocab_size: int = 0  # token-type embeddings
    embed_norm: bool = False  # norm after the embedding sum
    head_type: str = "lm"  # lm | mlm | classification
    num_classes: int = 0
    pool_type: str = "cls"  # cls | mean (classification pooling)
    input_type: str = "tokens"  # tokens | patches
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
    """Token input: ``wte``, ``wpe`` for learned positions, ``tte`` for
    token types; patch input: ``patch`` (a dense on patchified pixels),
    ``wpe`` and ``cls_token``; either with ``norm`` under `embed_norm`. The
    last pipeline stage's copy of a tied table holds ``wte`` alone (`first`
    False)."""

    def __init__(self, cfg: TransformerConfig, device, first: bool = True):
        super().__init__()
        h = cfg.hidden_size
        self.wte = self.wpe = self.tte = self.patch = self.cls_token = self.norm = None
        if cfg.input_type == "patches":
            dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
            self.patch = Dense((dim, h), (h,), cfg, device)
            self.wpe = _param((cfg.max_seq_len, h), cfg, device)
            if cfg.use_cls_token:
                self.cls_token = _param((h,), cfg, device)
        else:
            self.wte = _param((cfg.vocab_size, h), cfg, device)
            if not first:
                return
            if cfg.position_type == "learned":
                self.wpe = _param((cfg.max_seq_len, h), cfg, device)
            if cfg.type_vocab_size:
                self.tte = _param((cfg.type_vocab_size, h), cfg, device)
        if cfg.embed_norm:
            self.norm = Norm(cfg, device)


class MLMHead(nn.Module):
    """BERT's MLM head: ``transform`` (h, h) dense, ``norm``, and the
    decoder's ``bias`` over the vocab (its kernel is the tied table, or
    ``lm_head`` when untied)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.transform = Dense((cfg.hidden_size, cfg.hidden_size), (cfg.hidden_size,), cfg,
                               device)
        self.norm = Norm(cfg, device)
        self.bias = _param((cfg.vocab_size,), cfg, device)


class TransformerLM(nn.Module):
    """The model's parameter tree: ``embed``, ``layers``, ``final_norm``
    (pre-norm models), ``head`` (the MLM head, or the classification
    dense) and ``lm_head`` (untied lm/mlm heads).

    A pipeline stage holds a part of it (`stage_model`): the layers of
    `layer_ids` (a ``ModuleDict`` keyed by the global index, so the
    state-dict names stay ``layers.<i>...``), the embedding when `first`,
    the final norm and the heads when `last`, and on the last stage of a
    tied model its own copy of ``embed.wte`` for the head."""

    def __init__(self, cfg: TransformerConfig, device, layer_ids=None, first: bool = True,
                 last: bool = True):
        super().__init__()
        if cfg.head_type not in ("lm", "mlm", "classification"):
            raise ValueError("unknown head_type %r" % cfg.head_type)
        if cfg.input_type not in ("tokens", "patches"):
            raise ValueError("unknown input_type %r" % cfg.input_type)
        vocab_head = cfg.head_type in ("lm", "mlm")
        tied_copy = last and vocab_head and cfg.tie_embeddings and cfg.input_type == "tokens"
        self.embed = Embed(cfg, device, first=first) if first or tied_copy else None
        if layer_ids is None:
            self.layers = nn.ModuleList(TransformerLayer(cfg, device)
                                        for _ in range(cfg.num_layers))
        else:
            self.layers = nn.ModuleDict({str(i): TransformerLayer(cfg, device) for i in layer_ids})
        self.final_norm = Norm(cfg, device) if cfg.pre_norm and last else None
        self.head = None
        if last and cfg.head_type == "mlm":
            self.head = MLMHead(cfg, device)
        elif last and cfg.head_type == "classification":
            self.head = Dense((cfg.hidden_size, cfg.num_classes), (cfg.num_classes,), cfg, device)
        self.lm_head = (Dense((cfg.hidden_size, cfg.vocab_size), None, cfg, device)
                        if vocab_head and not cfg.tie_embeddings and last else None)


def stage_model(cfg: TransformerConfig, hp: HybridParallelConfig, stage: int,
                device) -> TransformerLM:
    """The part of the model pipeline stage `stage` of `hp` holds."""
    return TransformerLM(cfg, device, layer_ids=hp.layers_of_stage(stage), first=stage == 0,
                         last=stage == hp.pp - 1)


def layer_items(params) -> List[Tuple[int, Any]]:
    """(global layer index, layer) of a whole model or of a stage's part."""
    if isinstance(params.layers, nn.ModuleDict):
        return [(int(k), v) for k, v in params.layers.items()]
    return list(enumerate(params.layers))


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
    for name, p in model.named_parameters():
        init_param_(name, p, cfg, generator)
    return model


def init_param_(name: str, p: torch.Tensor, cfg: TransformerConfig,
                generator: torch.Generator) -> None:
    """The initializer of the parameter `name`, drawn into `p` (full shape);
    `init_model_params` calls it in ``named_parameters`` order."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        p.fill_(1.0)
    elif leaf in ("bias", "cls_token"):
        p.zero_()
    elif name.endswith("wo.kernel") or name.endswith("wo_mlp.kernel"):
        _normal_(p, cfg.init_std / math.sqrt(2 * cfg.num_layers), generator)
    else:
        _normal_(p, cfg.init_std, generator)


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


def _row_proj(y: torch.Tensor, p: Dense, dtype, tp: Optional[T.TPContext]) -> torch.Tensor:
    """A row-parallel projection: the partial products are reduced over tp
    (`tensor_parallel.exit_row`) before the bias, which is added once."""
    out = T.exit_row(y @ p.kernel.to(dtype), tp)
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


def qkv_projection(p: TransformerLayer, y: torch.Tensor, cfg: TransformerConfig, dtype,
                   tp: Optional[T.TPContext] = None):
    """y: (B, S, H) -> q (B, S, nh, hd), k/v (B, S, nkv, hd); under TP the
    rank's head shard (nh/tp, and nkv/tp or the one kv head it shares)."""
    if cfg.fused_qkv:
        qkv = _proj(y, p.wqkv, dtype)  # (B, S, 3, nh, hd)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _proj(y, p.wq, dtype)
    kv = _proj(y, p.wkv, dtype)  # (B, S, 2, nkv, hd)
    if tp is not None and tp.kv_head is not None:
        kv = kv[:, :, :, tp.kv_head:tp.kv_head + 1]
    return q, kv[:, :, 0], kv[:, :, 1]


def _mlp(p: TransformerLayer, x, cfg: TransformerConfig, dtype,
         tp: Optional[T.TPContext] = None):
    residual = x
    y = _norm(x, p.ln2, cfg) if cfg.pre_norm else x
    wi_out = _proj(T.enter_column(y, tp), p.wi, dtype)
    if cfg.activation == "swiglu":
        hmid = F.silu(wi_out[:, :, 0]) * wi_out[:, :, 1]
    else:
        hmid = _activation(wi_out, cfg)
    x = residual + _row_proj(hmid, p.wo_mlp, dtype, tp)
    if not cfg.pre_norm:
        x = _norm(x, p.ln2, cfg)
    return x


# ============================================================== layer forward
@dataclass(frozen=True)
class SeqContext:
    """How a layer's attention sees a sharded sequence: ``ulysses`` is the
    tp group of a Ulysses layer (all-to-all seq -> heads before attention,
    heads -> seq after it), ``ring`` the transport of its cp ring, and
    ``chunks`` the number of chunks of the batch's zigzag layout (2 *
    max_cp of them over the whole sequence) that the attention's sequence
    holds (1 outside zigzag)."""

    ulysses: Any = None
    ring: Optional[RingTransport] = None
    cp_mode: str = "zigzag"
    chunks: int = 1


def zigzag_local_order(m: int) -> List[int]:
    """The order that turns a sequence of `m` chunks of a zigzag layout
    into the zigzag layout of its own degree: a rank's chunks (a, 2M-1-a,
    a+1, 2M-2-a, ...) of a 2M-chunk zigzag are the chunks it holds under a
    zigzag of fewer ranks, taken in the order [0, 2, .., m-2, m-1, .., 3,
    1]; on one rank (m = 2M) that is the natural order."""
    return list(range(0, m, 2)) + list(range(m - 1, 0, -2))


def _take_chunks(x: torch.Tensor, order: List[int], dim: int) -> torch.Tensor:
    """`x` with its `dim` cut into len(order) chunks, taken in `order`."""
    return torch.cat([x.chunk(len(order), dim)[i] for i in order], dim)


def _attention(q, k, v, cfg: TransformerConfig, attn_bias, seq: Optional[SeqContext]):
    """Attention on (B, s, heads, hd) tensors that cover the sequence of a
    rank's cp shard. Where the batch's zigzag layout cuts that sequence
    into more chunks than the layer's own zigzag (a layer with a smaller
    cp than another layer's, or none), q/k/v and the bias are first put in
    the order of the layer's own zigzag (`zigzag_local_order`), so that a
    causal mask by index, and the ring's blocks, follow the true positions,
    and the output is put back. (The reference masks by index outside the
    ring, which is wrong on a zigzag batch.) A bidirectional layer needs no
    such order: no query's output depends on where its keys sit. Under cp
    the ring runs on the flash kernels; otherwise `core_attention`."""
    order = (zigzag_local_order(seq.chunks) if cfg.causal and seq is not None
             and seq.chunks > 2 else None)
    if order is not None:
        q, k, v = (_take_chunks(t, order, 1) for t in (q, k, v))
        if attn_bias is not None:
            attn_bias = _take_chunks(attn_bias, order, 3)
    if seq is not None and seq.ring is not None:
        ids = padding_bias_to_segment_ids(attn_bias) if attn_bias is not None else None
        attn = ring_attention(q, k, v, transport=seq.ring, mode=seq.cp_mode, causal=cfg.causal,
                              q_segment_ids=ids, kv_segment_ids=ids)
    else:
        # attn_bias is always padding_attn_bias output, so the flash path
        # may lower it to segment ids
        attn = core_attention(q, k, v, causal=cfg.causal, bias=attn_bias, impl=cfg.attn_impl,
                              bias_type="key_padding")
    if order is not None:
        attn = _take_chunks(attn, sorted(range(len(order)), key=order.__getitem__), 1)
    return attn


def layer_forward(
    p: TransformerLayer,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    *,
    attn_bias: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    tp: Optional[T.TPContext] = None,
    seq: Optional[SeqContext] = None,
):
    """One transformer block on (B, S, H) activations (B/dp and S/cp of
    them under a layout, and S/tp more under Megatron-SP or Ulysses;
    `positions` and `attn_bias` cover the sequence attention runs on:
    S/cp). Under Ulysses (`seq.ulysses`) the weights are dense: q/k/v of
    the rank's sequence shard go through an all-to-all to the whole
    (cp-local) sequence and heads/tp, rope and attention run there, and the
    output comes back before ``wo``. ``return_kv`` additionally returns
    this layer's post-rope (k, v) — the serving prefill's cache-write side
    outputs."""
    dtype = cfg.compute_dtype
    residual = x
    y = _norm(x, p.ln1, cfg) if cfg.pre_norm else x
    q, k, v = qkv_projection(p, T.enter_column(y, tp), cfg, dtype, tp)
    ulysses = seq.ulysses if seq is not None else None
    if ulysses is not None:
        if k.shape[2] % torch.distributed.get_world_size(ulysses):
            # fewer kv heads than ranks: expand them before the split
            k, v = (repeat_kv(t, q.shape[2] // k.shape[2]) for t in (k, v))
        q, k, v = (comm.seq_to_heads(t, ulysses) for t in (q, k, v))
    if cfg.position_type == "rope":
        # per token and head: the same after the all-to-all as before it
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    if return_kv and seq is not None and seq.ring is not None:
        raise ValueError("return_kv is unsupported under ring context parallelism (cp>1): "
                         "the ring never holds a layer's full k/v; serve refuses cp "
                         "layouts (GLS014)")
    attn = _attention(q, k, v, cfg, attn_bias, seq)
    if ulysses is not None:
        attn = comm.heads_to_seq(attn, ulysses)
    attn = attn.reshape(attn.shape[0], attn.shape[1], attn.shape[2] * attn.shape[3])
    x = residual + _row_proj(attn, p.wo, dtype, tp)
    if not cfg.pre_norm:
        x = _norm(x, p.ln1, cfg)
    x = _mlp(p, x, cfg, dtype, tp)
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
    tp: Optional[T.TPContext] = None,
):
    """One transformer block for single-token decode over a preallocated KV
    cache. ``x``: (B, 1, H); ``k_cache`` / ``v_cache``: (B, S_cache, nkv, hd)
    views into the cache, updated in place; ``write_index``: (B,) the new
    token's position per slot. ``attn_bias`` (serve/kv_cache.length_bias)
    carries both causality and slot-length masking, so attention runs with
    causal=False. Every other op mirrors ``layer_forward``.

    Under a layer's layout (`tp`, without Megatron-SP: one token has no
    sequence to shard) the rows are the rank's slot shard, the qkv
    projection is column-parallel (the rank's heads; with GQA and fewer kv
    heads than tp, the one kv head its query heads share), the cache views
    hold the rank's kv heads, and ``wo`` and the MLP are row-parallel, as
    the reference's decode head layout (slots on the batch axes, kv heads on
    tp)."""
    dtype = cfg.compute_dtype
    residual = x
    y = _norm(x, p.ln1, cfg) if cfg.pre_norm else x
    q, k, v = qkv_projection(p, T.enter_column(y, tp), cfg, dtype, tp)
    if cfg.position_type == "rope":
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    _append_token_kv(k_cache, k.to(k_cache.dtype), write_index)
    _append_token_kv(v_cache, v.to(v_cache.dtype), write_index)
    attn = core_attention(q, k_cache.to(dtype), v_cache.to(dtype), causal=False,
                          bias=attn_bias, impl=cfg.attn_impl)
    attn = attn.reshape(attn.shape[0], attn.shape[1], attn.shape[2] * attn.shape[3])
    x = residual + _row_proj(attn, p.wo, dtype, tp)
    if not cfg.pre_norm:
        x = _norm(x, p.ln1, cfg)
    x = _mlp(p, x, cfg, dtype, tp)
    return x, k_cache, v_cache


# ================================================================== layouts
# parameters that are replicated over tp but computed from sequence shards
# under Megatron-SP, so their gradients are partial over tp
_SP_PARTIAL = ("ln1.scale", "ln1.bias", "ln2.scale", "ln2.bias", "wo.bias", "wo_mlp.bias")
_KV_REPLICATED = ("wkv.kernel", "wkv.bias")


@dataclass(frozen=True)
class ParamLayout:
    """Where one parameter lives under a strategy: `spec` places the shard
    a rank stores; ZeRO-3 shards dim `z3_dim` over `dp` and gathers it at
    use; `dp` are the axes of its layer's data parallelism (ZeRO's group);
    after the backward its gradient is a partial sum over `partial` (dp
    for different data, cp for different sequence shards, plus tp where a
    tp-replicated parameter saw sequence shards: every parameter of a
    Ulysses layer, the SP-replicated ones of a Megatron-SP layer, or a
    replicated GQA kv projection that saw one head)."""

    spec: S.Spec
    z3_dim: Optional[int]
    dp: Tuple[str, ...]
    partial: Tuple[str, ...]
    zero_opt: bool


def _kv_replicated(cfg: TransformerConfig, tp: int) -> bool:
    """GQA with fewer kv heads than the tp degree: the kv projection is
    replicated over tp and each rank uses the one kv head its query heads
    share (the reference's GLS007 allows tp % num_kv_heads == 0)."""
    if cfg.fused_qkv or tp == 1 or cfg.num_kv_heads % tp == 0:
        return False
    if tp % cfg.num_kv_heads:
        raise ValueError("num_kv_heads=%d neither divides nor is divided by tp=%d"
                         % (cfg.num_kv_heads, tp))
    return True


def _layer_placements(cfg: TransformerConfig, ax: LayerAxes,
                      kv_rep: bool) -> Dict[str, Tuple[S.Spec, Optional[int]]]:
    """(placement, the dim ZeRO-3 shards) per parameter of a layer, from
    the column/row kernel builders: the multi-dim kernels keep the builders'
    (in, out) entries on their first and head/ffn dims."""
    (z3, tp), row = S.col_kernel_spec(ax), S.row_kernel_spec(ax)
    r1 = (S.replicated_1d_spec(ax), 0)
    kvtp = () if kv_rep else tp
    out = {"ln1.scale": r1, "ln2.scale": r1}
    if cfg.norm_type != "rmsnorm":
        out.update({"ln1.bias": r1, "ln2.bias": r1})
    if cfg.fused_qkv:
        out["wqkv.kernel"] = ((z3, (), tp, ()), 0)
        if cfg.qkv_bias:
            out["wqkv.bias"] = (((), tp, ()), None)
    else:
        out["wq.kernel"] = ((z3, tp, ()), 0)
        out["wkv.kernel"] = ((z3, (), kvtp, ()), 0)
        if cfg.qkv_bias:
            out["wq.bias"] = ((tp, ()), None)
            out["wkv.bias"] = (((), kvtp, ()), None)
    out["wo.kernel"] = (row, 1)
    if cfg.out_bias:
        out["wo.bias"] = r1
    if cfg.activation == "swiglu":
        out["wi.kernel"] = ((z3, (), tp), 0)
        if cfg.mlp_bias:
            out["wi.bias"] = (((), tp), None)
    else:
        out["wi.kernel"] = ((z3, tp), 0)
        if cfg.mlp_bias:
            out["wi.bias"] = (S.col_bias_spec(ax), None)
    out["wo_mlp.kernel"] = (row, 1)
    if cfg.mlp_bias:
        out["wo_mlp.bias"] = r1
    return out


def _vocab_placements(cfg: TransformerConfig, ax: LayerAxes) -> Dict[str, Tuple[S.Spec, Optional[int]]]:
    """The reference's ``model_param_specs`` entries outside the layers."""
    r1 = (S.replicated_1d_spec(ax), 0)
    dense2 = (S.replicated_spec(2), None)

    def norm(prefix):
        out[prefix + ".scale"] = r1
        if cfg.norm_type != "rmsnorm":
            out[prefix + ".bias"] = r1

    out: Dict[str, Tuple[S.Spec, Optional[int]]] = {}
    if cfg.input_type == "patches":
        out.update({"embed.patch.kernel": dense2, "embed.patch.bias": r1, "embed.wpe": dense2})
        if cfg.use_cls_token:
            out["embed.cls_token"] = r1
    else:
        # vocab-dense under vocab sp, where ZeRO-3 shards the vocab
        out["embed.wte"] = (S.vocab_embed_spec(ax), 0 if ax.ulysses else 1)
        if cfg.position_type == "learned":
            out["embed.wpe"] = dense2
        if cfg.type_vocab_size:
            out["embed.tte"] = dense2
    if cfg.embed_norm:
        norm("embed.norm")
    if cfg.pre_norm:
        norm("final_norm")
    vocab_col = None if ax.ulysses else ax.tp
    if cfg.head_type == "classification":
        out.update({"head.kernel": dense2, "head.bias": (S.replicated_spec(1), None)})
    elif cfg.head_type == "mlm":
        out.update({"head.transform.kernel": dense2, "head.transform.bias": r1})
        norm("head.norm")
        # the decoder bias follows the vocab-parallel logits
        out["head.bias"] = (S.spec(vocab_col), None)
    if cfg.head_type in ("lm", "mlm") and not cfg.tie_embeddings:
        # column-parallel over the vocab (vocab-parallel logits); dense
        # under vocab sp, as ``logits_spec``
        out["lm_head.kernel"] = (S.spec(None, vocab_col), None)
    return out


# vocab-layer parameters that run on the sequence shards of Megatron-SP
# (before the head's gather, or after the embedding's slice), so their
# gradients are partial over tp there
_VOCAB_SP_PARTIAL = ("embed.wpe", "embed.tte", "embed.norm.scale", "embed.norm.bias",
                     "embed.patch.kernel", "embed.patch.bias", "embed.cls_token",
                     "final_norm.scale", "final_norm.bias", "head.transform.kernel",
                     "head.transform.bias", "head.norm.scale", "head.norm.bias")


def _param_layout(spec: S.Spec, z3_dim: Optional[int], ax: LayerAxes,
                  partial_tp: bool) -> ParamLayout:
    partial = tuple(ax.dp) + tuple(ax.cp) + (tuple(ax.tp) if partial_tp or ax.ulysses else ())
    return ParamLayout(spec=spec, z3_dim=z3_dim if ax.zero3 else None, dp=tuple(ax.dp),
                       partial=tuple(sorted(partial)), zero_opt=ax.zero_opt)


def layer_param_layouts(cfg: TransformerConfig, ax: LayerAxes, tp_degree: int) -> Dict[str, ParamLayout]:
    """ParamLayout per parameter of one layer, keyed by its name within the
    layer (``wqkv.kernel``...); the reference's ``layer_param_specs``
    (Ulysses layers keep dense weights)."""
    kv_rep = _kv_replicated(cfg, 1 if ax.ulysses else tp_degree)
    return {name: _param_layout(spec, z3_dim, ax, (ax.megatron_sp and name in _SP_PARTIAL)
                                or (kv_rep and name in _KV_REPLICATED))
            for name, (spec, z3_dim) in _layer_placements(cfg, ax, kv_rep).items()}


def model_param_layouts(cfg: TransformerConfig, hp: HybridParallelConfig) -> Dict[str, ParamLayout]:
    """ParamLayout per state-dict name of the whole model: the layers' and
    the vocab layers' (embedding, final norm, untied head), which run under
    the vocab axes (vocab_tp, embed_sdp)."""
    vax = vocab_axes(hp)
    out = {name: _param_layout(spec, z3_dim, vax, vax.megatron_sp and name in _VOCAB_SP_PARTIAL)
           for name, (spec, z3_dim) in _vocab_placements(cfg, vax).items()}
    for i in range(cfg.num_layers):
        for name, pl in layer_param_layouts(cfg, layer_axes(hp, i), hp.layers[i].tp).items():
            out["layers.%d.%s" % (i, name)] = pl
    return out


def model_param_specs(cfg: TransformerConfig, hp: HybridParallelConfig) -> Dict[str, S.Spec]:
    """The placement of every parameter (the reference's PartitionSpecs)."""
    return {n: pl.spec for n, pl in model_param_layouts(cfg, hp).items()}


@dataclass
class Layout:
    """How one layer, or the vocab layers, run on this rank: the (Megatron)
    tp context, its sequence context (Ulysses, the cp ring), the placement
    of the activations it takes and returns (``act``) and of its (batch,
    seq) side inputs (``side``: a layer's positions and masks; the vocab
    layers' tokens, labels and masks), its dp group, for the vocab layers
    the group whose ranks hold the other tokens of the global batch
    (``token_group``: dp and the sequence shards of ``side``, over which
    the loss's token count and shares are summed), and the dims its ZeRO-3
    parameters gather over dp (keyed by name relative to the module the
    forward reads)."""

    mesh: RankMesh
    axes: LayerAxes
    tp: T.TPContext
    act: S.Spec
    dp_group: Any
    zero3: Dict[str, int]
    side: S.Spec = ((), ())
    token_group: Any = None
    seq: Optional[SeqContext] = None


@dataclass
class ModelLayouts:
    vocab: Layout
    layers: List[Layout]


def _tp_context(mesh: RankMesh, ax: LayerAxes, cfg: TransformerConfig, tp_degree: int,
                kv: bool = True) -> T.TPContext:
    if ax.ulysses:
        # dense weights: no Megatron collective (the all-to-alls are the
        # sequence context's)
        return T.TPContext(group=None, size=1, index=0)
    index = mesh.index(ax.tp)
    kv_head = None
    if kv and _kv_replicated(cfg, tp_degree):
        kv_head = index // (tp_degree // cfg.num_kv_heads)
    return T.TPContext(group=mesh.group_for(ax.tp), size=mesh.size(ax.tp), index=index,
                       sequence_parallel=ax.megatron_sp, kv_head=kv_head)


def _seq_context(mesh: RankMesh, ax: LayerAxes, hp: HybridParallelConfig) -> SeqContext:
    cp = mesh.size(ax.cp)
    zigzag = hp.cp_mode == "zigzag" and hp.max_cp > 1
    return SeqContext(ulysses=mesh.group_for(ax.tp) if ax.ulysses else None,
                      ring=P2PRing(mesh.group_for(ax.cp)) if cp > 1 else None,
                      cp_mode=hp.cp_mode, chunks=2 * hp.max_cp // cp if zigzag else 1)


def make_layout(cfg, hp: HybridParallelConfig, mesh: RankMesh, pls: Dict[str, ParamLayout],
                ax: LayerAxes, prefix: str, tp_degree: int, kv: bool = True,
                vocab: bool = False) -> Layout:
    """The runtime layout of one layer (its parameters named `prefix`...
    in `pls`), or of the vocab layers (`vocab`, prefix ""; the caller drops
    the layers' entries from its ZeRO-3 dims)."""
    z3 = {n[len(prefix):]: pl.z3_dim for n, pl in pls.items()
          if n.startswith(prefix) and pl.z3_dim is not None}
    side = S.token_spec(ax) if vocab else S.side_spec(ax)
    tokens = tuple(sorted(side[0] + side[1], key=mesh.names.index))
    return Layout(mesh=mesh, axes=ax, tp=_tp_context(mesh, ax, cfg, tp_degree, kv),
                  act=S.act_spec(ax), dp_group=mesh.group_for(ax.dp), zero3=z3,
                  side=side, token_group=mesh.group_for(tokens) if vocab else None,
                  seq=None if vocab else _seq_context(mesh, ax, hp))


def build_layouts(cfg: TransformerConfig, hp: HybridParallelConfig, mesh: RankMesh) -> ModelLayouts:
    """The runtime layout of every layer and of the vocab layers on this
    rank (needs `mesh`'s process groups)."""
    pls = model_param_layouts(cfg, hp)
    vocab = make_layout(cfg, hp, mesh, pls, vocab_axes(hp), "", hp.vocab_tp, kv=False,
                        vocab=True)
    vocab.zero3 = {n: d for n, d in vocab.zero3.items() if not n.startswith("layers.")}
    layers = [make_layout(cfg, hp, mesh, pls, layer_axes(hp, i), "layers.%d." % i,
                          hp.layers[i].tp) for i in range(cfg.num_layers)]
    return ModelLayouts(vocab=vocab, layers=layers)


def serve_layouts(layouts: ModelLayouts) -> ModelLayouts:
    """The layouts a serve step runs under: the same groups, ZeRO-3 dims
    and head shards, with Megatron-SP off (a prefill's one request and a
    decode step's one token per slot are whole on every tp rank; the
    reductions are all-reduces, the same sums)."""
    def plain(lay: Layout) -> Layout:
        return dataclasses.replace(lay, tp=dataclasses.replace(lay.tp, sequence_parallel=False))
    return ModelLayouts(vocab=plain(layouts.vocab), layers=[plain(x) for x in layouts.layers])


def gathered(module: nn.Module, layout: Optional[Layout], prefix: str = ""):
    """The module's parameters as the forward reads them: ZeRO-3 shards are
    all-gathered over the dp group (backward: reduce-scatter of the
    gradient, `comm.gather_rs_bwd`); everything else is the stored tensor.
    Returns `module` itself when nothing is gathered, else a namespace tree
    with the same attribute names."""
    if layout is None or not any(n.startswith(prefix) for n in layout.zero3):
        return module
    ns = types.SimpleNamespace()
    for name, p in module._parameters.items():
        dim = layout.zero3.get(prefix + name)
        setattr(ns, name, p if p is None or dim is None
                else comm.gather_rs_bwd(p, dim, layout.dp_group))
    for name, child in module._modules.items():
        setattr(ns, name, None if child is None else gathered(child, layout, prefix + name + "."))
    for name, value in vars(module).items():  # plain attributes (a None bias)
        if not name.startswith("_") and name != "training":
            setattr(ns, name, value)
    return ns


# ============================================================== model forward
def embed_tokens(p_embed: Embed, tokens: torch.Tensor, positions: torch.Tensor,
                 cfg: TransformerConfig, vocab: Optional[Layout] = None,
                 token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token (+ learned position, + token type) embedding, then the
    embedding norm where the config has one. The lookup happens before the
    cast to the compute dtype — the same values as the reference's
    cast-then-gather, without casting the whole table. Vocab-parallel over
    the vocab tp group: each rank looks up the tokens of its vocab rows
    (zeros elsewhere) and the partial embeddings are summed over tp — an
    all-reduce, or under Megatron-SP a reduce-scatter onto sequence shards
    (Megatron's VocabParallelEmbedding; the reference's one-hot einsum),
    where the position and type rows are looked up for the rank's shard."""
    tp = vocab.tp if vocab is not None else None
    if tp is None or tp.size == 1:
        x = p_embed.wte[tokens].to(cfg.compute_dtype)
    else:
        rows = p_embed.wte.shape[0]
        local = tokens - tp.index * rows
        ok = (local >= 0) & (local < rows)
        x = torch.where(ok[..., None], p_embed.wte[local.clamp(0, rows - 1)], 0.0)
        x = T.exit_row(x.to(cfg.compute_dtype), tp)
    if cfg.position_type == "learned":
        x = x + p_embed.wpe[T.seq_shard(positions, tp)].to(cfg.compute_dtype)
    if cfg.type_vocab_size:
        tti = token_type_ids if token_type_ids is not None else torch.zeros_like(tokens)
        x = x + p_embed.tte[T.seq_shard(tti, tp)].to(cfg.compute_dtype)
    if cfg.embed_norm:
        x = _norm(x, p_embed.norm, cfg)
    return x


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) image -> (B, N, patch*patch*C) patch vectors, row-major
    over the patch grid; a dense on them is the stride-`patch` convolution
    of HF ViT's patch embedding."""
    b, hh, ww, c = pixels.shape
    gh, gw = hh // patch, ww // patch
    x = pixels.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def embed_patches(p_embed: Embed, pixels: torch.Tensor, cfg: TransformerConfig,
                  vocab: Optional[Layout] = None) -> torch.Tensor:
    """ViT patch embedding: patchify, dense, [cls token], learned positions
    (and the embedding norm). Under a layout it is computed on the rank's
    rows over the whole sequence and sliced to the vocab layers' sequence
    shard; the slice's gradient is the shard's own, so these parameters'
    gradients are partial over the sequence axes, as a token embedding's
    are."""
    dtype = cfg.compute_dtype
    x = _proj(patchify(pixels.to(dtype), cfg.patch_size), p_embed.patch, dtype)
    if cfg.use_cls_token:
        cls = p_embed.cls_token.to(dtype).expand(x.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + p_embed.wpe[:x.shape[1]].to(dtype)
    if cfg.embed_norm:
        x = _norm(x, p_embed.norm, cfg)
    if vocab is not None and vocab.act[1]:
        x = S.shard_tensor(x, ((), vocab.act[1], ()), vocab.mesh)
    return x


def embed_inputs(p_embed: Embed, batch: dict, cfg: TransformerConfig,
                 vocab: Optional[Layout] = None) -> torch.Tensor:
    """The family's embedding of a batch: ``pixels`` for patch input, else
    ``tokens`` (+ ``positions``, ``token_type_ids``)."""
    if cfg.input_type == "patches":
        return embed_patches(p_embed, batch["pixels"], cfg, vocab)
    return embed_tokens(p_embed, batch["tokens"], batch["positions"], cfg, vocab,
                        token_type_ids=batch.get("token_type_ids"))


def _vocab_kernel(params: TransformerLM, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.wte.to(cfg.compute_dtype).t()
    return params.lm_head.kernel.to(cfg.compute_dtype)


def lm_logits(params: TransformerLM, x: torch.Tensor, cfg: TransformerConfig,
              vocab: Optional[Layout] = None) -> torch.Tensor:
    """Final norm and the LM head; vocab-parallel under a layout (each rank
    the logits of its vocab rows, from the full sequence)."""
    if cfg.pre_norm:
        x = _norm(x, params.final_norm, cfg)
    x = T.enter_column(x, vocab.tp if vocab is not None else None)
    return x @ _vocab_kernel(params, cfg)


def _gather_head_seq(x: torch.Tensor, vocab: Layout) -> torch.Tensor:
    """The whole sequence of the rank's rows for a head that pools it. The
    sequence shards of the token group (cp, and tp under vocab sp) each
    score their own copy with 1/n of the weight (`classification_loss`
    counts every copy), so their gather sums the copies' gradients
    (reduce-scatter backward); Megatron-SP's tp shards score identical
    copies at full weight and take their own slice back."""
    tokens = S.token_seq_axes(vocab.axes)
    for a in reversed(vocab.act[1]):
        gather = comm.gather_rs_bwd if a in tokens else comm.gather_split_bwd
        x = gather(x, 1, vocab.mesh.group_for((a,)))
    return x


def model_head(params: TransformerLM, x: torch.Tensor, cfg: TransformerConfig,
               vocab: Optional[Layout] = None) -> torch.Tensor:
    """The family's output head (the reference's ``model_head``): the LM
    head; the MLM head (transform, exact gelu, norm on the rank's
    sequence shard, then the vocab-parallel decoder with its bias sharded
    over vocab tp); or the classification head (the final norm on the
    shard, the whole sequence gathered, cls or mean pooling, a dense to the
    classes: (B, C) logits)."""
    if cfg.head_type == "lm":
        return lm_logits(params, x, cfg, vocab)
    dtype = cfg.compute_dtype
    if cfg.pre_norm:
        x = _norm(x, params.final_norm, cfg)
    if cfg.head_type == "mlm":
        head = params.head
        y = F.gelu(_proj(x, head.transform, dtype))
        y = _norm(y, head.norm, cfg)
        y = T.enter_column(y, vocab.tp if vocab is not None else None)
        return y @ _vocab_kernel(params, cfg) + head.bias.to(dtype)
    if cfg.head_type == "classification":
        if vocab is not None and vocab.act[1]:
            x = _gather_head_seq(x, vocab)
        pooled = x[:, 0] if cfg.pool_type == "cls" else x.mean(dim=1)
        return _proj(pooled, params.head, dtype)
    raise ValueError(cfg.head_type)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 loss_mask: Optional[torch.Tensor] = None,
                                 vocab: Optional[Layout] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32, loss-mask weighted. The label logit
    is taken with a masked sum over the vocab, as in the reference (whose
    form lets a vocab-sharded layout reduce shard-locally).

    Under a layout the logits are this rank's vocab columns of its rows:
    the max, the sum of exponentials and the label logit are reduced over
    the vocab tp group (Megatron's vocab_parallel_cross_entropy), and the
    result is this rank's share of the global token mean — the sum over its
    tokens divided by the valid-token count of every rank that holds other
    tokens (dp, and the sequence shards of vocab cp and vocab sp) — so the
    shares sum to the reference's loss over the layout's token group.
    Under vocab sp the head is dense (the tp context has one rank)."""
    logits32 = logits.float()
    if vocab is None:
        m = logits32.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
        vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
        label_logit = torch.where(vocab_iota == labels[..., None], logits32, 0.0).sum(dim=-1)
        losses = lse - label_logit
        if loss_mask is None:
            return losses.mean()
        loss_mask = loss_mask.float()
        return (losses * loss_mask).sum() / loss_mask.sum().clamp(min=1.0)
    tp = vocab.tp
    # the max is a shift that cancels in the loss: no gradient through it
    m = logits32.detach().amax(dim=-1, keepdim=True)
    if tp.size > 1:
        m = comm.all_reduce(m, tp.group, op=torch.distributed.ReduceOp.MAX)
    sumexp = torch.exp(logits32 - m).sum(dim=-1)
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device) + tp.index * logits.shape[-1]
    label_logit = torch.where(vocab_iota == labels[..., None], logits32, 0.0).sum(dim=-1)
    if tp.size > 1:
        sumexp = comm.reduce_fwd(sumexp, tp.group)
        label_logit = comm.reduce_fwd(label_logit, tp.group)
    losses = torch.log(sumexp) + m[..., 0] - label_logit
    if loss_mask is None:
        total, count = losses.sum(), torch.tensor(float(losses.numel()), device=losses.device)
    else:
        loss_mask = loss_mask.float()
        total, count = (losses * loss_mask).sum(), loss_mask.sum()
    count = comm.all_reduce(count.detach(), vocab.token_group)
    return total / count.clamp(min=1.0)


# ----------------------------------------------------------------- remat
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _remat(fn, policy: str):
    """The reference's ``jax.checkpoint`` with a saveable policy, as
    non-reentrant ``torch.utils.checkpoint``: "full" and "nothing_saveable"
    save nothing and recompute the layer in the backward; "dots_saveable"
    keeps the matrix-product outputs (aten mm/bmm/addmm) and recomputes the
    rest. The flash-attention kernel is no aten op, so it is recomputed
    under every policy, as jax recomputes the opaque ``pallas_call``; so are
    a layout's collectives (the ZeRO-3 gathers included)."""
    if policy in ("full", "nothing_saveable"):
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots_saveable":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(list(_DOTS)))
    raise ValueError("unknown remat policy %r" % policy)


def _side_relayout(t: Optional[torch.Tensor], mesh: RankMesh, src: S.Spec, dst: S.Spec):
    """Re-lay a side input from one (batch, seq) placement to another:
    positions (B, S), or an attention bias (B, 1, 1, S) whose last dim is
    the sequence. Neither carries a gradient."""
    if t is None:
        return None
    if t.dim() == 4:
        return S.relayout(t, mesh, (src[0], (), (), src[1]), (dst[0], (), (), dst[1]))
    return S.relayout(t, mesh, src, dst)


def run_layers(
    params: TransformerLM,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: TransformerConfig,
    hp: Optional[HybridParallelConfig] = None,
    attn_bias: Optional[torch.Tensor] = None,
    collect_kv: bool = False,
    layouts: Optional[ModelLayouts] = None,
):
    """The layer stack, one layer after another (the reference's scan over
    same-strategy layer runs is a Python loop here); on a pipeline stage,
    its own layers, each indexed by its global index in `hp` and
    `layouts`. With a strategy `hp`
    and gradients enabled, each layer runs under its own effective remat
    policy (``hp.layers[i].effective_remat_policy``, "none" runs it plainly).
    With `layouts`, `x` enters in the vocab layout and leaves in it, and is
    re-laid at every boundary where ``act_spec`` changes (the reference's
    per-layer sharding constraints); `positions` and `attn_bias` enter in
    the vocab layers' token placement and are re-laid to each layer's side
    placement (its cp shard of the sequence); each layer runs its own TP,
    Ulysses, cp ring and ZeRO-3. ``collect_kv=True`` additionally returns
    one post-rope (k, v) pair per layer, in layer order — the serving
    prefill's cache contents; that path is forward-only and never remats,
    and under `layouts` (`serve_layouts`) its one request is whole on every
    rank: each layer gathers its ZeRO-3 weights and runs its tp, and hands
    back the rank's kv heads."""
    kvs: List[Tuple[torch.Tensor, torch.Tensor]] = []
    cur = layouts.vocab.act if layouts is not None else None
    side = {}
    for i, lp in layer_items(params):
        if collect_kv:
            lay = layouts.layers[i] if layouts is not None else None
            x, kv = layer_forward(gathered(lp, lay), x, positions, cfg, attn_bias=attn_bias,
                                  return_kv=True, tp=lay.tp if lay is not None else None)
            kvs.append(kv)
            continue
        lay = layouts.layers[i] if layouts is not None else None
        pos, bias = positions, attn_bias
        if lay is not None:
            x = S.relayout(x, lay.mesh, cur, lay.act)
            cur = lay.act
            src = layouts.vocab.side
            if lay.side not in side:
                side[lay.side] = (_side_relayout(positions, lay.mesh, src, lay.side),
                                  _side_relayout(attn_bias, lay.mesh, src, lay.side))
            pos, bias = side[lay.side]

        def fwd(x_, _lp=lp, _lay=lay, _pos=pos, _bias=bias):
            return layer_forward(gathered(_lp, _lay), x_, _pos, cfg, attn_bias=_bias,
                                 tp=_lay.tp if _lay is not None else None,
                                 seq=_lay.seq if _lay is not None else None)

        policy = hp.layers[i].effective_remat_policy if hp is not None else "none"
        if policy == "none" or not torch.is_grad_enabled():
            x = fwd(x)
        else:
            x = _remat(fwd, policy)(x)
    if collect_kv:
        return x, kvs
    if layouts is not None:
        x = S.relayout(x, layouts.vocab.mesh, cur, layouts.vocab.act)
    return x


def padding_attn_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 1/0 key-validity mask -> additive (B, 1, 1, S) bias."""
    return (1.0 - attn_mask.float())[:, None, None, :] * -1e9


def _trunk(params: TransformerLM, batch: dict, cfg: TransformerConfig,
           hp: Optional[HybridParallelConfig], layouts: Optional[ModelLayouts]):
    """(the vocab layers' view of `params`, the last layer's output) of a
    batch: the embedding and the layer stack."""
    if cfg.input_type == "tokens" and batch.get("positions") is None:
        tokens = batch["tokens"]
        batch = dict(batch, positions=torch.arange(tokens.shape[1], device=tokens.device)
                     .expand(tokens.shape))
    vocab = layouts.vocab if layouts is not None else None
    top = gathered(params, vocab) if vocab is not None else params
    x = embed_inputs(top.embed, batch, cfg, vocab)
    mask = batch.get("attn_mask")
    bias = padding_attn_bias(mask) if mask is not None else None
    return top, run_layers(params, x, batch.get("positions"), cfg, hp, attn_bias=bias,
                           layouts=layouts)


def model_forward(
    params: TransformerLM,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor],
    cfg: TransformerConfig,
    attn_mask: Optional[torch.Tensor] = None,
    hp: Optional[HybridParallelConfig] = None,
    layouts: Optional[ModelLayouts] = None,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full forward to logits; `tokens` are the pixels of a patch-input
    model. With `layouts`, the inputs are this rank's rows and sequence
    shard in the vocab layers' token placement (``Layout.side``; pixels:
    its rows), and the logits its vocab columns of those tokens (or its
    rows' class logits); the vocab layers' ZeRO-3 weights are gathered once
    for the embedding and the (tied) head."""
    key = "pixels" if cfg.input_type == "patches" else "tokens"
    batch = {key: tokens, "positions": positions, "token_type_ids": token_type_ids,
             "attn_mask": attn_mask}
    top, x = _trunk(params, batch, cfg, hp, layouts)
    return model_head(top, x, cfg, layouts.vocab if layouts is not None else None)


def softmax_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross entropy of (B, C) logits and (B,) labels, in
    fp32 (the reference's ``softmax_nll`` before its mean)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        vocab: Optional[Layout] = None) -> torch.Tensor:
    """Mean softmax cross entropy over the rows; under a layout this rank's
    share of the global mean: its rows' sum over the row count of every
    rank of the token group (dp, and the sequence shards that hold a copy
    of the same rows), so the shares sum to the mean over that group."""
    nll = softmax_nll(logits, labels)
    if vocab is None:
        return nll.mean()
    count = comm.all_reduce(torch.tensor(float(nll.numel()), device=nll.device),
                            vocab.token_group)
    return nll.sum() / count


def head_loss(top, x: torch.Tensor, batch: dict, cfg: TransformerConfig,
              vocab: Optional[Layout] = None) -> torch.Tensor:
    """The head and the family's loss on the last layer's output: token
    cross entropy for lm/mlm heads, class cross entropy for
    classification."""
    logits = model_head(top, x, cfg, vocab)
    if cfg.head_type == "classification":
        return classification_loss(logits, batch["labels"], vocab)
    return vocab_parallel_cross_entropy(logits, batch["labels"], batch.get("loss_mask"), vocab)


def loss_fn(params: TransformerLM, batch: dict, cfg: TransformerConfig,
            hp: Optional[HybridParallelConfig] = None,
            layouts: Optional[ModelLayouts] = None) -> torch.Tensor:
    """The family's loss of a batch (`lm_loss_fn` or
    `classification_loss_fn`)."""
    top, x = _trunk(params, batch, cfg, hp, layouts)
    return head_loss(top, x, batch, cfg, layouts.vocab if layouts is not None else None)


def lm_loss_fn(params: TransformerLM, batch: dict, cfg: TransformerConfig,
               hp: Optional[HybridParallelConfig] = None,
               layouts: Optional[ModelLayouts] = None) -> torch.Tensor:
    """batch: dict(tokens, positions, labels, loss_mask?, token_type_ids?,
    attn_mask?) -> scalar fp32 token-mean cross entropy, for lm and mlm
    heads (with `layouts`: this rank's share of it, see
    `vocab_parallel_cross_entropy`)."""
    return loss_fn(params, batch, cfg, hp, layouts)


# batch: dict(pixels | tokens, labels (B,)) -> mean softmax cross entropy
# over the classes (with layouts: this rank's share, see
# `classification_loss`); the reference's name for `loss_fn`
classification_loss_fn = loss_fn


# ================================================================ model def
class GenericDef:
    """What the layout path (``runtime.model_api``) needs of a family's
    parameter tree, for the generic transformer (`TransformerLM`). A family
    with its own tree (``models.t5.T5Def``, ``models.swin.SwinDef``) gives
    the same members:

    - `tree` (the whole model, or pipeline stage `stage`'s part), with
      `init_param_` (one parameter's initializer, drawn in full),
      `param_layouts` and `build_layouts` (a stage mesh's runtime layouts,
      with ``.vocab`` the layout the batch and the loss are in);
    - `stage_body` (one micro-batch on a stage: the tuple of tensors that
      crosses to the next stage, or on the last stage its loss) and
      `boundary` (their shapes and dtypes at each stage boundary);
    - `loss` (the unpipelined forward-only loss of a batch);
    - `shared` (each parameter that more than one stage holds, with the
      stages that hold it: their gradients are summed over them).
    """

    def __init__(self, cfg: TransformerConfig, hp: HybridParallelConfig):
        self.cfg, self.hp = cfg, hp

    def tree(self, device, stage: Optional[int] = None) -> TransformerLM:
        if stage is None:
            return TransformerLM(self.cfg, device)
        return stage_model(self.cfg, self.hp, stage, device)

    def init_param_(self, name: str, p: torch.Tensor, generator: torch.Generator) -> None:
        init_param_(name, p, self.cfg, generator)

    def param_layouts(self) -> Dict[str, ParamLayout]:
        return model_param_layouts(self.cfg, self.hp)

    def build_layouts(self, mesh: RankMesh) -> ModelLayouts:
        return build_layouts(self.cfg, self.hp, mesh)

    def shared(self) -> Dict[str, Tuple[int, ...]]:
        cfg, pp = self.cfg, self.hp.pp
        if (pp > 1 and cfg.tie_embeddings and cfg.head_type in ("lm", "mlm")
                and cfg.input_type == "tokens"):
            return {"embed.wte": (0, pp - 1)}
        return {}

    def loss(self, params: TransformerLM, batch: dict, layouts: ModelLayouts) -> torch.Tensor:
        return loss_fn(params, batch, self.cfg, self.hp, layouts)

    def stage_body(self, stage: int, params: TransformerLM, layouts: ModelLayouts):
        """(batch, inputs) -> (activation,) or, on the last stage, the
        head's loss: the embedding on the first stage, the stage's layers,
        the head on the last."""
        cfg, hp, vocab = self.cfg, self.hp, layouts.vocab
        first, last = stage == 0, stage == hp.pp - 1

        def body(batch, x_in):
            top = gathered(params, vocab)
            x = embed_inputs(top.embed, batch, cfg, vocab) if first else x_in[0]
            mask = batch.get("attn_mask")
            bias = padding_attn_bias(mask) if mask is not None else None
            out = run_layers(params, x, batch.get("positions"), cfg, hp, attn_bias=bias,
                             layouts=layouts)
            return head_loss(top, out, batch, cfg, vocab) if last else (out,)
        return body

    def boundary(self, mbs, mesh: RankMesh):
        """(shape, dtype) of a micro-batch's activation between stages: its
        rows, its sequence shard in the vocab layout (the tokens' shard,
        cut over tp once more under vocab Megatron-SP; for pixels, the
        patch sequence's shard), the hidden width."""
        cfg, vax = self.cfg, vocab_axes(self.hp)
        tokens = mesh.size(S.token_seq_axes(vax))
        seq = mesh.size(vax.seq_axes) // tokens

        def boundary(mb: int, stage: int):
            if "pixels" in mbs[mb]:
                rows, length = mbs[mb]["pixels"].shape[0], cfg.max_seq_len // tokens
            else:
                rows, length = mbs[mb]["tokens"].shape[:2]
            return [((rows, length // seq, cfg.hidden_size), cfg.compute_dtype)]
        return boundary
