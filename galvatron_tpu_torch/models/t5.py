"""T5 family: the encoder-decoder with two layer types.

Port of ``galvatron_tpu/models/t5.py`` (HF ``T5ForConditionalGeneration``):
RMSNorm pre-norm blocks without biases, unscaled attention logits
(``sm_scale=1.0``: the 1/sqrt(d) is folded into the init), a
relative-position-bucket attention bias per stack (one table shared by
every layer of the encoder, one by every layer of the decoder), a relu or
gated-gelu MLP, and a head tied to the token table with a
``hidden_size**-0.5`` scale before it. ``hp.layers`` covers the encoder
layers, then the decoder layers, so each layer has its own strategy.

The parameter tree is the reference's, as ``nn.Module`` state whose names
are its paths: ``embed.wte``, ``enc_layers.<i>.{ln1,ln2}.scale``,
``enc_layers.<i>.{wq,wk,wv}.kernel (h, nh, hd)``, ``...wo.kernel (nh*hd,
h)``, ``...wi.kernel (h, ffn)`` or ``(h, 2, ffn)`` gated,
``...wo_mlp.kernel``, ``dec_layers.<i>`` with ``ln_cross`` and ``cross``
(its own wq/wk/wv/wo), ``enc_rel_bias`` / ``dec_rel_bias (buckets, nh)``,
``enc_norm.scale``, ``dec_norm.scale`` and, untied, ``lm_head.kernel``.

Attention goes through ``ops.attention.core_attention`` with the bias as a
generic additive bias, so it takes the plain path, as in the reference
(T5's self-attention always has a relative bias; cross-attention has the
encoder's key-padding bias). Padded encoder keys are masked in the encoder
self-attention and in every cross-attention.

Under a strategy (`T5Def`) each layer runs its own DP / ZeRO-2 / ZeRO-3 /
Megatron TP (+SP), Ulysses and cp, and the embedding, the head and the
loss run vocab-parallel (vocab tp, sp and cp), as in ``models.base``. A
cp layer all-gathers its keys and values over cp, as GSPMD does in the
reference, and its bias holds its query rows against every key at their
true positions (`position_bias`): the relative bias is per (query, key)
pair, which the ring of ``ops/ring_attention.py`` does not take, and T5's
attention is on the plain path in both packages. A Ulysses layer runs its
self-attention between the all-to-alls on its chunk of the heads (and of
the relative table). A layer reads the encoder output (``mem``) with its
batch rows and the whole sequence, replicated over its tp group; under cp
or Ulysses its cross-attention's queries are the rank's sequence shard.
The relative tables are replicated: each rank's gradient covers its rows
and its heads, so it is summed over every axis of the stage.
Under a pipeline (1F1B only, the encoder/decoder boundary on a stage
boundary) each stage holds its own layers; the first stage, the first
decoder stage and, tied, the last stage hold ``embed.wte``, and every
stage of a stack holds that stack's table: `T5Def.shared` names them, and
their gradients are summed over the stages that hold them.

The HF bridge (`t5_config_from_hf`, `convert_hf_t5`, `export_hf_t5`) maps
T5ForConditionalGeneration's q/k/v/o Linears onto the head-major kernels,
``wi_0`` / ``wi_1`` onto the gated ``wi (h, 2, ffn)``, and the first block's
relative tables onto the stacks'.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.models.hf_utils import params_state, to_np, to_state_dict, to_t
from galvatron_tpu_torch.ops.attention import core_attention
from galvatron_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE
from galvatron_tpu_torch.ops.norms import rms_norm
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel import spec as S
from galvatron_tpu_torch.parallel import tensor_parallel as T
from galvatron_tpu_torch.parallel.mesh import RankMesh, layer_axes, subaxis_names, vocab_axes

META_CONFIGS = {
    "t5-test": dict(hidden_size=64, num_heads=4, num_enc_layers=2, num_dec_layers=2,
                    head_dim=16, ffn_hidden=128, vocab_size=512),
    "t5-small": dict(hidden_size=512, num_heads=8, num_enc_layers=6, num_dec_layers=6,
                     head_dim=64, ffn_hidden=2048),
    "t5-base": dict(hidden_size=768, num_heads=12, num_enc_layers=12, num_dec_layers=12,
                    head_dim=64, ffn_hidden=3072),
    "t5-large": dict(hidden_size=1024, num_heads=16, num_enc_layers=24, num_dec_layers=24,
                     head_dim=64, ffn_hidden=4096),
    "t5-3b": dict(hidden_size=1024, num_heads=32, num_enc_layers=24, num_dec_layers=24,
                  head_dim=128, ffn_hidden=16384),
}


@dataclass
class T5Config:
    hidden_size: int
    num_heads: int
    num_enc_layers: int
    num_dec_layers: int
    vocab_size: int = 32128
    head_dim: int = 64
    ffn_hidden: Optional[int] = None
    activation: str = "relu"  # relu | gelu | gated-gelu
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layernorm_eps: float = 1e-6
    tie_embeddings: bool = True
    max_seq_len: int = 512
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    init_std: float = 0.02
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.ffn_hidden is None:
            self.ffn_hidden = 4 * self.hidden_size

    @property
    def num_layers(self) -> int:
        return self.num_enc_layers + self.num_dec_layers

    # what the generic modules and metadata read (not fields)
    head_type = "lm"
    input_type = "tokens"
    norm_type = "rmsnorm"
    position_type = "none"
    type_vocab_size = 0
    embed_norm = False


def t5_config(model_size: str = "t5-base", **overrides) -> T5Config:
    base = dict(META_CONFIGS[model_size])
    base.update(overrides)
    return T5Config(**base)


def t5_config_from_hf(hf_config, **overrides) -> T5Config:
    proj = hf_config.feed_forward_proj
    if getattr(hf_config, "is_gated_act", False) or "gated" in proj:
        act = "gated-gelu"
    elif "gelu" in proj:
        act = "gelu"
    else:
        act = "relu"
    return T5Config(
        hidden_size=hf_config.d_model,
        num_heads=hf_config.num_heads,
        num_enc_layers=hf_config.num_layers,
        num_dec_layers=hf_config.num_decoder_layers,
        vocab_size=hf_config.vocab_size,
        head_dim=hf_config.d_kv,
        ffn_hidden=hf_config.d_ff,
        activation=act,
        rel_buckets=hf_config.relative_attention_num_buckets,
        rel_max_distance=getattr(hf_config, "relative_attention_max_distance", 128),
        layernorm_eps=hf_config.layer_norm_epsilon,
        tie_embeddings=hf_config.tie_word_embeddings,
        **overrides,
    )


# ================================================================= parameters
def _attention_params(m: nn.Module, cfg: T5Config, device) -> None:
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    m.wq = M.Dense((h, nh, hd), None, cfg, device)
    m.wk = M.Dense((h, nh, hd), None, cfg, device)
    m.wv = M.Dense((h, nh, hd), None, cfg, device)
    m.wo = M.Dense((nh * hd, h), None, cfg, device)


class CrossAttention(nn.Module):
    def __init__(self, cfg: T5Config, device):
        super().__init__()
        _attention_params(self, cfg, device)


def _mlp_fan_in(cfg: T5Config) -> tuple:
    return (2, cfg.ffn_hidden) if cfg.activation == "gated-gelu" else (cfg.ffn_hidden,)


class T5Layer(nn.Module):
    """An encoder layer, or with `decoder` a decoder layer (``ln_cross``
    and ``cross``)."""

    def __init__(self, cfg: T5Config, device, decoder: bool):
        super().__init__()
        self.ln1 = M.Norm(cfg, device)
        self.ln2 = M.Norm(cfg, device)
        _attention_params(self, cfg, device)
        self.wi = M.Dense((cfg.hidden_size,) + _mlp_fan_in(cfg), None, cfg, device)
        self.wo_mlp = M.Dense((cfg.ffn_hidden, cfg.hidden_size), None, cfg, device)
        if decoder:
            self.ln_cross = M.Norm(cfg, device)
            self.cross = CrossAttention(cfg, device)


class T5Embed(nn.Module):
    def __init__(self, cfg: T5Config, device):
        super().__init__()
        self.wte = M._param((cfg.vocab_size, cfg.hidden_size), cfg, device)


class T5Model(nn.Module):
    """The parameter tree, or with `layer_ids` (global indices: encoder
    layers first) a pipeline stage's part of it: its layers (keyed by
    their index within their stack), the token table where the stage
    embeds (the first encoder layer, the first decoder layer) or, tied,
    runs the head, each stack's table where the stage holds a layer of the
    stack, ``enc_norm`` with the last encoder layer, and ``dec_norm`` and
    an untied head on the last stage."""

    def __init__(self, cfg: T5Config, device, layer_ids: Optional[Sequence[int]] = None):
        super().__init__()
        ne, n = cfg.num_enc_layers, cfg.num_layers
        whole = layer_ids is None  # every part, with or without layers
        ids = list(range(n)) if whole else list(layer_ids)
        last = whole or n - 1 in ids
        self.embed = (T5Embed(cfg, device) if whole or 0 in ids or ne in ids
                      or (last and cfg.tie_embeddings) else None)
        self.enc_layers = nn.ModuleDict({str(i): T5Layer(cfg, device, False)
                                         for i in ids if i < ne})
        self.dec_layers = nn.ModuleDict({str(i - ne): T5Layer(cfg, device, True)
                                         for i in ids if i >= ne})
        table = (cfg.rel_buckets, cfg.num_heads)
        self.enc_rel_bias = (M._param(table, cfg, device) if whole or len(self.enc_layers)
                             else None)
        self.dec_rel_bias = (M._param(table, cfg, device) if whole or len(self.dec_layers)
                             else None)
        self.enc_norm = M.Norm(cfg, device) if whole or ne - 1 in ids else None
        self.dec_norm = M.Norm(cfg, device) if last else None
        self.lm_head = (M.Dense((cfg.hidden_size, cfg.vocab_size), None, cfg, device)
                        if last and not cfg.tie_embeddings else None)


def init_param_(name: str, p: torch.Tensor, cfg: T5Config, generator: torch.Generator) -> None:
    """The reference's T5 initializer scales: q (h*hd)^-0.5, k and v h^-0.5,
    o (nh*hd)^-0.5, wi h^-0.5, wo_mlp ffn^-0.5, the token table 1, the
    relative tables h^-0.5, an untied head ``init_std``, unit norm scales."""
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    parts = name.split(".")
    if parts[-1] == "scale":
        p.fill_(1.0)
        return
    std = {"wte": 1.0, "enc_rel_bias": h ** -0.5, "dec_rel_bias": h ** -0.5,
           "lm_head": cfg.init_std, "wq": (h * hd) ** -0.5, "wk": h ** -0.5, "wv": h ** -0.5,
           "wo": (nh * hd) ** -0.5, "wi": h ** -0.5, "wo_mlp": cfg.ffn_hidden ** -0.5}
    key = parts[-1] if parts[-1] in std else parts[-2]
    M._normal_(p, std[key], generator)


@torch.no_grad()
def init_t5_params(cfg: T5Config, generator: torch.Generator, device=None) -> T5Model:
    device = torch.device(device) if device is not None else generator.device
    model = T5Model(cfg, device)
    for name, p in model.named_parameters():
        init_param_(name, p, cfg, generator)
    return model


# ============================================================== rel-pos bias
def relative_position_bucket(rel_pos: torch.Tensor, *, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5's log-spaced relative-position bucketing (int64)."""
    ret = torch.zeros_like(rel_pos)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel_pos > 0).long() * num_buckets
        rel = rel_pos.abs()
    else:
        rel = -torch.clamp(rel_pos, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    val_large = max_exact + (torch.log(rel.float() / max_exact + 1e-6)
                             / math.log(max_distance / max_exact)
                             * (num_buckets - max_exact)).long()
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, rel, val_large)


@functools.lru_cache(maxsize=16)
def _bucket_table(n: int, bidirectional: bool, num_buckets: int, max_distance: int,
                  device: str) -> torch.Tensor:
    """The bucket of every relative position -(n-1)..n-1 (index rel +
    n - 1), computed once on the CPU (so every device gets the same
    integers) and cached per device."""
    rel = torch.arange(-(n - 1), n)
    return relative_position_bucket(rel, bidirectional=bidirectional, num_buckets=num_buckets,
                                    max_distance=max_distance).to(device)


class _TableRows(torch.autograd.Function):
    """(buckets, heads) table, (sq, sk) buckets -> the (heads, sq, sk) bias.
    The backward sums each head's gradient per bucket with a histogram
    (``torch.bincount``: shared-memory counters on CUDA), where the gather's
    own backward scatters sq * sk * heads atomic adds onto the table's few
    rows (4.9 s a forward and backward of one encoder and one decoder layer
    at S=4096 on an H100)."""

    @staticmethod
    def forward(ctx, table, bucket):
        ctx.save_for_backward(bucket)
        ctx.rows = table.shape[0]
        return table.t()[:, bucket]

    @staticmethod
    def backward(ctx, g):
        (bucket,) = ctx.saved_tensors
        flat, g = bucket.reshape(-1), g.reshape(g.shape[0], -1)
        return torch.stack([torch.bincount(flat, weights=g[h], minlength=ctx.rows)
                            for h in range(g.shape[0])], dim=1), None


def position_bias(table: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor, n: int,
                  cfg: T5Config, *, bidirectional: bool) -> torch.Tensor:
    """(buckets, heads) table -> (1, heads, sq, sk) fp32 additive bias of
    the queries at true positions `q_pos` (sq,) against the keys at
    `k_pos` (sk,), both below `n`. The decoder's (unidirectional) bias
    carries the causal mask of those positions, so a rank's rows of a
    sharded sequence, in any order, see what the whole sequence's rows
    see."""
    lookup = _bucket_table(n, bidirectional, cfg.rel_buckets, cfg.rel_max_distance,
                           str(table.device))
    rel = k_pos[None, :] - q_pos[:, None]
    bias = _TableRows.apply(table.float(), lookup[rel + (n - 1)])[None]
    if not bidirectional:
        bias = bias + torch.where(rel > 0, DEFAULT_MASK_VALUE, 0.0)
    return bias


def rel_bias(table: torch.Tensor, sq: int, sk: int, cfg: T5Config, *,
             bidirectional: bool) -> torch.Tensor:
    """`position_bias` of positions 0..sq-1 against 0..sk-1."""
    dev = table.device
    return position_bias(table, torch.arange(sq, device=dev), torch.arange(sk, device=dev),
                         max(sq, sk), cfg, bidirectional=bidirectional)


# ================================================================== forward
def _rms(x, p, cfg: T5Config):
    return rms_norm(x, p.scale, cfg.layernorm_eps)


@dataclass(frozen=True)
class T5Seq:
    """How a layer's self-attention sees a sharded sequence: `ulysses` is
    the tp group of a Ulysses layer (all-to-all seq -> heads before the
    attention, heads -> seq after it), `cp` the groups of its cp sub-axes,
    major first, over which the keys and values are all-gathered (their
    gradient reduce-scattered back: every rank's queries read every key),
    as GSPMD gathers them in the reference."""

    ulysses: Any = None
    cp: Tuple[Any, ...] = ()

    def to_heads(self, t: torch.Tensor) -> torch.Tensor:
        return comm.seq_to_heads(t, self.ulysses) if self.ulysses is not None else t

    def to_seq(self, t: torch.Tensor) -> torch.Tensor:
        return comm.heads_to_seq(t, self.ulysses) if self.ulysses is not None else t

    def keys(self, t: torch.Tensor) -> torch.Tensor:
        for group in reversed(self.cp):
            t = comm.gather_rs_bwd(t, 1, group)
        return t


class LocalSeq:
    """`T5Seq` with every rank of a layer's cp x Ulysses group in one
    process (as ``ops.ring_attention.LocalRing`` plays a ring), for checks
    on one device: the ranks' tensors are stacked along the batch dim, rank-major
    (cp major, then tp), rank (c, u) holding what that rank holds; each
    exchange moves them as the collective would, and autograd gives each
    the collective's backward. `rank_shards` / `rank_unshard` stack a
    whole-sequence tensor and back."""

    def __init__(self, cp: int, tp: int):
        self.n = (cp, tp)

    def rank_shards(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, ...) -> (cp*tp*B, S/(cp*tp), ...), the sequence shards."""
        r = self.n[0] * self.n[1]
        b, s = x.shape[:2]
        return x.reshape(b, r, s // r, *x.shape[2:]).transpose(0, 1).reshape(
            r * b, s // r, *x.shape[2:])

    def rank_unshard(self, x: torch.Tensor) -> torch.Tensor:
        r = self.n[0] * self.n[1]
        b, s = x.shape[0] // r, x.shape[1]
        return x.reshape(r, b, s, *x.shape[2:]).transpose(0, 1).reshape(b, r * s, *x.shape[2:])

    def bias(self, table: torch.Tensor, positions: torch.Tensor, batch: int, cfg: T5Config, *,
             bidirectional: bool, key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The self-attention biases of every rank for `batch` rows each,
        stacked: rank (c, u)'s are the rows of cp chunk c of `positions`
        (the true positions of the sequence in batch order) against all of
        them, for head chunk u, plus the (B, 1, 1, S) `key_bias`."""
        (cp, tp), n = self.n, positions.shape[0]
        rows = positions.reshape(cp, n // cp)
        out = []
        for c in range(cp):
            for u in range(tp):
                b = position_bias(table.chunk(tp, 1)[u], rows[c], positions, n, cfg,
                                  bidirectional=bidirectional)
                out.append(b if key_bias is None else b + key_bias)
        return torch.cat([t.expand(batch, *t.shape[1:]) for t in out])

    def to_heads(self, t):
        (cp, tp), (rb, s, nh, hd) = self.n, t.shape
        if tp == 1:
            return t
        t = t.reshape(cp, tp, rb // (cp * tp), s, tp, nh // tp, hd)
        return t.permute(0, 4, 2, 1, 3, 5, 6).reshape(rb, tp * s, nh // tp, hd)

    def to_seq(self, t):
        (cp, tp), (rb, s, nh, hd) = self.n, t.shape
        if tp == 1:
            return t
        t = t.reshape(cp, tp, rb // (cp * tp), tp, s // tp, nh, hd)
        return t.permute(0, 3, 2, 4, 1, 5, 6).reshape(rb, s // tp, nh * tp, hd)

    def keys(self, t):
        (cp, tp), rb = self.n, t.shape[0]
        if cp == 1:
            return t
        b = rb // (cp * tp)
        t = t.reshape(cp, tp, b, *t.shape[1:]).permute(1, 2, 0, *range(3, t.dim() + 2))
        t = t.reshape(tp, b, cp * t.shape[3], *t.shape[4:])
        return t[None].expand(cp, *t.shape).reshape(rb, *t.shape[2:])


def _attend(p, q_in, kv_in, cfg: T5Config, *, bias, tp, seq: Optional[T5Seq] = None
            ) -> torch.Tensor:
    """q from `q_in`, k/v from `kv_in` (the rank's heads under tp), the
    sequence exchange of `seq`, attention at scale 1 with the additive
    `bias` (relative positions, causal mask, key padding: always the plain
    path), the row-parallel out projection."""
    dtype = cfg.compute_dtype
    q = M._proj(q_in, p.wq, dtype)
    k = M._proj(kv_in, p.wk, dtype)
    v = M._proj(kv_in, p.wv, dtype)
    if seq is not None:
        q, k, v = (seq.to_heads(t) for t in (q, k, v))
        k, v = seq.keys(k), seq.keys(v)
    attn = core_attention(q, k, v, causal=False, sm_scale=1.0, bias=bias, impl=cfg.attn_impl)
    if seq is not None:
        attn = seq.to_seq(attn)
    return M._row_proj(attn.reshape(attn.shape[0], attn.shape[1], -1), p.wo, dtype, tp)


def _mlp(p, x, cfg: T5Config, tp) -> torch.Tensor:
    dtype = cfg.compute_dtype
    y = M._proj(T.enter_column(_rms(x, p.ln2, cfg), tp), p.wi, dtype)
    if cfg.activation == "gated-gelu":
        y = F.gelu(y[:, :, 0]) * y[:, :, 1]
    elif cfg.activation == "gelu":
        y = F.gelu(y)
    else:
        y = F.relu(y)
    return M._row_proj(y, p.wo_mlp, dtype, tp)


def enc_layer_forward(p, x, cfg: T5Config, bias, tp: Optional[T.TPContext] = None,
                      seq: Optional[T5Seq] = None):
    y = T.enter_column(_rms(x, p.ln1, cfg), tp)
    x = x + _attend(p, y, y, cfg, bias=bias, tp=tp, seq=seq)
    return x + _mlp(p, x, cfg, tp)


def dec_layer_forward(p, x, mem, cfg: T5Config, self_bias, cross_bias=None,
                      tp: Optional[T.TPContext] = None, seq: Optional[T5Seq] = None):
    """Causal self-attention with the decoder table (`self_bias` carries
    the causal mask), cross-attention on `mem` (the whole encoder output of
    the layer's rows, replicated over tp: its k/v projections take the
    plain f of Megatron TP even under Megatron-SP) with only the
    key-padding bias, then the MLP. Under cp or Ulysses (`seq`) the
    cross-attention's queries stay the rank's sequence shard, all its
    heads, against the whole encoder output: no exchange."""
    y = T.enter_column(_rms(x, p.ln1, cfg), tp)
    x = x + _attend(p, y, y, cfg, bias=self_bias, tp=tp, seq=seq)
    z = T.enter_column(_rms(x, p.ln_cross, cfg), tp)
    mem_tp = dataclasses.replace(tp, sequence_parallel=False) if tp is not None else None
    x = x + _attend(p.cross, z, T.enter_column(mem, mem_tp), cfg, bias=cross_bias, tp=tp)
    return x + _mlp(p, x, cfg, tp)


def _mem_spec(lay: M.Layout) -> S.Spec:
    """The encoder output as a decoder layer reads it: its rows, the whole
    sequence, the hidden width dense."""
    return (tuple(lay.axes.dp), (), ())


def _query_axes(lay: M.Layout) -> Tuple[str, ...]:
    """The axes over which a layer's cross-attention queries are sequence
    shards (cp, and tp under Ulysses): each shard reads the whole encoder
    output, so its gradient there is partial over them."""
    ax = lay.axes
    return tuple(ax.cp) + (tuple(ax.tp) if ax.ulysses else ())


def _head_shard(lay: Optional[M.Layout]) -> Tuple[int, int]:
    """(shards, index) of the heads a layer's attention computes: Megatron
    TP's column shard, or the Ulysses all-to-all's head chunk."""
    if lay is None:
        return 1, 0
    if lay.axes.ulysses:
        return lay.mesh.size(lay.axes.tp), lay.mesh.index(lay.axes.tp)
    return lay.tp.size, lay.tp.index


def _seq_of(lay: Optional[M.Layout]) -> Optional[T5Seq]:
    if lay is None or not (lay.axes.cp or lay.axes.ulysses):
        return None
    return T5Seq(ulysses=lay.mesh.group_for(lay.axes.tp) if lay.axes.ulysses else None,
                 cp=tuple(lay.mesh.group_for((a,)) for a in lay.axes.cp))


def _run_stack(params: T5Model, ids: Sequence[int], x, mem, key_bias, positions,
               cfg: T5Config, hp: Optional[HybridParallelConfig],
               layouts: Optional[M.ModelLayouts]):
    """The layers `ids` (all of one stack) on `x`, each under its own
    layout and remat policy; `x` and `mem` enter and `x` leaves in the
    vocab layout, `key_bias` (B, 1, 1, S) and `positions` (1, S: the true
    positions of the stack's tokens) in the vocab layers' token placement.
    A layer's self-attention bias covers its queries (its cp shard of the
    sequence: the rows Ulysses and Megatron-SP gather) against the keys of
    the whole sequence, each at its true position, for the layer's heads."""
    ne = cfg.num_enc_layers
    decoder = ids[0] >= ne
    table = params.dec_rel_bias if decoder else params.enc_rel_bias
    vocab = layouts.vocab if layouts is not None else None
    # the whole sequence: attention runs on it (Megatron-SP gathers it)
    seq = x.shape[1] * (vocab.mesh.size(vocab.act[1]) if vocab is not None else 1)
    cur = vocab.act if vocab is not None else None
    cache: Dict[Any, Any] = {}

    def per_layer(key, make):
        if key not in cache:
            cache[key] = make()
        return cache[key]

    for i in ids:
        lp = params.dec_layers[str(i - ne)] if decoder else params.enc_layers[str(i)]
        lay = layouts.layers[i] if layouts is not None else None
        tp = lay.tp if lay is not None else None
        kb, m, q_pos, k_pos = key_bias, mem, positions, positions
        if lay is not None:
            x = S.relayout(x, lay.mesh, cur, lay.act)
            cur = lay.act
            keys = (lay.side[0], ())  # the layer's rows, the whole sequence
            kb = per_layer(("kb", keys), lambda: M._side_relayout(
                key_bias, lay.mesh, vocab.side, keys))
            q_pos = per_layer(("pos", lay.side[1]), lambda: S.relayout(
                positions, lay.mesh, ((), vocab.side[1]), ((), lay.side[1])))
            k_pos = per_layer(("pos", ()), lambda: S.relayout(
                positions, lay.mesh, ((), vocab.side[1]), ((), ())))
            if decoder:
                group = _query_axes(lay)
                m = per_layer(("mem", _mem_spec(lay)), lambda: S.relayout(
                    mem, lay.mesh, vocab.act, _mem_spec(lay)))
                if group:
                    m = per_layer(("mem_q", _mem_spec(lay), group), lambda: comm.reduce_bwd(
                        m, lay.mesh.group_for(group)))
        shards, index = _head_shard(lay)

        def heads(kb=kb, q_pos=q_pos, k_pos=k_pos, shards=shards, index=index):
            t = table.chunk(shards, 1)[index] if shards > 1 else table
            b = position_bias(t, q_pos[0], k_pos[0], seq, cfg, bidirectional=not decoder)
            return b if decoder or kb is None else b + kb
        bias = per_layer(("bias", shards, index, lay.side if lay is not None else None), heads)

        if decoder:
            def fwd(x_, _lp=lp, _lay=lay, _m=m, _b=bias, _kb=kb):
                return dec_layer_forward(M.gathered(_lp, _lay), x_, _m, cfg, _b, _kb,
                                         _lay.tp if _lay is not None else None, _seq_of(_lay))
        else:
            def fwd(x_, _lp=lp, _lay=lay, _b=bias):
                return enc_layer_forward(M.gathered(_lp, _lay), x_, cfg, _b,
                                         _lay.tp if _lay is not None else None, _seq_of(_lay))
        policy = hp.layers[i].effective_remat_policy if hp is not None else "none"
        x = fwd(x) if policy == "none" or not torch.is_grad_enabled() else M._remat(fwd, policy)(x)
    if vocab is not None:
        x = S.relayout(x, vocab.mesh, cur, vocab.act)
    return x


def _head_loss(top, h, batch, cfg: T5Config, vocab: Optional[M.Layout]) -> torch.Tensor:
    """The head's vocab-parallel logits and the token-mean cross entropy."""
    return M.vocab_parallel_cross_entropy(_head_logits(top, h, batch, cfg, vocab),
                                          batch["labels"], batch.get("loss_mask"), vocab)


def _head_logits(top, h, batch, cfg: T5Config, vocab: Optional[M.Layout]) -> torch.Tensor:
    """The decoder's final norm, the ``hidden_size**-0.5`` scale of a tied
    head and the vocab-parallel logits."""
    dtype = cfg.compute_dtype
    y = _rms(h, top.dec_norm, cfg)
    if cfg.tie_embeddings:
        y = y * (cfg.hidden_size ** -0.5)
        kernel = top.embed.wte.to(dtype).t()
    else:
        kernel = top.lm_head.kernel.to(dtype)
    return T.enter_column(y, vocab.tp if vocab is not None else None) @ kernel


def _positions(batch: dict, key: str, tokens: str, vocab: Optional[M.Layout]) -> torch.Tensor:
    """(1, s) true positions of the rank's tokens of a stack, in the vocab
    layers' token placement: the batch's `key` field where it has one (a
    batch in another order than the natural one; every row the same), else
    the natural order. The seq2seq streams of both packages are in natural
    order under every cp mode (the zigzag permutation of ``prepare_batch``
    is the token stream's)."""
    if batch.get(key) is not None:
        return batch[key][:1]
    t = batch[tokens]
    if vocab is None:
        return torch.arange(t.shape[1], device=t.device)[None]
    n = t.shape[1] * vocab.mesh.size(vocab.side[1])
    return S.shard_tensor(torch.arange(n, device=t.device)[None], ((), vocab.side[1]),
                          vocab.mesh)


def t5_stage(params: T5Model, batch: dict, cfg: T5Config, ids: Sequence[int],
             x_in: Optional[Tuple[torch.Tensor, ...]] = None, *,
             hp: Optional[HybridParallelConfig] = None,
             layouts: Optional[M.ModelLayouts] = None, head=_head_loss):
    """The layers `ids` of one pipeline stage (every layer: the whole model)
    on a batch: ``(h,)`` out of an encoder stage, ``(mem,)`` (the
    final-normed encoder output) out of the last encoder stage, ``(h,
    mem)`` out of a decoder stage (`mem` passed on as it came), and the
    loss out of the last stage. `x_in` is what the previous stage sent.
    The encoder tokens are embedded on the first stage, the decoder tokens
    on the first decoder stage."""
    ne, vocab = cfg.num_enc_layers, layouts.vocab if layouts is not None else None
    enc = [i for i in ids if i < ne]
    dec = [i for i in ids if i >= ne]
    top = M.gathered(params, vocab) if vocab is not None else params
    mask = batch.get("attn_mask")
    key_bias = M.padding_attn_bias(mask) if mask is not None else None
    enc_pos, dec_pos = (_positions(batch, k, f, vocab) for k, f in (
        ("positions", "tokens"), ("dec_positions", "dec_tokens")))
    h = mem = None
    if not ids:  # the model at zero layers: no layer reads the encoder side
        h = M.embed_tokens(top.embed, batch["dec_tokens"], None, cfg, vocab)
        return head(top, h, batch, cfg, vocab)
    if enc:
        h = M.embed_tokens(top.embed, batch["tokens"], None, cfg, vocab) if enc[0] == 0 \
            else x_in[0]
        h = _run_stack(params, enc, h, None, key_bias, enc_pos, cfg, hp, layouts)
        if enc[-1] != ne - 1:
            return (h,)
        mem = _rms(h, top.enc_norm, cfg)
        if not dec:
            return (mem,)
    else:
        mem = x_in[-1]
    h = M.embed_tokens(top.embed, batch["dec_tokens"], None, cfg, vocab) if dec[0] == ne \
        else x_in[0]
    h = _run_stack(params, dec, h, mem, key_bias, dec_pos, cfg, hp, layouts)
    if dec[-1] == cfg.num_layers - 1:
        return head(top, h, batch, cfg, vocab)
    return h, mem


def t5_loss_fn(params: T5Model, batch: dict, cfg: T5Config,
               hp: Optional[HybridParallelConfig] = None,
               layouts: Optional[M.ModelLayouts] = None) -> torch.Tensor:
    """batch: dict(tokens [enc], dec_tokens, labels, loss_mask?, attn_mask?,
    positions?, dec_positions?) -> the token-mean cross entropy (with
    `layouts`: this rank's share)."""
    return t5_stage(params, batch, cfg, range(cfg.num_layers), hp=hp, layouts=layouts)


# =============================================================== HF bridge
def _heads(w, h, nh, hd):
    """torch Linear (nh*hd, h) -> (h, nh, hd)."""
    return w.T.reshape(h, nh, hd)


def _hf_layers(cfg: T5Config):
    """(tree prefix, HF prefix, decoder) of every layer."""
    for i in range(cfg.num_enc_layers):
        yield "enc_layers.%d." % i, "encoder.block.%d.layer." % i, False
    for i in range(cfg.num_dec_layers):
        yield "dec_layers.%d." % i, "decoder.block.%d.layer." % i, True


def _hf_parts(decoder: bool):
    """(tree part, HF sublayer) of a layer's attentions, norms and MLP."""
    mlp = "2.DenseReluDense." if decoder else "1.DenseReluDense."
    attn = [("", "0.SelfAttention.")] + ([("cross.", "1.EncDecAttention.")] if decoder else [])
    norms = [("ln1", "0"), ("ln2", "2" if decoder else "1")] + ([("ln_cross", "1")]
                                                                  if decoder else [])
    return attn, norms, mlp


_T5_TOP = (("enc_rel_bias", "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           ("dec_rel_bias", "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           ("enc_norm.scale", "encoder.final_layer_norm.weight"),
           ("dec_norm.scale", "decoder.final_layer_norm.weight"))


def convert_hf_t5(state_dict: Dict[str, Any], cfg: T5Config) -> Dict[str, torch.Tensor]:
    """HF T5ForConditionalGeneration state dict -> the port's state dict
    (fp32)."""
    g = lambda n: to_t(state_dict[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    out = {"embed.wte": g("shared.weight")}
    out.update({mine: g(theirs) for mine, theirs in _T5_TOP})
    for dst, pre, decoder in _hf_layers(cfg):
        attn, norms, mlp = _hf_parts(decoder)
        for part, sub in attn:
            for role in ("q", "k", "v"):
                out[dst + part + "w%s.kernel" % role] = _heads(g(pre + sub + role + ".weight"),
                                                               h, nh, hd)
            out[dst + part + "wo.kernel"] = g(pre + sub + "o.weight").T
        for mine, sub in norms:
            out[dst + mine + ".scale"] = g(pre + sub + ".layer_norm.weight")
        if cfg.activation == "gated-gelu":
            out[dst + "wi.kernel"] = torch.stack([g(pre + mlp + "wi_0.weight").T,
                                               g(pre + mlp + "wi_1.weight").T], dim=1)
        else:
            out[dst + "wi.kernel"] = g(pre + mlp + "wi.weight").T
        out[dst + "wo_mlp.kernel"] = g(pre + mlp + "wo.weight").T
    if not cfg.tie_embeddings:
        out["lm_head.kernel"] = g("lm_head.weight").T
    return to_state_dict(out)


def export_hf_t5(params, cfg: T5Config) -> Dict[str, np.ndarray]:
    """The port's parameters -> HF T5ForConditionalGeneration state-dict
    arrays (fp32): the inverse of `convert_hf_t5`, with the tied copies HF
    materialises (the encoder's and decoder's token tables, a tied head)."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    wte = a("embed.wte")
    out = {"shared.weight": wte, "encoder.embed_tokens.weight": wte,
           "decoder.embed_tokens.weight": wte,
           "lm_head.weight": wte if cfg.tie_embeddings else a("lm_head.kernel").T}
    out.update({theirs: a(mine) for mine, theirs in _T5_TOP})
    for src, pre, decoder in _hf_layers(cfg):
        attn, norms, mlp = _hf_parts(decoder)
        for part, sub in attn:
            for role in ("q", "k", "v"):
                out[pre + sub + role + ".weight"] = a(
                    src + part + "w%s.kernel" % role).reshape(h, nh * hd).T
            out[pre + sub + "o.weight"] = a(src + part + "wo.kernel").T
        for mine, sub in norms:
            out[pre + sub + ".layer_norm.weight"] = a(src + mine + ".scale")
        wi = a(src + "wi.kernel")
        if cfg.activation == "gated-gelu":
            out[pre + mlp + "wi_0.weight"] = wi[:, 0].T
            out[pre + mlp + "wi_1.weight"] = wi[:, 1].T
        else:
            out[pre + mlp + "wi.weight"] = wi.T
        out[pre + mlp + "wo.weight"] = a(src + "wo_mlp.kernel").T
    return out


def t5_forward(params: T5Model, batch: dict, cfg: T5Config) -> torch.Tensor:
    """The unsharded logits (B, S_dec, vocab) of a batch (the reference's
    ``t5_forward``)."""
    return t5_stage(params, batch, cfg, range(cfg.num_layers), head=_head_logits)


# ================================================================ layouts
def _layer_placements(cfg: T5Config, ax, decoder: bool) -> Dict[str, Tuple[S.Spec, Optional[int]]]:
    """(placement, the dim ZeRO-3 shards) of a layer's parameters: the
    reference's ``enc_layer_specs`` / ``dec_layer_specs``."""
    (z3, tp), row = S.col_kernel_spec(ax), S.row_kernel_spec(ax)
    r1 = (S.replicated_1d_spec(ax), 0)
    attn = {"wq.kernel": ((z3, tp, ()), 0), "wk.kernel": ((z3, tp, ()), 0),
            "wv.kernel": ((z3, tp, ()), 0), "wo.kernel": (row, 1)}
    out = {"ln1.scale": r1, "ln2.scale": r1, **attn,
           "wi.kernel": (((z3, (), tp), 0) if cfg.activation == "gated-gelu" else ((z3, tp), 0)),
           "wo_mlp.kernel": (row, 1)}
    if decoder:
        out["ln_cross.scale"] = r1
        out.update({"cross." + n: v for n, v in attn.items()})
    return out


# norms that run on Megatron-SP sequence shards: their gradients are
# partial over tp there
_SP_PARTIAL = ("ln1.scale", "ln2.scale", "ln_cross.scale")


def t5_param_layouts(cfg: T5Config, hp: HybridParallelConfig) -> Dict[str, M.ParamLayout]:
    vax = vocab_axes(hp)
    vocab_col = None if vax.ulysses else vax.tp
    out = {"embed.wte": M._param_layout(S.vocab_embed_spec(vax), 0 if vax.ulysses else 1, vax,
                                        False)}
    for n in ("enc_norm.scale", "dec_norm.scale"):
        out[n] = M._param_layout(S.replicated_1d_spec(vax), 0, vax, vax.megatron_sp)
    if not cfg.tie_embeddings:
        out["lm_head.kernel"] = M._param_layout(S.spec(None, vocab_col), None, vax, False)
    every = tuple(subaxis_names(hp.per_stage_devices))
    for n in ("enc_rel_bias", "dec_rel_bias"):
        out[n] = M.ParamLayout(spec=S.replicated_spec(2), z3_dim=None, dp=(), partial=every,
                               zero_opt=False)
    for i in range(cfg.num_layers):
        ax, decoder = layer_axes(hp, i), i >= cfg.num_enc_layers
        prefix = "dec_layers.%d." % (i - cfg.num_enc_layers) if decoder else "enc_layers.%d." % i
        for n, (spec, z3_dim) in _layer_placements(cfg, ax, decoder).items():
            out[prefix + n] = M._param_layout(spec, z3_dim, ax,
                                              ax.megatron_sp and n in _SP_PARTIAL)
    return out


def _prefix(cfg: T5Config, i: int) -> str:
    if i >= cfg.num_enc_layers:
        return "dec_layers.%d." % (i - cfg.num_enc_layers)
    return "enc_layers.%d." % i


def validate_encdec_config(cfg: T5Config, hp: HybridParallelConfig) -> int:
    """The reference's enc-dec 1F1B contract; returns the number of encoder
    stages. Every stage holds the same layer count, and the
    encoder/decoder boundary falls on a stage boundary."""
    if hp.pp <= 1:
        return 0
    div = hp.pp_division
    if len(set(div)) != 1:
        raise ValueError(
            "enc-dec 1F1B requires equal layers per stage, got pp_division=%s" % (div,))
    lps = div[0]
    if cfg.num_enc_layers % lps != 0:
        raise ValueError(
            "the encoder/decoder boundary must align with a stage boundary: %d encoder "
            "layers do not divide into stages of %d layers" % (cfg.num_enc_layers, lps))
    for s in hp.layers:
        if s.cp > 1:
            raise ValueError("cp>1 with pp>1 is not yet supported in the 1f1b pipeline")
    return cfg.num_enc_layers // lps


def t5_refusals(cfg: T5Config, hp: HybridParallelConfig) -> List[str]:
    """What the reference refuses for T5: its layer count, GPipe, the
    enc-dec pipeline contract (cp with pp > 1 among it)."""
    out = []
    if len(hp.layers) != cfg.num_layers:
        out.append("hp covers %d layers but t5 has %d (enc %d + dec %d)" % (
            len(hp.layers), cfg.num_layers, cfg.num_enc_layers, cfg.num_dec_layers))
        return out
    if hp.pp > 1 and hp.pipeline_type != "pipedream_flush":
        out.append("t5 pipeline parallelism runs the enc-dec 1F1B engine: set "
                   "pipeline_type='pipedream_flush' (got %r)" % (hp.pipeline_type,))
    try:
        validate_encdec_config(cfg, hp)
    except ValueError as e:
        out.append(str(e))
    return out


class T5Def:
    """`models.base.GenericDef`'s members for T5's own tree."""

    def __init__(self, cfg: T5Config, hp: HybridParallelConfig):
        self.cfg, self.hp = cfg, hp

    def _ids(self, stage: Optional[int]) -> List[int]:
        if stage is None or self.hp.pp == 1:
            return list(range(self.cfg.num_layers))
        return list(self.hp.layers_of_stage(stage))

    def tree(self, device, stage: Optional[int] = None) -> T5Model:
        return T5Model(self.cfg, device, None if stage is None else self._ids(stage))

    def init_param_(self, name, p, generator) -> None:
        init_param_(name, p, self.cfg, generator)

    def param_layouts(self) -> Dict[str, M.ParamLayout]:
        return t5_param_layouts(self.cfg, self.hp)

    def build_layouts(self, mesh: RankMesh) -> M.ModelLayouts:
        cfg, hp = self.cfg, self.hp
        pls = self.param_layouts()
        vocab = M.make_layout(cfg, hp, mesh, pls, vocab_axes(hp), "", hp.vocab_tp, kv=False,
                              vocab=True)
        vocab.zero3 = {n: d for n, d in vocab.zero3.items() if "layers." not in n}
        layers = [M.make_layout(cfg, hp, mesh, pls, layer_axes(hp, i), _prefix(cfg, i),
                                hp.layers[i].tp, kv=False) for i in range(cfg.num_layers)]
        return M.ModelLayouts(vocab=vocab, layers=layers)

    def shared(self) -> Dict[str, Tuple[int, ...]]:
        hp, cfg = self.hp, self.cfg
        if hp.pp == 1:
            return {}
        stage_of, ne = hp.stage_of_layer, cfg.num_enc_layers
        holders = {
            "embed.wte": {stage_of[0], stage_of[ne]} | (
                {hp.pp - 1} if cfg.tie_embeddings else set()),
            "enc_rel_bias": {stage_of[i] for i in range(ne)},
            "dec_rel_bias": {stage_of[i] for i in range(ne, cfg.num_layers)},
        }
        return {n: tuple(sorted(s)) for n, s in holders.items() if len(s) > 1}

    def loss(self, params, batch, layouts) -> torch.Tensor:
        return t5_loss_fn(params, batch, self.cfg, self.hp, layouts)

    def stage_body(self, stage: int, params, layouts):
        ids = self._ids(stage)
        return lambda batch, x_in: t5_stage(params, batch, self.cfg, ids, x_in, hp=self.hp,
                                            layouts=layouts)

    def boundary(self, mbs, mesh: RankMesh):
        """Each tensor a stage sends: (rows, its sequence shard in the vocab
        layout, hidden); one (``h`` or ``mem``) out of an encoder stage,
        two (``h``, ``mem``) out of a decoder stage."""
        cfg, vax = self.cfg, vocab_axes(self.hp)
        seq = mesh.size(vax.seq_axes)

        def boundary(mb: int, stage: int):
            last_layer = self._ids(stage)[-1]
            key = "tokens" if last_layer < cfg.num_enc_layers else "dec_tokens"
            rows, length = mbs[mb][key].shape[:2]
            shapes = [(rows, length // seq, cfg.hidden_size)]
            if last_layer >= cfg.num_enc_layers:
                rows, length = mbs[mb]["tokens"].shape[:2]
                shapes.append((rows, length // seq, cfg.hidden_size))
            return [(s, cfg.compute_dtype) for s in shapes]
        return boundary


def t5_layer_configs(cfg: T5Config) -> List[dict]:
    """The search's two layer types: the encoder layer and the decoder
    layer, both at ``max_seq_len``."""
    return [
        {"hidden_size": cfg.hidden_size, "seq_len": cfg.max_seq_len, "layer_num": cfg.num_enc_layers},
        {"hidden_size": cfg.hidden_size, "seq_len": cfg.max_seq_len, "layer_num": cfg.num_dec_layers},
    ]
