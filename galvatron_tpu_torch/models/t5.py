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
Megatron TP (+SP), and the embedding, the head and the loss run
vocab-parallel, as in ``models.base``. A layer reads the encoder output
(``mem``) with its batch rows and the whole sequence, replicated over its
tp group. The relative tables are replicated: each rank's gradient covers
its rows and its heads, so it is summed over every axis of the stage.
Under a pipeline (1F1B only, the encoder/decoder boundary on a stage
boundary) each stage holds its own layers; the first stage, the first
decoder stage and, tied, the last stage hold ``embed.wte``, and every
stage of a stack holds that stack's table: `T5Def.shared` names them, and
their gradients are summed over the stages that hold them.

The HF converters (``convert_hf_t5`` / ``export_hf_t5`` /
``t5_config_from_hf``) wait for the checkpoint-conversion slice (ROADMAP
queue 1 item 9b).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.ops.attention import core_attention
from galvatron_tpu_torch.ops.norms import rms_norm
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
def _buckets(sq: int, sk: int, bidirectional: bool, num_buckets: int, max_distance: int,
             device: str) -> torch.Tensor:
    """The (sq, sk) bucket of every query/key pair, computed once on the
    CPU (so every device gets the same integers) and cached per device."""
    rel = torch.arange(sk)[None, :] - torch.arange(sq)[:, None]
    return relative_position_bucket(rel, bidirectional=bidirectional, num_buckets=num_buckets,
                                    max_distance=max_distance).to(device)


def rel_bias(table: torch.Tensor, sq: int, sk: int, cfg: T5Config, *,
             bidirectional: bool) -> torch.Tensor:
    """(buckets, heads) table -> (1, heads, sq, sk) fp32 additive bias."""
    bucket = _buckets(sq, sk, bidirectional, cfg.rel_buckets, cfg.rel_max_distance,
                      str(table.device))
    return table.float()[bucket].permute(2, 0, 1)[None]


# ================================================================== forward
def _rms(x, p, cfg: T5Config):
    return rms_norm(x, p.scale, cfg.layernorm_eps)


def _attend(p, q_in, kv_in, cfg: T5Config, *, causal: bool, bias, tp) -> torch.Tensor:
    """q from `q_in`, k/v from `kv_in` (both the whole sequence, the rank's
    heads under tp), attention at scale 1, the row-parallel out
    projection."""
    dtype = cfg.compute_dtype
    q = M._proj(q_in, p.wq, dtype)
    k = M._proj(kv_in, p.wk, dtype)
    v = M._proj(kv_in, p.wv, dtype)
    attn = core_attention(q, k, v, causal=causal, sm_scale=1.0, bias=bias, impl=cfg.attn_impl)
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


def enc_layer_forward(p, x, cfg: T5Config, bias, tp: Optional[T.TPContext] = None):
    y = T.enter_column(_rms(x, p.ln1, cfg), tp)
    x = x + _attend(p, y, y, cfg, causal=False, bias=bias, tp=tp)
    return x + _mlp(p, x, cfg, tp)


def dec_layer_forward(p, x, mem, cfg: T5Config, self_bias, cross_bias=None,
                      tp: Optional[T.TPContext] = None):
    """Causal self-attention with the decoder table, cross-attention on
    `mem` (the whole encoder output of the layer's rows, replicated over
    tp: its k/v projections take the plain f of Megatron TP even under
    Megatron-SP) with only the key-padding bias, then the MLP."""
    y = T.enter_column(_rms(x, p.ln1, cfg), tp)
    x = x + _attend(p, y, y, cfg, causal=True, bias=self_bias, tp=tp)
    z = T.enter_column(_rms(x, p.ln_cross, cfg), tp)
    mem_tp = dataclasses.replace(tp, sequence_parallel=False) if tp is not None else None
    x = x + _attend(p.cross, z, T.enter_column(mem, mem_tp), cfg, causal=False, bias=cross_bias,
                    tp=tp)
    return x + _mlp(p, x, cfg, tp)


def _mem_spec(lay: M.Layout) -> S.Spec:
    """The encoder output as a decoder layer reads it: its rows, the whole
    sequence, the hidden width dense."""
    return (tuple(lay.axes.dp), (), ())


def _run_stack(params: T5Model, ids: Sequence[int], x, mem, key_bias, cfg: T5Config,
               hp: Optional[HybridParallelConfig], layouts: Optional[M.ModelLayouts]):
    """The layers `ids` (all of one stack) on `x`, each under its own
    layout and remat policy; `x` and `mem` enter and `x` leaves in the
    vocab layout, `key_bias` (B, 1, 1, S) in the vocab layers' token
    placement."""
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
        kb, m = key_bias, mem
        if lay is not None:
            x = S.relayout(x, lay.mesh, cur, lay.act)
            cur = lay.act
            kb = per_layer(("kb", lay.side), lambda: M._side_relayout(
                key_bias, lay.mesh, vocab.side, lay.side))
            if decoder:
                m = per_layer(("mem", _mem_spec(lay)), lambda: S.relayout(
                    mem, lay.mesh, vocab.act, _mem_spec(lay)))

        def heads(kb=kb):
            t = table
            if tp is not None and tp.size > 1:
                t = t.chunk(tp.size, 1)[tp.index]
            b = rel_bias(t, seq, seq, cfg, bidirectional=not decoder)
            return b if decoder or kb is None else b + kb
        heads_key = (tp.size, tp.index) if tp is not None else (1, 0)
        bias = per_layer(("bias", heads_key, lay.side if lay is not None else None), heads)

        if decoder:
            def fwd(x_, _lp=lp, _lay=lay, _m=m, _b=bias, _kb=kb):
                return dec_layer_forward(M.gathered(_lp, _lay), x_, _m, cfg, _b, _kb,
                                         _lay.tp if _lay is not None else None)
        else:
            def fwd(x_, _lp=lp, _lay=lay, _b=bias):
                return enc_layer_forward(M.gathered(_lp, _lay), x_, cfg, _b,
                                         _lay.tp if _lay is not None else None)
        policy = hp.layers[i].effective_remat_policy if hp is not None else "none"
        x = fwd(x) if policy == "none" or not torch.is_grad_enabled() else M._remat(fwd, policy)(x)
    if vocab is not None:
        x = S.relayout(x, vocab.mesh, cur, vocab.act)
    return x


def _head_loss(top, h, batch, cfg: T5Config, vocab: Optional[M.Layout]) -> torch.Tensor:
    """The decoder's final norm, the ``hidden_size**-0.5`` scale of a tied
    head, the vocab-parallel logits and the token-mean cross entropy."""
    dtype = cfg.compute_dtype
    y = _rms(h, top.dec_norm, cfg)
    if cfg.tie_embeddings:
        y = y * (cfg.hidden_size ** -0.5)
        kernel = top.embed.wte.to(dtype).t()
    else:
        kernel = top.lm_head.kernel.to(dtype)
    logits = T.enter_column(y, vocab.tp if vocab is not None else None) @ kernel
    return M.vocab_parallel_cross_entropy(logits, batch["labels"], batch.get("loss_mask"), vocab)


def t5_stage(params: T5Model, batch: dict, cfg: T5Config, ids: Sequence[int],
             x_in: Optional[Tuple[torch.Tensor, ...]] = None, *,
             hp: Optional[HybridParallelConfig] = None,
             layouts: Optional[M.ModelLayouts] = None):
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
    h = mem = None
    if not ids:  # the model at zero layers: no layer reads the encoder side
        h = M.embed_tokens(top.embed, batch["dec_tokens"], None, cfg, vocab)
        return _head_loss(top, h, batch, cfg, vocab)
    if enc:
        h = M.embed_tokens(top.embed, batch["tokens"], None, cfg, vocab) if enc[0] == 0 \
            else x_in[0]
        h = _run_stack(params, enc, h, None, key_bias, cfg, hp, layouts)
        if enc[-1] != ne - 1:
            return (h,)
        mem = _rms(h, top.enc_norm, cfg)
        if not dec:
            return (mem,)
    else:
        mem = x_in[-1]
    h = M.embed_tokens(top.embed, batch["dec_tokens"], None, cfg, vocab) if dec[0] == ne \
        else x_in[0]
    h = _run_stack(params, dec, h, mem, key_bias, cfg, hp, layouts)
    if dec[-1] == cfg.num_layers - 1:
        return _head_loss(top, h, batch, cfg, vocab)
    return h, mem


def t5_loss_fn(params: T5Model, batch: dict, cfg: T5Config,
               hp: Optional[HybridParallelConfig] = None,
               layouts: Optional[M.ModelLayouts] = None) -> torch.Tensor:
    """batch: dict(tokens [enc], dec_tokens, labels, loss_mask?, attn_mask?)
    -> the token-mean cross entropy (with `layouts`: this rank's share)."""
    return t5_stage(params, batch, cfg, range(cfg.num_layers), hp=hp, layouts=layouts)


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
    """What the reference refuses for T5 (its layer count, GPipe, the
    enc-dec pipeline contract), then what the port's T5 does not execute
    yet: cp, Ulysses, vocab sp / cp (its attention's relative bias has no
    sequence-sharded path here; ROADMAP queue 1 item 9c)."""
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
    if any(s.cp > 1 or (s.sp and s.tp > 1) for s in hp.layers) or hp.vocab_cp > 1 or (
            hp.vocab_sp and hp.vocab_tp > 1):
        out.append("t5 layers with cp or Ulysses sp, and vocab sp/cp, are not executed by "
                   "the port yet (ROADMAP queue 1 item 9c)")
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
