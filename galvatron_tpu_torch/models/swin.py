"""Swin Transformer family: hierarchical window attention.

Port of ``galvatron_tpu/models/swin.py`` (HF ``SwinForImageClassification``):
a patch embedding (a dense on 4x4 patches, then LayerNorm) to a (H, W, C)
grid; stages of blocks, each window attention (fp32 logits with a
relative-position bias per block, every other block on windows shifted by
half a window, masked across the shift's seams) and a gelu MLP; a 2x2
patch merge between stages (HF's concat order, LayerNorm, a reduction
dense: half the resolution, twice the width); the final LayerNorm, mean
pooling and a classification head. A stage's window is ``min(window,
resolution)``, with no shift when it covers the stage. Window attention is
computed inline, as in the reference: it never calls ``core_attention``.

The parameter tree is the reference's: ``embed.patch.{kernel,bias}``,
``embed.norm``, ``blocks.<i>.{ln1,ln2}.{scale,bias}``,
``blocks.<i>.wqkv.kernel (c, 3, nh, hd)`` (+ bias), ``...wo``, ``...wi``,
``...wo_mlp`` (kernels and biases), ``blocks.<i>.rel_bias ((2w-1)^2, nh)``,
``merges.<s>.norm`` and ``merges.<s>.reduction.kernel (4c, 2c)``,
``final_norm`` and ``head``. ``hp.layers`` indexes the blocks across the
stages.

Under a strategy (`SwinDef`) each block runs its own DP / ZeRO-2 / ZeRO-3 /
Megatron TP over heads (``wqkv``, ``rel_bias`` and ``wi``'s bias shard
over tp), as the reference's specs place them; activations are batch-sharded
only (windowed attention has no sequence to shard: cp and Ulysses are
refused at any pp, and Megatron-SP does not apply). A patch merge runs in
the layout of the block before it. Under a pipeline (1F1B, equal
divisions) a boundary may fall inside a stage or after a merge: each
boundary carries the (rows, H, W, C) activation of its own resolution.

The HF bridge (`swin_config_from_hf`, `convert_hf_swin`, `export_hf_swin`)
maps SwinForImageClassification's stage blocks (each with its own relative
table) and downsample layers onto ``blocks`` and ``merges``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.models.hf_utils import params_state, stack_qkv, to_np, to_state_dict, to_t
from galvatron_tpu_torch.ops.norms import layer_norm
from galvatron_tpu_torch.parallel import spec as S
from galvatron_tpu_torch.parallel import tensor_parallel as T
from galvatron_tpu_torch.parallel.mesh import RankMesh, layer_axes, vocab_axes

META_CONFIGS = {
    "swin-test": dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 2, 2),
                      image_size=64, window=4, num_classes=10),
    "swin-tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin-base": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin-large": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "swin-huge": dict(embed_dim=320, depths=(2, 2, 26, 2), num_heads=(10, 20, 40, 80), window=14),
}


@dataclass
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    window: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layernorm_eps: float = 1e-5
    num_classes: int = 1000
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    init_std: float = 0.02

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError("image_size %d not divisible by patch_size %d"
                             % (self.image_size, self.patch_size))
        for s in range(len(self.depths)):
            res = self.stage_resolution(s)
            w = min(self.window, res)
            if res % w != 0:
                raise ValueError(
                    "stage %d resolution %d not divisible by window %d (HF pads; pick "
                    "image_size/patch_size/window so every stage tiles)" % (s, res, w))

    @property
    def num_layers(self) -> int:
        return int(sum(self.depths))

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_resolution(self, s: int) -> int:
        return self.image_size // self.patch_size // (2 ** s)

    def stage_of_block(self, i: int) -> int:
        for s, d in enumerate(np.cumsum(self.depths)):
            if i < d:
                return s
        raise IndexError(i)

    def merges_after(self, i: int) -> bool:
        """True when a patch merge follows block `i` (the last block of
        every stage but the last)."""
        s = self.stage_of_block(i)
        return s < self.num_stages - 1 and i == int(np.sum(self.depths[:s + 1])) - 1

    # generic-model metadata (not fields)
    head_type = "classification"
    input_type = "patches"


def swin_config(model_size: str = "swin-tiny", **overrides) -> SwinConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(overrides)
    return SwinConfig(**base)


def swin_config_from_hf(hf_config, num_classes: int = 1000, **overrides) -> SwinConfig:
    return SwinConfig(
        embed_dim=hf_config.embed_dim,
        depths=tuple(hf_config.depths),
        num_heads=tuple(hf_config.num_heads),
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_channels=hf_config.num_channels,
        window=hf_config.window_size,
        mlp_ratio=hf_config.mlp_ratio,
        qkv_bias=hf_config.qkv_bias,
        layernorm_eps=hf_config.layer_norm_eps,
        num_classes=num_classes,
        **overrides,
    )


# ================================================================= parameters
class LayerNorm(nn.Module):
    def __init__(self, dim: int, cfg: SwinConfig, device):
        super().__init__()
        self.scale = M._param((dim,), cfg, device)
        self.bias = M._param((dim,), cfg, device)


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, device):
        super().__init__()
        c, nh = cfg.stage_dim(stage), cfg.num_heads[stage]
        w = min(cfg.window, cfg.stage_resolution(stage))
        ff = int(c * cfg.mlp_ratio)
        self.ln1 = LayerNorm(c, cfg, device)
        self.ln2 = LayerNorm(c, cfg, device)
        self.wqkv = M.Dense((c, 3, nh, c // nh), (3, nh, c // nh) if cfg.qkv_bias else None,
                            cfg, device)
        self.wo = M.Dense((c, c), (c,), cfg, device)
        self.wi = M.Dense((c, ff), (ff,), cfg, device)
        self.wo_mlp = M.Dense((ff, c), (c,), cfg, device)
        self.rel_bias = M._param(((2 * w - 1) ** 2, nh), cfg, device)


class PatchMerge(nn.Module):
    def __init__(self, cfg: SwinConfig, stage: int, device):
        super().__init__()
        c = cfg.stage_dim(stage)
        self.norm = LayerNorm(4 * c, cfg, device)
        self.reduction = M.Dense((4 * c, 2 * c), None, cfg, device)


class SwinEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, device):
        super().__init__()
        dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch = M.Dense((dim, cfg.embed_dim), (cfg.embed_dim,), cfg, device)
        self.norm = LayerNorm(cfg.embed_dim, cfg, device)


class SwinModel(nn.Module):
    """The parameter tree, or with `block_ids` a pipeline stage's part: its
    blocks (keyed by their global index), the merges that follow them, the
    embedding on the first stage, the final norm and head on the last."""

    def __init__(self, cfg: SwinConfig, device, block_ids: Optional[Sequence[int]] = None):
        super().__init__()
        ids = list(range(cfg.num_layers)) if block_ids is None else list(block_ids)
        self.embed = SwinEmbed(cfg, device) if 0 in ids else None
        self.blocks = nn.ModuleDict({str(i): SwinBlock(cfg, cfg.stage_of_block(i), device)
                                     for i in ids})
        self.merges = nn.ModuleDict({str(cfg.stage_of_block(i)): PatchMerge(
            cfg, cfg.stage_of_block(i), device) for i in ids if cfg.merges_after(i)})
        last, c = cfg.num_layers - 1 in ids, cfg.stage_dim(cfg.num_stages - 1)
        self.final_norm = LayerNorm(c, cfg, device) if last else None
        self.head = M.Dense((c, cfg.num_classes), (cfg.num_classes,), cfg, device) \
            if last else None


def init_param_(name: str, p: torch.Tensor, cfg: SwinConfig, generator: torch.Generator) -> None:
    """Normal kernels and relative tables at ``init_std``, unit norm scales,
    zero biases (the reference's initializer)."""
    parts = name.split(".")
    if parts[-1] == "scale":
        p.fill_(1.0)
    elif parts[-1] == "bias":
        p.zero_()
    else:
        M._normal_(p, cfg.init_std, generator)


@torch.no_grad()
def init_swin_params(cfg: SwinConfig, generator: torch.Generator, device=None) -> SwinModel:
    device = torch.device(device) if device is not None else generator.device
    model = SwinModel(cfg, device)
    for name, p in model.named_parameters():
        init_param_(name, p, cfg, generator)
    return model


# ============================================================ window machinery
@functools.lru_cache(maxsize=None)
def _rel_index_np(w: int) -> np.ndarray:
    """Standard Swin relative-position index: (w*w, w*w) into a (2w-1)^2
    table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))  # (2, w, w)
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # (w*w, w*w, 2)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_mask_np(h: int, wdt: int, w: int, s: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask for shifted-window attention."""
    img = np.zeros((h, wdt))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // w, w, wdt // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff == 0, 0.0, -1e9).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, w*w, C)."""
    b, h, wdt, c = x.shape
    x = x.reshape(b, h // w, w, wdt // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // w) * (wdt // w), w * w, c)


def window_unpartition(x: torch.Tensor, w: int, h: int, wdt: int) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // w, wdt // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wdt, c)


def _ln(x, p: LayerNorm, cfg: SwinConfig):
    return layer_norm(x, p.scale, p.bias, cfg.layernorm_eps)


def block_forward(p, x: torch.Tensor, cfg: SwinConfig, stage: int, shift: bool,
                  tp: Optional[T.TPContext] = None) -> torch.Tensor:
    """One block on (B, H, W, C) activations; under tp the rank's heads
    (``wqkv``, ``rel_bias``), its MLP columns, and the row-parallel outputs
    all-reduced."""
    dtype = cfg.compute_dtype
    b, h, wdt, c = x.shape
    hd = c // cfg.num_heads[stage]
    w = min(cfg.window, min(h, wdt))
    s = w // 2 if (shift and w < min(h, wdt)) else 0

    shortcut = x
    y = _ln(x, p.ln1, cfg)
    if s:
        y = torch.roll(y, (-s, -s), dims=(1, 2))
    wins = T.enter_column(window_partition(y, w), tp)  # (B, nW, w*w, C)
    qkv = M._proj(wins, p.wqkv, dtype)  # (B, nW, w*w, 3, heads, hd)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * (hd ** -0.5)
    index = torch.as_tensor(_rel_index_np(w), device=x.device)
    logits = logits + p.rel_bias.float()[index].permute(2, 0, 1)[None, None]
    if s:
        mask = torch.as_tensor(_shift_mask_np(h, wdt, w, s), device=x.device)
        logits = logits + mask[None, :, None]
    probs = torch.softmax(logits, dim=-1).to(dtype)
    attn = torch.einsum("bnhqk,bnkhd->bnqhd", probs, v)
    attn = M._row_proj(attn.reshape(b, -1, w * w, attn.shape[3] * hd), p.wo, dtype, tp)
    y = window_unpartition(attn, w, h, wdt)
    if s:
        y = torch.roll(y, (s, s), dims=(1, 2))
    x = shortcut + y

    y = M._proj(T.enter_column(_ln(x, p.ln2, cfg), tp), p.wi, dtype)
    return x + M._row_proj(F.gelu(y), p.wo_mlp, dtype, tp)


def patch_merge(p: PatchMerge, x: torch.Tensor, cfg: SwinConfig) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 2C): concat 2x2 neighbours (HF order:
    [0::2,0::2], [1::2,0::2], [0::2,1::2], [1::2,1::2]) -> LN -> reduction."""
    y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    return M._proj(_ln(y, p.norm, cfg), p.reduction, cfg.compute_dtype)


def swin_stage(params: SwinModel, batch: dict, cfg: SwinConfig, ids: Sequence[int],
               x_in: Optional[Tuple[torch.Tensor, ...]] = None, *,
               hp: Optional[HybridParallelConfig] = None,
               layouts: Optional[M.ModelLayouts] = None, logits: bool = False):
    """The blocks `ids` of one pipeline stage (every block: the whole
    model) and the merges after them: the patch embedding on the first
    stage, ``(x,)`` (B, H, W, C) out of a stage, the loss (with `logits`
    the class logits) out of the last one. Each block and the merge after
    it run in the block's layout."""
    dtype = cfg.compute_dtype
    vocab = layouts.vocab if layouts is not None else None
    if 0 in ids:
        e = params.embed
        x = _ln(M._proj(M.patchify(batch["pixels"].to(dtype), cfg.patch_size), e.patch, dtype),
                e.norm, cfg)
        res = cfg.stage_resolution(0)
        x = x.reshape(x.shape[0], res, res, cfg.embed_dim)
    else:
        x = x_in[0]
    cur = vocab.act if vocab is not None else None
    for i in ids:
        lay = layouts.layers[i] if layouts is not None else None
        if lay is not None:
            x = S.relayout(x, lay.mesh, cur, lay.act)
            cur = lay.act
        stage = cfg.stage_of_block(i)
        shift = (i - int(np.sum(cfg.depths[:stage]))) % 2 == 1

        def fwd(x_, _p=params.blocks[str(i)], _lay=lay, _stage=stage, _shift=shift):
            return block_forward(M.gathered(_p, _lay), x_, cfg, _stage, _shift,
                                 _lay.tp if _lay is not None else None)
        policy = hp.layers[i].effective_remat_policy if hp is not None else "none"
        x = fwd(x) if policy == "none" or not torch.is_grad_enabled() else M._remat(fwd, policy)(x)
        if cfg.merges_after(i):
            x = patch_merge(params.merges[str(stage)], x, cfg)
    if vocab is not None:
        x = S.relayout(x, vocab.mesh, cur, vocab.act)
    if cfg.num_layers - 1 not in ids:
        return (x,)
    x = _ln(x.reshape(x.shape[0], -1, x.shape[-1]), params.final_norm, cfg)
    out = M._proj(x.mean(dim=1), params.head, dtype)
    return out if logits else M.classification_loss(out, batch["labels"], vocab)


def swin_loss_fn(params: SwinModel, batch: dict, cfg: SwinConfig,
                 hp: Optional[HybridParallelConfig] = None,
                 layouts: Optional[M.ModelLayouts] = None) -> torch.Tensor:
    """batch: dict(pixels (B, H, W, C), labels (B,)) -> mean softmax cross
    entropy over the classes (with `layouts`: this rank's share)."""
    return swin_stage(params, batch, cfg, range(cfg.num_layers), hp=hp, layouts=layouts)


def swin_forward(params: SwinModel, pixels: torch.Tensor, cfg: SwinConfig) -> torch.Tensor:
    """The unsharded class logits of (B, H, W, C) pixels (the reference's
    ``swin_forward``)."""
    return swin_stage(params, {"pixels": pixels}, cfg, range(cfg.num_layers), logits=True)


# =============================================================== HF bridge
_SWIN_DENSE = (("wo", "attention.output.dense"), ("wi", "intermediate.dense"),
               ("wo_mlp", "output.dense"))
_SWIN_NORMS = (("ln1", "layernorm_before"), ("ln2", "layernorm_after"))
_SWIN_TOP = (("embed.patch.bias", "swin.embeddings.patch_embeddings.projection.bias"),
             ("embed.norm.scale", "swin.embeddings.norm.weight"),
             ("embed.norm.bias", "swin.embeddings.norm.bias"),
             ("final_norm.scale", "swin.layernorm.weight"),
             ("final_norm.bias", "swin.layernorm.bias"), ("head.bias", "classifier.bias"))


def _hf_blocks(cfg: SwinConfig):
    """(block index, its HF prefix, width, heads) of every block."""
    for i in range(cfg.num_layers):
        stage = cfg.stage_of_block(i)
        d = i - int(np.sum(cfg.depths[:stage]))
        yield (i, "swin.encoder.layers.%d.blocks.%d." % (stage, d), cfg.stage_dim(stage),
               cfg.num_heads[stage])


def convert_hf_swin(state_dict: Dict[str, Any], cfg: SwinConfig) -> Dict[str, torch.Tensor]:
    """HF SwinForImageClassification state dict -> the port's state dict
    (fp32)."""
    g = lambda n: to_t(state_dict[n])
    p = cfg.patch_size
    conv = g("swin.embeddings.patch_embeddings.projection.weight")  # (E, C, P, P)
    out = {mine: g(theirs) for mine, theirs in _SWIN_TOP}
    out["embed.patch.kernel"] = conv.permute(2, 3, 1, 0).reshape(p * p * cfg.num_channels,
                                                                    cfg.embed_dim)
    out["head.kernel"] = g("classifier.weight").T
    for i, pre, c, nh in _hf_blocks(cfg):
        dst = "blocks.%d." % i
        out[dst + "wqkv.kernel"], out[dst + "wqkv.bias"] = stack_qkv(
            state_dict, pre + "attention.self.", c, nh, c // nh)
        out[dst + "rel_bias"] = g(pre + "attention.self.relative_position_bias_table")
        for mine, theirs in _SWIN_DENSE:
            out[dst + mine + ".kernel"] = g(pre + theirs + ".weight").T
            out[dst + mine + ".bias"] = g(pre + theirs + ".bias")
        for mine, theirs in _SWIN_NORMS:
            out[dst + mine + ".scale"] = g(pre + theirs + ".weight")
            out[dst + mine + ".bias"] = g(pre + theirs + ".bias")
    for s in range(cfg.num_stages - 1):
        pre = "swin.encoder.layers.%d.downsample." % s
        out["merges.%d.norm.scale" % s] = g(pre + "norm.weight")
        out["merges.%d.norm.bias" % s] = g(pre + "norm.bias")
        out["merges.%d.reduction.kernel" % s] = g(pre + "reduction.weight").T
    return to_state_dict(out)


def export_hf_swin(params, cfg: SwinConfig) -> Dict[str, np.ndarray]:
    """The port's parameters -> HF SwinForImageClassification state-dict
    arrays (fp32): the inverse of `convert_hf_swin`."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    p, c0, e = cfg.patch_size, cfg.num_channels, cfg.embed_dim
    out = {theirs: a(mine) for mine, theirs in _SWIN_TOP}
    out["swin.embeddings.patch_embeddings.projection.weight"] = a(
        "embed.patch.kernel").reshape(p, p, c0, e).transpose(3, 2, 0, 1)
    out["classifier.weight"] = a("head.kernel").T
    for i, pre, c, nh in _hf_blocks(cfg):
        src = "blocks.%d." % i
        qkv, qkv_b = a(src + "wqkv.kernel"), a(src + "wqkv.bias")
        for j, role in enumerate(("query", "key", "value")):
            out[pre + "attention.self.%s.weight" % role] = qkv[:, j].reshape(c, c).T
            out[pre + "attention.self.%s.bias" % role] = qkv_b[j].reshape(c)
        out[pre + "attention.self.relative_position_bias_table"] = a(src + "rel_bias")
        for mine, theirs in _SWIN_DENSE:
            out[pre + theirs + ".weight"] = a(src + mine + ".kernel").T
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
        for mine, theirs in _SWIN_NORMS:
            out[pre + theirs + ".weight"] = a(src + mine + ".scale")
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
    for s in range(cfg.num_stages - 1):
        pre = "swin.encoder.layers.%d.downsample." % s
        out[pre + "norm.weight"] = a("merges.%d.norm.scale" % s)
        out[pre + "norm.bias"] = a("merges.%d.norm.bias" % s)
        out[pre + "reduction.weight"] = a("merges.%d.reduction.kernel" % s).T
    return out


# ================================================================ layouts
def _block_placements(cfg: SwinConfig, ax) -> Dict[str, Tuple[S.Spec, Optional[int]]]:
    """(placement, the dim ZeRO-3 shards) of a block's parameters: the
    reference's ``block_param_specs`` (norms and out biases replicated,
    ZeRO-3 on the kernels only)."""
    (z3, tp), row = S.col_kernel_spec(ax), S.row_kernel_spec(ax)
    r1 = (S.replicated_spec(1), None)
    out = {"ln1.scale": r1, "ln1.bias": r1, "ln2.scale": r1, "ln2.bias": r1,
           "wqkv.kernel": ((z3, (), tp, ()), 0), "wo.kernel": (row, 1), "wo.bias": r1,
           "wi.kernel": ((z3, tp), 0), "wi.bias": ((tp,), None), "wo_mlp.kernel": (row, 1),
           "wo_mlp.bias": r1, "rel_bias": (((), tp), None)}
    if cfg.qkv_bias:
        out["wqkv.bias"] = (((), tp, ()), None)
    return out


def swin_param_layouts(cfg: SwinConfig, hp: HybridParallelConfig) -> Dict[str, M.ParamLayout]:
    vax = vocab_axes(hp)
    rep = {"embed.patch.kernel": 2, "embed.patch.bias": 1, "embed.norm.scale": 1,
           "embed.norm.bias": 1, "final_norm.scale": 1, "final_norm.bias": 1, "head.kernel": 2,
           "head.bias": 1}
    out = {n: M._param_layout(S.replicated_spec(d), None, vax, False) for n, d in rep.items()}
    for i in range(cfg.num_layers):
        ax = layer_axes(hp, i)
        for n, (spec, z3_dim) in _block_placements(cfg, ax).items():
            out["blocks.%d.%s" % (i, n)] = M._param_layout(spec, z3_dim, ax, False)
        if cfg.merges_after(i):
            s = cfg.stage_of_block(i)
            for n, d in (("norm.scale", 1), ("norm.bias", 1), ("reduction.kernel", 2)):
                out["merges.%d.%s" % (s, n)] = M._param_layout(S.replicated_spec(d), None, ax,
                                                               False)
    return out


def validate_swin_config(cfg: SwinConfig, hp: HybridParallelConfig) -> None:
    """The reference's rules: cp and Ulysses-sp do not apply at any pp
    (windowed attention has no sequence dimension); the 1F1B engine wants
    equal layers per stage."""
    for s in hp.layers:
        if s.cp > 1 or s.sp:
            raise ValueError(
                "swin windowed attention has no sequence dimension to shard: cp / "
                "ulysses-sp do not apply (strategy %r)" % (s,))
    if hp.pp <= 1:
        return
    div = hp.pp_division
    if len(set(div)) != 1:
        raise ValueError("swin 1F1B requires equal layers per stage, got pp_division=%s"
                         % (div,))


def swin_refusals(cfg: SwinConfig, hp: HybridParallelConfig) -> List[str]:
    """The reference's refusals for Swin (its block count,
    `validate_swin_config`, GPipe, heads that tp does not divide), then the
    vocab sequence sharding that has no sequence to shard here."""
    if len(hp.layers) != cfg.num_layers:
        return ["hp covers %d layers but swin has %d blocks (depths %s)"
                % (len(hp.layers), cfg.num_layers, list(cfg.depths))]
    out = []
    try:
        validate_swin_config(cfg, hp)
    except ValueError as e:
        out.append(str(e))
    for i, ls in enumerate(hp.layers):
        nh = cfg.num_heads[cfg.stage_of_block(i)]
        if ls.tp > 1 and nh % ls.tp != 0:
            out.append("block %d (stage %d) has %d heads, not divisible by tp=%d"
                       % (i, cfg.stage_of_block(i), nh, ls.tp))
    if hp.pp > 1 and hp.pipeline_type != "pipedream_flush":
        out.append("swin pipeline parallelism runs the hierarchical 1F1B engine: set "
                   "pipeline_type='pipedream_flush' (got %r)" % (hp.pipeline_type,))
    if hp.vocab_cp > 1 or (hp.vocab_sp and hp.vocab_tp > 1):
        out.append("swin has no token sequence for vocab sp / cp to shard")
    return out


class SwinDef:
    """`models.base.GenericDef`'s members for Swin's own tree."""

    def __init__(self, cfg: SwinConfig, hp: HybridParallelConfig):
        self.cfg, self.hp = cfg, hp

    def _ids(self, stage: Optional[int]) -> List[int]:
        if stage is None or self.hp.pp == 1:
            return list(range(self.cfg.num_layers))
        return list(self.hp.layers_of_stage(stage))

    def tree(self, device, stage: Optional[int] = None) -> SwinModel:
        return SwinModel(self.cfg, device, None if stage is None else self._ids(stage))

    def init_param_(self, name, p, generator) -> None:
        init_param_(name, p, self.cfg, generator)

    def param_layouts(self) -> Dict[str, M.ParamLayout]:
        return swin_param_layouts(self.cfg, self.hp)

    def build_layouts(self, mesh: RankMesh) -> M.ModelLayouts:
        """The generic layouts with (B, H, W, C) activations sharded over
        the batch only, and tp without Megatron-SP."""
        cfg, hp = self.cfg, self.hp
        pls = self.param_layouts()

        def grid(lay):
            return dataclasses.replace(lay, act=(tuple(lay.axes.dp), (), (), ()),
                                       tp=dataclasses.replace(lay.tp, sequence_parallel=False))
        vocab = M.make_layout(cfg, hp, mesh, pls, vocab_axes(hp), "", hp.vocab_tp, kv=False,
                              vocab=True)
        vocab.zero3 = {}
        layers = [grid(M.make_layout(cfg, hp, mesh, pls, layer_axes(hp, i), "blocks.%d." % i,
                                     hp.layers[i].tp, kv=False))
                  for i in range(cfg.num_layers)]
        return M.ModelLayouts(vocab=grid(vocab), layers=layers)

    def shared(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def loss(self, params, batch, layouts) -> torch.Tensor:
        return swin_loss_fn(params, batch, self.cfg, self.hp, layouts)

    def stage_body(self, stage: int, params, layouts):
        ids = self._ids(stage)
        return lambda batch, x_in: swin_stage(params, batch, self.cfg, ids, x_in, hp=self.hp,
                                              layouts=layouts)

    def boundary(self, mbs, mesh: RankMesh):
        """The (rows, H, W, C) activation out of a stage: the resolution and
        width of the Swin stage of its last block, or of the next one where
        a merge follows that block."""
        cfg = self.cfg

        def boundary(mb: int, stage: int):
            i = self._ids(stage)[-1]
            t = cfg.stage_of_block(i) + cfg.merges_after(i)
            res = cfg.stage_resolution(t)
            rows = mbs[mb]["pixels"].shape[0]
            return [((rows, res, res, cfg.stage_dim(t)), cfg.compute_dtype)]
        return boundary


def swin_layer_configs(cfg: SwinConfig) -> List[dict]:
    """One layer type per stage, with the stage's own width and token count
    (the reference's per-stage layer lists and sequence lengths)."""
    return [{"hidden_size": cfg.stage_dim(s), "seq_len": cfg.stage_resolution(s) ** 2,
             "layer_num": cfg.depths[s]} for s in range(cfg.num_stages)]
