"""ViT family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/vit.py`` (META_CONFIGS, vit_config): a
pre-norm bidirectional encoder over 16x16 patches of a 224x224 RGB image
(196 patches and a cls token: 197 positions), LayerNorm eps 1e-12, exact
gelu, learned positions, and a classification head over 1000 classes on
the cls token after the final norm. The patch convolution is a dense on
patchified pixels (``models.base.patchify``). Its HF bridge
(`vit_config_from_hf`, `convert_hf_vit`, `export_hf_vit`) re-lays the (h,
C, P, P) patch convolution as that dense's (P*P*C, h) kernel."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from galvatron_tpu_torch.models.base import TransformerConfig
from galvatron_tpu_torch.models.hf_utils import (linear, params_state, stack_qkv, to_np,
                                                 to_state_dict, to_t)

META_CONFIGS = {
    "vit-base": dict(hidden_size=768, num_heads=12, num_layers=12),
    "vit-large": dict(hidden_size=1024, num_heads=16, num_layers=24),
    "vit-huge": dict(hidden_size=1280, num_heads=16, num_layers=32),
    "vit-xhuge": dict(hidden_size=2560, num_heads=32, num_layers=36),
}


def vit_config(model_size: str = "vit-base", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(
        vocab_size=1,  # unused for patch input
        num_classes=1000,
        image_size=224,
        patch_size=16,
        num_channels=3,
        input_type="patches",
        use_cls_token=True,
        head_type="classification",
        pool_type="cls",
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=True,
        tie_embeddings=False,
        qkv_bias=True,
        mlp_bias=True,
        out_bias=True,
        layernorm_eps=1e-12,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def vit_config_from_hf(hf_config, num_classes: int = 1000, **overrides) -> TransformerConfig:
    return TransformerConfig(
        hidden_size=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        vocab_size=1,
        ffn_hidden=hf_config.intermediate_size,
        num_classes=num_classes,
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        num_channels=hf_config.num_channels,
        input_type="patches",
        use_cls_token=True,
        head_type="classification",
        pool_type="cls",
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=True,
        tie_embeddings=False,
        layernorm_eps=hf_config.layer_norm_eps,
        **overrides,
    )


_VIT_DENSE = (("wo", "attention.output.dense"), ("wi", "intermediate.dense"),
              ("wo_mlp", "output.dense"))
_VIT_NORMS = (("ln1", "layernorm_before"), ("ln2", "layernorm_after"))


def convert_hf_vit(state_dict: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """HF ViTForImageClassification state dict -> the port's state dict
    (fp32); the conv projection (h, C, P, P) is re-laid to `patchify`'s
    (P, P, C) order and flattened to a (P*P*C, h) dense kernel."""
    g = lambda n: to_t(state_dict[n])
    h, nh, hd, p = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.patch_size
    conv = g("vit.embeddings.patch_embeddings.projection.weight")
    out = {"embed.patch.kernel": conv.permute(2, 3, 1, 0).reshape(p * p * cfg.num_channels, h),
           "embed.patch.bias": g("vit.embeddings.patch_embeddings.projection.bias"),
           "embed.wpe": g("vit.embeddings.position_embeddings")[0],
           "embed.cls_token": g("vit.embeddings.cls_token").reshape(h),
           "final_norm.scale": g("vit.layernorm.weight"), "final_norm.bias": g("vit.layernorm.bias"),
           "head.kernel": g("classifier.weight").T, "head.bias": g("classifier.bias")}
    for i in range(cfg.num_layers):
        pre, dst = "vit.encoder.layer.%d." % i, "layers.%d." % i
        out[dst + "wqkv.kernel"], out[dst + "wqkv.bias"] = stack_qkv(
            state_dict, pre + "attention.attention.", h, nh, hd)
        for mine, theirs in _VIT_DENSE:
            out[dst + mine + ".kernel"], out[dst + mine + ".bias"] = linear(state_dict,
                                                                           pre + theirs)
        for mine, theirs in _VIT_NORMS:
            out[dst + mine + ".scale"] = g(pre + theirs + ".weight")
            out[dst + mine + ".bias"] = g(pre + theirs + ".bias")
    return to_state_dict(out)


def export_hf_vit(params, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """The port's parameters -> HF ViTForImageClassification state-dict
    arrays (fp32): the inverse of `convert_hf_vit`."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    h, nh, hd, p, c = (cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.patch_size,
                       cfg.num_channels)
    out = {"vit.embeddings.patch_embeddings.projection.weight":
           a("embed.patch.kernel").reshape(p, p, c, h).transpose(3, 2, 0, 1),
           "vit.embeddings.patch_embeddings.projection.bias": a("embed.patch.bias"),
           "vit.embeddings.position_embeddings": a("embed.wpe")[None],
           "vit.embeddings.cls_token": a("embed.cls_token").reshape(1, 1, h),
           "vit.layernorm.weight": a("final_norm.scale"), "vit.layernorm.bias": a("final_norm.bias"),
           "classifier.weight": a("head.kernel").T, "classifier.bias": a("head.bias")}
    for i in range(cfg.num_layers):
        pre, src = "vit.encoder.layer.%d." % i, "layers.%d." % i
        qkv, qkv_b = a(src + "wqkv.kernel"), a(src + "wqkv.bias")
        for j, role in enumerate(("query", "key", "value")):
            out[pre + "attention.attention.%s.weight" % role] = qkv[:, j].reshape(h, nh * hd).T
            out[pre + "attention.attention.%s.bias" % role] = qkv_b[j].reshape(nh * hd)
        for mine, theirs in _VIT_DENSE:
            out[pre + theirs + ".weight"] = a(src + mine + ".kernel").T
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
        for mine, theirs in _VIT_NORMS:
            out[pre + theirs + ".weight"] = a(src + mine + ".scale")
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
    return out
