"""BERT family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/bert.py`` (META_CONFIGS, bert_config): a
post-norm bidirectional encoder (LayerNorm eps 1e-12 after each residual
add, exact gelu), learned positions and token-type embeddings summed and
normed before the first layer, and the MLM head (a dense transform, exact
gelu, LayerNorm, then the decoder tied to the token table plus a vocab
bias); vocab 30522, two token types. Its HF bridge
(`bert_config_from_hf`, `convert_hf_bert`, `export_hf_bert`) maps
BertForMaskedLM's separate q/k/v onto the fused head-major ``wqkv``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from galvatron_tpu_torch.models.base import TransformerConfig
from galvatron_tpu_torch.models.hf_utils import (linear, params_state, stack_qkv, to_np,
                                                 to_state_dict, to_t)

META_CONFIGS = {
    "bert-base": dict(hidden_size=768, num_heads=12, num_layers=12, max_seq_len=512),
    "bert-large": dict(hidden_size=1024, num_heads=16, num_layers=24, max_seq_len=512),
    "bert-huge-32": dict(hidden_size=1280, num_heads=16, num_layers=32, max_seq_len=512),
    "bert-huge-48": dict(hidden_size=1280, num_heads=16, num_layers=48, max_seq_len=512),
}


def bert_config(model_size: str = "bert-base", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(
        vocab_size=30522,
        type_vocab_size=2,
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=False,
        embed_norm=True,
        head_type="mlm",
        tie_embeddings=True,
        qkv_bias=True,
        mlp_bias=True,
        out_bias=True,
        layernorm_eps=1e-12,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def bert_config_from_hf(hf_config, **overrides) -> TransformerConfig:
    return TransformerConfig(
        hidden_size=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_layers=hf_config.num_hidden_layers,
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        ffn_hidden=hf_config.intermediate_size,
        type_vocab_size=hf_config.type_vocab_size,
        norm_type="layernorm",
        activation="gelu_exact",
        position_type="learned",
        causal=False,
        pre_norm=False,
        embed_norm=True,
        head_type="mlm",
        layernorm_eps=hf_config.layer_norm_eps,
        **overrides,
    )


# (tree name, HF name) of each layer's dense kernels and biases and norms
_BERT_DENSE = (("wo", "attention.output.dense"), ("wi", "intermediate.dense"),
               ("wo_mlp", "output.dense"))
_BERT_NORMS = (("ln1", "attention.output.LayerNorm"), ("ln2", "output.LayerNorm"))
_BERT_EMBED = (("embed.wte", "bert.embeddings.word_embeddings.weight"),
               ("embed.wpe", "bert.embeddings.position_embeddings.weight"),
               ("embed.tte", "bert.embeddings.token_type_embeddings.weight"),
               ("embed.norm.scale", "bert.embeddings.LayerNorm.weight"),
               ("embed.norm.bias", "bert.embeddings.LayerNorm.bias"),
               ("head.norm.scale", "cls.predictions.transform.LayerNorm.weight"),
               ("head.norm.bias", "cls.predictions.transform.LayerNorm.bias"),
               ("head.bias", "cls.predictions.bias"))


def convert_hf_bert(state_dict: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """HF BertForMaskedLM state dict -> the port's state dict (fp32)."""
    g = lambda n: to_t(state_dict[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    out = {mine: g(theirs) for mine, theirs in _BERT_EMBED}
    for i in range(cfg.num_layers):
        pre, dst = "bert.encoder.layer.%d." % i, "layers.%d." % i
        out[dst + "wqkv.kernel"], out[dst + "wqkv.bias"] = stack_qkv(
            state_dict, pre + "attention.self.", h, nh, hd)
        for mine, theirs in _BERT_DENSE:
            out[dst + mine + ".kernel"], out[dst + mine + ".bias"] = linear(state_dict,
                                                                           pre + theirs)
        for mine, theirs in _BERT_NORMS:
            out[dst + mine + ".scale"] = g(pre + theirs + ".weight")
            out[dst + mine + ".bias"] = g(pre + theirs + ".bias")
    out["head.transform.kernel"], out["head.transform.bias"] = linear(
        state_dict, "cls.predictions.transform.dense")
    return to_state_dict(out)


def export_hf_bert(params, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """The port's parameters -> HF BertForMaskedLM state-dict arrays
    (fp32), the tied decoder and its bias included."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    out = {theirs: a(mine) for mine, theirs in _BERT_EMBED}
    out.update({"cls.predictions.transform.dense.weight": a("head.transform.kernel").T,
                "cls.predictions.transform.dense.bias": a("head.transform.bias"),
                "cls.predictions.decoder.weight": a("embed.wte"),
                "cls.predictions.decoder.bias": a("head.bias")})
    for i in range(cfg.num_layers):
        pre, src = "bert.encoder.layer.%d." % i, "layers.%d." % i
        qkv, qkv_b = a(src + "wqkv.kernel"), a(src + "wqkv.bias")
        for j, role in enumerate(("query", "key", "value")):
            out[pre + "attention.self.%s.weight" % role] = qkv[:, j].reshape(h, nh * hd).T
            out[pre + "attention.self.%s.bias" % role] = qkv_b[j].reshape(nh * hd)
        for mine, theirs in _BERT_DENSE:
            out[pre + theirs + ".weight"] = a(src + mine + ".kernel").T
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
        for mine, theirs in _BERT_NORMS:
            out[pre + theirs + ".weight"] = a(src + mine + ".scale")
            out[pre + theirs + ".bias"] = a(src + mine + ".bias")
    return out
