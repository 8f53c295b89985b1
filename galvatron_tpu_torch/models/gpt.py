"""GPT-2 family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/gpt.py`` (META_CONFIGS, gpt_config): the same
presets and architecture — pre-norm LayerNorm (eps 1e-5) with bias, tanh
gelu MLP, learned position embeddings, a head tied to the token embedding,
and biases on the qkv, attention-out and MLP projections; vocab 50257. Its HF
bridge (`gpt_config_from_hf`, `convert_hf_gpt2`, `export_hf_gpt2`): HF's
``Conv1D`` kernels are already (in, out), the fused ``c_attn`` reshapes to
the head-major ``wqkv (h, 3, nh, hd)``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from galvatron_tpu_torch.models.base import TransformerConfig
from galvatron_tpu_torch.models.hf_utils import params_state, to_np, to_state_dict, to_t

META_CONFIGS = {
    "gpt-0.3b": dict(hidden_size=1024, num_heads=16, num_layers=24, max_seq_len=1024),
    "gpt-1.5b": dict(hidden_size=1600, num_heads=32, num_layers=48, max_seq_len=1024, head_dim=50),
    "gpt-2.7b": dict(hidden_size=2560, num_heads=32, num_layers=32, max_seq_len=2048, head_dim=80),
    "gpt-6.7b": dict(hidden_size=4096, num_heads=32, num_layers=32, max_seq_len=2048),
}


def gpt_config(model_size: str = "gpt-0.3b", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.update(
        vocab_size=50257,
        norm_type="layernorm",
        activation="gelu",
        position_type="learned",
        causal=True,
        pre_norm=True,
        tie_embeddings=True,
        qkv_bias=True,
        mlp_bias=True,
        out_bias=True,
        layernorm_eps=1e-5,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def gpt_config_from_hf(hf_config, **overrides) -> TransformerConfig:
    return TransformerConfig(
        hidden_size=hf_config.n_embd,
        num_heads=hf_config.n_head,
        num_layers=hf_config.n_layer,
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.n_positions,
        norm_type="layernorm",
        activation="gelu",
        position_type="learned",
        layernorm_eps=hf_config.layer_norm_epsilon,
        **overrides,
    )


# (tree name, HF name) of each layer's tensors: HF's Conv1D is (in, out)
_GPT_LAYER = (("ln1.scale", "ln_1.weight"), ("ln1.bias", "ln_1.bias"),
              ("ln2.scale", "ln_2.weight"), ("ln2.bias", "ln_2.bias"),
              ("wo.kernel", "attn.c_proj.weight"), ("wo.bias", "attn.c_proj.bias"),
              ("wi.kernel", "mlp.c_fc.weight"), ("wi.bias", "mlp.c_fc.bias"),
              ("wo_mlp.kernel", "mlp.c_proj.weight"), ("wo_mlp.bias", "mlp.c_proj.bias"))


def convert_hf_gpt2(state_dict: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """HF GPT2LMHeadModel state dict -> the port's state dict (fp32)."""
    g = lambda n: to_t(state_dict[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    out = {"embed.wte": g("transformer.wte.weight"), "embed.wpe": g("transformer.wpe.weight"),
           "final_norm.scale": g("transformer.ln_f.weight"),
           "final_norm.bias": g("transformer.ln_f.bias")}
    for i in range(cfg.num_layers):
        pre, dst = "transformer.h.%d." % i, "layers.%d." % i
        out[dst + "wqkv.kernel"] = g(pre + "attn.c_attn.weight").reshape(h, 3, nh, hd)
        out[dst + "wqkv.bias"] = g(pre + "attn.c_attn.bias").reshape(3, nh, hd)
        for mine, theirs in _GPT_LAYER:
            out[dst + mine] = g(pre + theirs)
    return to_state_dict(out)


def export_hf_gpt2(params, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """The port's parameters -> HF GPT2LMHeadModel state-dict arrays
    (fp32), the tied ``lm_head`` included."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    out = {"transformer.wte.weight": a("embed.wte"), "transformer.wpe.weight": a("embed.wpe"),
           "transformer.ln_f.weight": a("final_norm.scale"),
           "transformer.ln_f.bias": a("final_norm.bias"), "lm_head.weight": a("embed.wte")}
    for i in range(cfg.num_layers):
        pre, src = "transformer.h.%d." % i, "layers.%d." % i
        out[pre + "attn.c_attn.weight"] = a(src + "wqkv.kernel").reshape(h, 3 * nh * hd)
        out[pre + "attn.c_attn.bias"] = a(src + "wqkv.bias").reshape(3 * nh * hd)
        for mine, theirs in _GPT_LAYER:
            out[pre + theirs] = a(src + mine)
    return out
