"""LLaMA family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/llama.py`` (META_CONFIGS, llama_config): the
same presets and architecture — RMSNorm, rotate-half RoPE, SwiGLU, untied
head, no biases; and its HF bridge (`llama_config_from_hf`,
`convert_hf_llama`, `export_hf_llama`): q/k/v reshaped head-major (fused
``wqkv`` without GQA, ``wq`` + ``wkv (h, 2, nkv, hd)`` with it), gate and up
fused into ``wi (h, 2, ffn)``."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from galvatron_tpu_torch.models.base import TransformerConfig
from galvatron_tpu_torch.models.hf_utils import params_state, to_np, to_state_dict, to_t

META_CONFIGS = {
    "llama-0.3b": dict(hidden_size=1024, num_heads=16, num_layers=24, max_seq_len=1024),
    "llama-7b": dict(hidden_size=4096, num_heads=32, num_layers=32, max_seq_len=2048),
    "llama-13b": dict(hidden_size=5120, num_heads=40, num_layers=40, max_seq_len=2048),
    "llama-30b": dict(hidden_size=6656, num_heads=52, num_layers=60, max_seq_len=2048),
    "llama2-70b": dict(
        hidden_size=8192, num_heads=64, num_kv_heads=8, num_layers=80,
        max_seq_len=4096, ffn_hidden=28672,
    ),
    "qwen2.5-7b": dict(
        hidden_size=3584, num_heads=28, num_kv_heads=4, num_layers=28,
        max_seq_len=8192, ffn_hidden=18944, vocab_size=152064,
    ),
}


def _default_ffn(hidden: int, multiple_of: int = 256) -> int:
    """LLaMA-1 rule: 2/3 * 4h rounded up to multiple_of."""
    ffn = int(2 * (4 * hidden) / 3)
    return multiple_of * ((ffn + multiple_of - 1) // multiple_of)


def llama_config(model_size: str = "llama-0.3b", **overrides) -> TransformerConfig:
    base = dict(META_CONFIGS[model_size])
    base.setdefault("ffn_hidden", _default_ffn(base["hidden_size"]))
    base.setdefault("vocab_size", 32000)
    base.update(
        norm_type="rmsnorm",
        activation="swiglu",
        position_type="rope",
        causal=True,
        pre_norm=True,
        tie_embeddings=False,
        qkv_bias=False,
        mlp_bias=False,
        out_bias=False,
        layernorm_eps=1e-6,
        init_std=0.02,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def llama_config_from_hf(hf_config, **overrides) -> TransformerConfig:
    return TransformerConfig(
        hidden_size=hf_config.hidden_size,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        num_layers=hf_config.num_hidden_layers,
        ffn_hidden=hf_config.intermediate_size,
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        norm_type="rmsnorm",
        activation="swiglu",
        position_type="rope",
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        qkv_bias=False,
        mlp_bias=False,
        out_bias=False,
        layernorm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        **overrides,
    )


def convert_hf_llama(state_dict: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """HF LlamaForCausalLM state dict -> the port's state dict (fp32). HF
    Linear kernels are (out, in) and transpose to (in, out)."""
    g = lambda n: to_t(state_dict[n])
    h, nh, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"embed.wte": g("model.embed_tokens.weight"), "final_norm.scale": g("model.norm.weight")}
    if not cfg.tie_embeddings:
        out["lm_head.kernel"] = g("lm_head.weight").T
    for i in range(cfg.num_layers):
        pre, dst = "model.layers.%d." % i, "layers.%d." % i
        q = g(pre + "self_attn.q_proj.weight").T.reshape(h, nh, hd)
        k = g(pre + "self_attn.k_proj.weight").T.reshape(h, nkv, hd)
        v = g(pre + "self_attn.v_proj.weight").T.reshape(h, nkv, hd)
        out[dst + "ln1.scale"] = g(pre + "input_layernorm.weight")
        out[dst + "ln2.scale"] = g(pre + "post_attention_layernorm.weight")
        if cfg.fused_qkv:
            out[dst + "wqkv.kernel"] = torch.stack([q, k, v], dim=1)
        else:
            out[dst + "wq.kernel"] = q
            out[dst + "wkv.kernel"] = torch.stack([k, v], dim=1)
        out[dst + "wo.kernel"] = g(pre + "self_attn.o_proj.weight").T
        out[dst + "wi.kernel"] = torch.stack([g(pre + "mlp.gate_proj.weight").T,
                                          g(pre + "mlp.up_proj.weight").T], dim=1)
        out[dst + "wo_mlp.kernel"] = g(pre + "mlp.down_proj.weight").T
    return to_state_dict(out)


def export_hf_llama(params, cfg: TransformerConfig) -> Dict[str, np.ndarray]:
    """The port's parameters (a module or state dict) -> HF
    LlamaForCausalLM state-dict arrays (fp32): the inverse of
    `convert_hf_llama`."""
    sd = params_state(params)
    a = lambda n: to_np(sd[n])
    h, nh, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"model.embed_tokens.weight": a("embed.wte"), "model.norm.weight": a("final_norm.scale"),
           "lm_head.weight": a("embed.wte") if cfg.tie_embeddings else a("lm_head.kernel").T}
    for i in range(cfg.num_layers):
        pre, src = "model.layers.%d." % i, "layers.%d." % i
        if cfg.fused_qkv:
            qkv = a(src + "wqkv.kernel")
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        else:
            q, kv = a(src + "wq.kernel"), a(src + "wkv.kernel")
            k, v = kv[:, 0], kv[:, 1]
        out[pre + "self_attn.q_proj.weight"] = q.reshape(h, nh * hd).T
        out[pre + "self_attn.k_proj.weight"] = k.reshape(h, nkv * hd).T
        out[pre + "self_attn.v_proj.weight"] = v.reshape(h, nkv * hd).T
        out[pre + "self_attn.o_proj.weight"] = a(src + "wo.kernel").T
        wi = a(src + "wi.kernel")
        out[pre + "mlp.gate_proj.weight"] = wi[:, 0].T
        out[pre + "mlp.up_proj.weight"] = wi[:, 1].T
        out[pre + "mlp.down_proj.weight"] = a(src + "wo_mlp.kernel").T
        out[pre + "input_layernorm.weight"] = a(src + "ln1.scale")
        out[pre + "post_attention_layernorm.weight"] = a(src + "ln2.scale")
    return out
