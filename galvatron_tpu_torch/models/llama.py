"""LLaMA family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/llama.py`` (META_CONFIGS, llama_config): the
same presets and architecture — RMSNorm, rotate-half RoPE, SwiGLU, untied
head, no biases. The HF state-dict converters come with a later slice."""

from __future__ import annotations

from galvatron_tpu_torch.models.base import TransformerConfig

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
