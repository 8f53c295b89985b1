"""GPT-2 family: meta configs and the config constructor.

Port of ``galvatron_tpu/models/gpt.py`` (META_CONFIGS, gpt_config): the same
presets and architecture — pre-norm LayerNorm (eps 1e-5) with bias, tanh
gelu MLP, learned position embeddings, a head tied to the token embedding,
and biases on the qkv, attention-out and MLP projections; vocab 50257. The
HF state-dict converters (``convert_hf_gpt2``/``export_hf_gpt2``) come with
the checkpoint-conversion slice (ROADMAP queue 1 item 9b)."""

from __future__ import annotations

from galvatron_tpu_torch.models.base import TransformerConfig

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
