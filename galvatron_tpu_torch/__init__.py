"""galvatron_tpu_torch — the PyTorch/CUDA port of galvatron_tpu.

A package of its own beside ``galvatron_tpu`` (the JAX reference). Module
paths mirror the reference's (``config/``, ``ops/``, ``models/``, ``serve/``,
``cli/``, ``obs/``, ``utils/``, ``analysis/``) so each module's counterpart
is found by name. It imports ``torch`` and nothing of JAX or of the
reference package.

It serves and trains a causal LM (LLaMA, GPT-2) on 1..N GPUs under a
searched per-layer strategy (DP, ZeRO-2/3, Megatron TP with Megatron-SP,
vocab TP; serving without pipelines or sequence sharding; ``torchrun``
launches one process per GPU).
Attention runs hand-written CUDA flash-attention kernels
(``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``, wrapped by
``ops/flash_attention.py``) on CUDA tensors, and their plain PyTorch
versions on CPU tensors.
"""
