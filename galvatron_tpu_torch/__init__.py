"""galvatron_tpu_torch — the PyTorch/CUDA port of galvatron_tpu.

A package of its own beside ``galvatron_tpu`` (the JAX reference). Module
paths mirror the reference's (``config/``, ``ops/``, ``models/``, ``serve/``,
``cli/``, ``obs/``, ``utils/``, ``analysis/``) so each module's counterpart
is found by name. It imports ``torch`` and nothing of JAX or of the
reference package.

This slice serves a causal LM on one device: strategy JSON -> model -> KV
cache -> prefill/decode engine -> continuous batcher -> TTFT/TPOT summary.
Prefill attention runs a hand-written CUDA flash-attention forward kernel
(``csrc/flash_attn_fwd.cu``, wrapped by ``ops/flash_attention.py``) on CUDA
tensors, and its plain PyTorch version on CPU tensors.
"""
