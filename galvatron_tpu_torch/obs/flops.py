"""Analytic model-FLOPs accounting and the peak-FLOPs registry behind MFU.

Port of ``galvatron_tpu/obs/flops.py`` (the training half and the two decode
roofline helpers). Model FLOPs, not hardware FLOPs: the matmul terms of
attention (with the causal 0.5 factor), the MLP and the head projection,
independent of remat replay. MFU is ``model_flops / step_time /
peak_flops``. `decode_step_flops` and `model_bytes_per_decode_token` price
one decode tick: its FLOPs, and the bytes it must stream (the
bandwidth-roofline denominator of serving throughput).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# Peak dense matmul throughput per device, FLOP/s, by device-name prefix
# (``torch.cuda.get_device_name`` here, jax's device_kind in the reference,
# whose TPU rows are kept as they are). NVIDIA H100: dense bf16, NVIDIA's
# data sheet (SXM). The "cpu" entry is a NOMINAL figure so CPU test runs
# produce a defined MFU — a label, not a measurement.
PEAK_FLOPS_BY_KIND: Dict[str, float] = {
    "TPU v4": 275e12,
    "TPU v5 lite": 197e12,
    "TPU v5e": 197e12,
    "TPU v5": 459e12,
    "TPU v5p": 459e12,
    "TPU v6 lite": 918e12,
    "TPU v6e": 918e12,
    "TPU7x": 2307e12,
    "NVIDIA H100": 989e12,
    "cpu": 5e10,
}


def peak_flops_for(device_kind: Optional[str]) -> Optional[float]:
    """Peak FLOP/s for a device kind (longest-prefix match, case-insensitive);
    None when unknown."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    best: Optional[float] = None
    best_len = -1
    for prefix, peak in PEAK_FLOPS_BY_KIND.items():
        if kind.startswith(prefix.lower()) and len(prefix) > best_len:
            best, best_len = peak, len(prefix)
    return best


def layer_fwd_flops(
    *,
    hidden: int,
    num_heads: int,
    seq_len: int,
    ffn_hidden: Optional[int] = None,
    head_dim: Optional[int] = None,
    num_kv_heads: Optional[int] = None,
    causal: bool = True,
    swiglu: bool = False,
    tokens: Optional[float] = None,
) -> float:
    """Forward model FLOPs of ONE transformer block over `tokens` tokens
    (default: one sequence). Matmul terms only, 2 FLOPs per MAC."""
    tokens = float(seq_len if tokens is None else tokens)
    ffn = ffn_hidden or 4 * hidden
    hd = head_dim or hidden // num_heads
    nkv = num_kv_heads or num_heads
    q_dim = num_heads * hd
    # per-token projections: q, fused kv (GQA-scaled), out
    proj = 2.0 * hidden * q_dim + 2.0 * hidden * (2 * nkv * hd) + 2.0 * q_dim * hidden
    # per-token attention: scores + weighted sum, each 2*S*q_dim; causal halves
    attn = 2.0 * (2.0 * seq_len * q_dim) * (0.5 if causal else 1.0)
    mlp = (2.0 * hidden * (2 * ffn) + 2.0 * ffn * hidden) if swiglu \
        else (2.0 * hidden * ffn + 2.0 * ffn * hidden)
    return tokens * (proj + attn + mlp)


def layer_fwd_flops_from_config(cfg: Any, tokens: Optional[float] = None,
                                seq_len: Optional[int] = None) -> Optional[float]:
    """Duck-typed entry for TransformerConfig-shaped configs."""
    hidden = getattr(cfg, "hidden_size", None)
    heads = getattr(cfg, "num_heads", None)
    seq = seq_len or getattr(cfg, "max_seq_len", None)
    if not hidden or not heads or not seq:
        return None
    return layer_fwd_flops(
        hidden=hidden,
        num_heads=heads,
        seq_len=seq,
        ffn_hidden=getattr(cfg, "ffn_hidden", None),
        head_dim=getattr(cfg, "head_dim", None),
        num_kv_heads=getattr(cfg, "num_kv_heads", None),
        causal=bool(getattr(cfg, "causal", True)),
        swiglu=getattr(cfg, "activation", "gelu") == "swiglu",
        tokens=tokens,
    )


def head_fwd_flops_from_config(cfg: Any, tokens: Optional[float] = None) -> float:
    """Head projection FLOPs over `tokens` tokens (lookups are ~0 FLOPs)."""
    hidden = getattr(cfg, "hidden_size", 0) or 0
    tokens = float(tokens if tokens is not None else getattr(cfg, "max_seq_len", 0) or 0)
    head_type = getattr(cfg, "head_type", "lm")
    if head_type in ("lm", "mlm"):
        vocab = getattr(cfg, "vocab_size", 0) or 0
        extra = 2.0 * hidden * hidden if head_type == "mlm" else 0.0
        return tokens * (2.0 * hidden * vocab + extra)
    if head_type == "classification":
        return 2.0 * hidden * (getattr(cfg, "num_classes", 0) or 0)
    return 0.0


def model_fwd_flops(cfg: Any, batch_size: int = 1) -> Optional[float]:
    """Whole-model forward FLOPs for one batch."""
    seq = getattr(cfg, "max_seq_len", None)
    layers = getattr(cfg, "num_layers", None)
    if not seq or not layers:
        return None
    tokens = float(batch_size) * seq
    per_layer = layer_fwd_flops_from_config(cfg, tokens=tokens)
    if per_layer is None:
        return None
    return layers * per_layer + head_fwd_flops_from_config(cfg, tokens=tokens)


# backward ~= 2x forward (dL/dx and dL/dW each re-run every matmul)
BWD_FWD_RATIO = 2.0


def train_step_flops(cfg: Any, global_bsz: int) -> Optional[float]:
    """Model FLOPs of one optimizer step: forward + backward (3x forward).
    Remat replay is not counted: MFU measures useful arithmetic."""
    fwd = model_fwd_flops(cfg, batch_size=global_bsz)
    if fwd is None:
        return None
    return fwd * (1.0 + BWD_FWD_RATIO)


def run_fwd_flops(cfg: Any, hp: Any) -> Optional[List[float]]:
    """Per-LayerRun forward FLOPs for one global batch
    (``config.strategy.layer_runs``); None when the model is not
    analytically describable. The embed/head share is appended as a final
    pseudo-run, so the shares over the step sum to 1 (the autotuner's
    calibration splits the measured step by them)."""
    from galvatron_tpu_torch.config.strategy import layer_runs

    tokens = float(hp.global_bsz) * (getattr(cfg, "max_seq_len", 0) or 0)
    per_layer = layer_fwd_flops_from_config(cfg, tokens=tokens)
    if per_layer is None or not tokens:
        return None
    out = [per_layer * run.length for run in layer_runs(hp)]
    out.append(head_fwd_flops_from_config(cfg, tokens=tokens))
    return out


def flops_note(cfg: Any) -> Optional[str]:
    """What the analytic count leaves out for this config, printed beside
    its MFU: T5's cross-attention (the count takes the config's fields, as
    the reference's does: both stacks as decoder-style layers); None for a
    config it describes, or cannot count at all (Swin: no MFU)."""
    if getattr(cfg, "num_dec_layers", None) and model_fwd_flops(cfg) is not None:
        return ("analytic FLOPs leave out T5's cross-attention (and count every layer's "
                "self-attention causal), as the reference's count does")
    return None


# -------------------------------------------------------------- inference
def decode_step_flops(cfg: Any, batch_size: int = 1,
                      context_len: Optional[int] = None) -> Optional[float]:
    """Model FLOPs of ONE decode tick: `batch_size` slots each emit one
    token against a KV cache of `context_len` entries. Forward-only — no 3x
    train multiplier — and the attention term prices query-length 1 against
    the CACHE length (causal=False: the cache rows ARE the visible past, so
    no 0.5 triangular discount), which is what layer_fwd_flops computes when
    tokens=batch and seq_len=context. None for non-transformer configs."""
    layers = getattr(cfg, "num_layers", None)
    ctx = context_len or getattr(cfg, "max_seq_len", None)
    if not layers or not ctx:
        return None
    per_layer = layer_fwd_flops_from_config(
        cfg, tokens=float(batch_size), seq_len=int(ctx))
    if per_layer is None:
        return None
    # decode attention is not causal-masked: every cached position is live
    # (layer_fwd_flops_from_config honours cfg.causal, so undo the 0.5)
    if bool(getattr(cfg, "causal", True)):
        hd = getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_heads
        q_dim = cfg.num_heads * hd
        per_layer += float(batch_size) * (2.0 * (2.0 * ctx * q_dim)) * 0.5
    return layers * per_layer + head_fwd_flops_from_config(
        cfg, tokens=float(batch_size))


def model_bytes_per_decode_token(cfg: Any, *, context_len: Optional[int] = None,
                                 dtype_bytes: int = 2,
                                 batch_size: int = 1) -> Optional[float]:
    """HBM bytes one decode tick must stream per generated token: the full
    weight read (amortised over the batch — weights are read once per STEP,
    not per token) plus the token's own KV-cache read at `context_len`.
    This is the bandwidth-roofline denominator serving throughput divides
    by (search/cost_model.ServeTimeCostModel prices the same quantity from
    profiled tables); None for non-transformer configs."""
    hidden = getattr(cfg, "hidden_size", None)
    layers = getattr(cfg, "num_layers", None)
    heads = getattr(cfg, "num_heads", None)
    if not hidden or not layers or not heads:
        return None
    ctx = context_len or getattr(cfg, "max_seq_len", 0) or 0
    ffn = getattr(cfg, "ffn_hidden", None) or 4 * hidden
    hd = getattr(cfg, "head_dim", None) or hidden // heads
    nkv = getattr(cfg, "num_kv_heads", None) or heads
    swiglu = getattr(cfg, "activation", "gelu") == "swiglu"
    # per-layer weight elements: q + kv (GQA) + out projections and the MLP
    q_dim = heads * hd
    proj = hidden * q_dim + hidden * (2 * nkv * hd) + q_dim * hidden
    mlp = hidden * (2 * ffn) + ffn * hidden if swiglu else 2 * hidden * ffn
    weight_bytes = layers * (proj + mlp) * float(dtype_bytes)
    vocab = getattr(cfg, "vocab_size", 0) or 0
    weight_bytes += hidden * vocab * float(dtype_bytes)  # head matmul read
    kv_bytes = layers * 2.0 * ctx * nkv * hd * float(dtype_bytes)
    return weight_bytes / max(int(batch_size), 1) + kv_bytes


def mfu(flops_per_step: Optional[float], step_ms: Optional[float],
        peak_flops: Optional[float]) -> Optional[float]:
    """Model-FLOPs utilization; None when any input is unknown/degenerate."""
    if not flops_per_step or not step_ms or not peak_flops or step_ms <= 0:
        return None
    return flops_per_step / (step_ms / 1e3) / peak_flops


def flops_per_s(flops_per_step: Optional[float], step_ms: Optional[float]) -> Optional[float]:
    if not flops_per_step or not step_ms or step_ms <= 0:
        return None
    return flops_per_step / (step_ms / 1e3)
