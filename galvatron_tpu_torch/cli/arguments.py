"""Argument system for the port's entry points (serve mode).

Port of the serve subset of ``galvatron_tpu/cli/arguments.py``: the model
flags, the GLOBAL-mode strategy flags, the serve flags and the two
args -> structure functions. Flags whose modules are not ported yet are not
defined, so argparse refuses them: ``--load``/``--load_iteration``
(checkpoints), ``--watchdog*``, ``--mesh_probe_interval``,
``--migrate_on_degrade``, ``--elastic_*`` (serve resilience), the
compilation-cache and multi-host bootstrap flags (JAX runtime only). The port
adds ``--device {cuda,cpu}``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def _add_model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model")
    g.add_argument("--model_type", type=str, default="llama", help="model family (see models/registry.py)")
    g.add_argument("--model_size", type=str, default=None, help="meta-config preset, e.g. llama-7b")
    g.add_argument("--set_model_config_manually", type=int, default=0)
    g.add_argument("--set_layernum_manually", type=int, default=0)
    g.add_argument("--set_seqlen_manually", type=int, default=0)
    g.add_argument("--hidden_size", type=int, default=None)
    g.add_argument("--num_attention_heads", type=int, default=None)
    g.add_argument("--num_kv_heads", type=int, default=None)
    g.add_argument("--ffn_hidden_size", type=int, default=None)
    g.add_argument("--num_layers", type=int, default=None)
    g.add_argument("--seq_length", type=int, default=None)
    g.add_argument("--vocab_size", type=int, default=None)
    g.add_argument("--mixed_precision", type=str, default="bf16", choices=("fp32", "bf16"))


def _add_parallel_args(p: argparse.ArgumentParser):
    """GLOBAL-mode strategy flags; this slice executes world size 1 and
    refuses any other layout with a ValueError."""
    g = p.add_argument_group("parallel")
    g.add_argument("--pp_deg", type=int, default=1)
    g.add_argument("--global_tp_deg", type=int, default=1)
    g.add_argument("--global_tp_consec", type=int, default=1)
    g.add_argument("--global_cp_deg", type=int, default=1)
    g.add_argument("--cp_mode", type=str, default="zigzag", choices=("ring", "zigzag"))
    g.add_argument("--sdp", type=int, default=0, help="1 => ZeRO-3 on every layer")
    g.add_argument("--global_train_batch_size", type=int, default=8)
    g.add_argument("--chunks", type=int, default=1, help="number of microbatches")
    g.add_argument("--pipeline_type", type=str, default="gpipe", choices=("gpipe", "pipedream_flush"))
    g.add_argument("--default_dp_type", type=str, default="ddp", choices=("ddp", "zero2", "zero3"))
    g.add_argument("--embed_sdp", type=int, default=0)
    g.add_argument("--vocab_tp", type=int, default=1)
    g.add_argument("--vocab_sp", type=int, default=0)
    g.add_argument("--vocab_cp", type=int, default=1)
    g.add_argument("--use-ulysses", dest="use_ulysses", action="store_true",
                   help="repurpose the tp axis as a Ulysses sequence axis")
    g.add_argument("--sequence-parallel", dest="sequence_parallel", action="store_true", default=True)
    g.add_argument("--no-sequence-parallel", dest="sequence_parallel", action="store_false")
    g.add_argument("--checkpoint", type=int, default=0, help="1 => activation remat on every layer")
    g.add_argument("--no_scan_layers", dest="scan_layers", action="store_false", default=True,
                   help="strategy runtime knob kept for schema parity (the port "
                        "always runs layers one after another)")
    g.add_argument("--remat_policy", type=str, default="full",
                   choices=("none", "full", "dots_saveable", "nothing_saveable"),
                   help="DEFAULT remat policy for layers with checkpoint=1 "
                        "(a per-layer serialized strategy field; this flag "
                        "only fills layers whose JSON lacks the key)")
    g.add_argument("--tp_comm_mode", type=str, default="gspmd",
                   choices=("gspmd", "shard_map", "overlap"),
                   help="TP-collective execution path (strategy runtime knob)")
    g.add_argument("--grad_comm_dtype", type=str, default="none",
                   choices=("none", "bf16", "int8", "fp8_e4m3"),
                   help="wire precision of the DP/ZeRO gradient sync")
    g.add_argument("--param_comm_dtype", type=str, default="none",
                   choices=("none", "bf16", "int8", "fp8_e4m3"),
                   help="wire precision of the ZeRO-3 parameter all-gather")
    g.add_argument("--comm_quant_block", type=int, default=64,
                   help="elements per absmax scale block for quantized collectives")
    g.add_argument("--tp_comm_quant", type=str, default="none",
                   choices=("none", "bf16", "int8", "fp8_e4m3"),
                   help="wire precision of the manual TP ring payloads")
    g.add_argument("--galvatron_config_path", type=str, default=None,
                   help="searched per-layer strategy JSON; overrides the GLOBAL flags above")
    g.add_argument("--world_size", type=int, default=None,
                   help="devices to use (default 1; this slice runs world size 1 only)")


def _add_serve_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("serving")
    g.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs; 'cuda' raises when no GPU is "
                        "visible instead of falling back to the CPU")
    g.add_argument("--serve_max_concurrency", type=int, default=None,
                   help="decode slots (defaults to the strategy JSON's "
                        "serve_max_concurrency, else 8)")
    g.add_argument("--serve_page_size", type=int, default=None,
                   help="KV page granularity (defaults to the strategy "
                        "JSON's serve_page_size, else 16)")
    g.add_argument("--serve_max_pages", type=int, default=None,
                   help="pages per slot (default: enough for the model's "
                        "max_seq_len)")
    g.add_argument("--num_requests", type=int, default=16,
                   help="synthetic requests to run (ignored with --replay)")
    g.add_argument("--rate_rps", type=float, default=0.0,
                   help="Poisson arrival rate for the synthetic load "
                        "(0 = all requests queued at t=0)")
    g.add_argument("--prompt_len_min", type=int, default=4)
    g.add_argument("--prompt_len_max", type=int, default=16)
    g.add_argument("--max_new_tokens", type=int, default=8,
                   help="output tokens per synthetic request")
    g.add_argument("--replay", type=str, default=None,
                   help="JSONL trace ({arrival_s, prompt_len, "
                        "max_new_tokens} per line) replayed instead of the "
                        "Poisson load")
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy argmax; >0 samples from the tempered "
                        "softmax")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--telemetry", type=str, default=None,
                   help="write serve_request/decode_batch events to this JSONL")
    g.add_argument("--telemetry_buffer", type=int, default=1024)
    r = p.add_argument_group("serving admission control")
    r.add_argument("--p99_ttft_ms", type=float, default=0.0,
                   help="shed (retryable) any pending request whose "
                        "predicted TTFT exceeds this bound (0 = admit "
                        "everything; defaults to the strategy JSON's "
                        "serve_p99_ttft_ms when set)")
    r.add_argument("--max_pending", type=int, default=0,
                   help="bound on the arrived-but-unadmitted queue (0 = "
                        "unbounded; defaults to the strategy JSON's "
                        "serve_max_pending when set)")
    r.add_argument("--request_timeout_s", type=float, default=0.0,
                   help="per-request TTFT deadline from arrival (0 = none)")
    r.add_argument("--shed_min_samples", type=int, default=3,
                   help="prefills AND decode ticks observed before the "
                        "predicted-TTFT shedder arms")


def build_parser() -> argparse.ArgumentParser:
    """The serve parser (the port's only mode so far)."""
    p = argparse.ArgumentParser("galvatron_tpu_torch-serve", allow_abbrev=False)
    _add_model_args(p)
    _add_parallel_args(p)
    _add_serve_args(p)
    return p


def initialize_galvatron(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    args.galvatron_mode = "serve"
    return args


def resolve_device(name: str) -> torch.device:
    """``cuda`` -> the current CUDA device, raising when none is visible;
    ``cpu`` -> the CPU. Never falls back from one to the other."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda: no CUDA device is visible (torch.cuda.is_available() "
                "is False); pass --device cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError("unknown device %r (cuda or cpu)" % name)


# --------------------------------------------------------- args -> structures
def hp_config_from_args(args, num_layers: int, world_size: int):
    """GLOBAL flags or a searched JSON -> HybridParallelConfig."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    exec_kw = dict(
        scan_layers=getattr(args, "scan_layers", True),
        remat_policy=getattr(args, "remat_policy", "full"),
        tp_comm_mode=getattr(args, "tp_comm_mode", "gspmd"),
        tp_comm_quant=getattr(args, "tp_comm_quant", "none"),
    )
    if getattr(args, "galvatron_config_path", None):
        return HybridParallelConfig.from_json(
            args.galvatron_config_path, world_size=world_size,
            global_bsz=args.global_train_batch_size, mixed_precision=args.mixed_precision,
            **exec_kw,
        )
    return HybridParallelConfig.uniform(
        world_size=world_size,
        num_layers=num_layers,
        pp=args.pp_deg,
        tp=args.global_tp_deg,
        cp=args.global_cp_deg,
        sp=1 if args.use_ulysses else 0,
        sdp=args.sdp,
        checkpoint=args.checkpoint,
        grad_comm_dtype=getattr(args, "grad_comm_dtype", "none"),
        param_comm_dtype=getattr(args, "param_comm_dtype", "none"),
        comm_quant_block=getattr(args, "comm_quant_block", 64),
        global_bsz=args.global_train_batch_size,
        chunks=args.chunks,
        pipeline_type=args.pipeline_type,
        default_dp_type=args.default_dp_type,
        vocab_tp=args.vocab_tp,
        vocab_sp=args.vocab_sp,
        vocab_cp=args.vocab_cp,
        embed_sdp=args.embed_sdp,
        mixed_precision=args.mixed_precision,
        sequence_parallel=args.sequence_parallel,
        cp_mode=args.cp_mode,
        **exec_kw,
    )


def model_config_from_args(args):
    """Resolve the model family + TransformerConfig from flags (the
    reference's three-way manual override scheme). As in the reference,
    ``--mixed_precision bf16`` pins the compute dtype to bf16 and ``fp32``
    leaves the config's default compute dtype (also bf16); parameters are
    fp32 either way."""
    from galvatron_tpu_torch.models.registry import get_family

    fam = get_family(args.model_type)
    size = args.model_size or fam.default_size
    overrides = {}
    if args.set_model_config_manually:
        for flag, key in (
            ("hidden_size", "hidden_size"),
            ("num_attention_heads", "num_heads"),
            ("num_kv_heads", "num_kv_heads"),
            ("ffn_hidden_size", "ffn_hidden"),
            ("num_layers", "num_layers"),
            ("vocab_size", "vocab_size"),
            ("seq_length", "max_seq_len"),
        ):
            v = getattr(args, flag, None)
            if v is not None:
                overrides[key] = v
    else:
        if args.set_layernum_manually and args.num_layers is not None:
            overrides["num_layers"] = args.num_layers
        if args.set_seqlen_manually and args.seq_length is not None:
            overrides["max_seq_len"] = args.seq_length
    if args.mixed_precision == "bf16":
        overrides.setdefault("compute_dtype", torch.bfloat16)
    cfg = fam.config_fn(size, **overrides)
    return fam, cfg
