"""Argument system for the port's entry points.

Port of ``galvatron_tpu/cli/arguments.py`` for the modes the port runs:
``serve``, ``train``, ``search``, ``profile`` and ``profile_hardware``.

- serve and train: the model flags, the GLOBAL-mode strategy flags, the
  serve flags (with ``--load`` / ``--load_iteration``), the training flags
  (iterations, learning rate and schedule, Adam, clipping, seed, log
  interval; the corpus and its split, eval, checkpoints, the anomaly guard,
  preemption, retries, prefetch and the drain window, telemetry, memory
  snapshots) with the reference's defaults;
- search: ``--config_dir``, the model flags and the reference's search
  flags with its defaults; ``--trace_lint`` is refused (the trace linter
  waits in ROADMAP queue 1 item 12a, the collective audit of
  ``analysis/trace_lint.py``);
- profile: ``--config_dir``, the model flags, the model-profiling flags
  and ``--profile_type_model``; profile_hardware: ``--config_dir``, the
  model flags and the hardware-profiling flags. Both add ``--device``.

Four reference flags change nothing in the port, so they take their
default only and refuse any other value: ``--profile_type_model`` (one
profile run writes both tables), ``--profile_dp_type`` (the model profiler
times one device) and ``--time_profile_mode`` / ``--memory_profile_mode``
(the search reads the mode from the tables).

Train takes the elastic-resume flags (``--elastic {off,resume,search}``,
``--elastic_strategy``, ``--elastic_memory_gb``), ``--config_dir`` (the
profiles an elastic search reads) and the self-healing flags: the watchdog
(``--watchdog``, ``--watchdog_factor``, ``--watchdog_startup_s``), the mesh
probe (``--mesh_probe_interval``), live migration
(``--migrate_on_degrade``), the silent-corruption sentinel
(``--sdc_check``, ``--sdc_interval``, ``--sdc_strikes``) and the online
autotuner (``--autotune``, ``--autotune_margin``, ``--autotune_window``,
``--autotune_rel_std``). Serve takes the watchdog flags, the mesh probe,
live serve migration (``--migrate_on_degrade`` with ``--elastic_strategy``,
``--elastic_memory_gb`` and the ``--config_dir`` a re-search reads), as
the reference does.

Train takes the observability flags ``--telemetry``, ``--xla_trace DIR``
(the reference's name: the port writes a torch.profiler Chrome trace per
rank), ``--trace_steps K:N``, ``--profile`` and ``--train_log_dir``.

Flags whose modules are not ported are not defined, so argparse refuses
them: the compilation-cache and multi-host bootstrap flags (JAX runtime
only). Train does not define ``--trace_lint``; search parses its default
only (the trace linter waits in ROADMAP queue 1 item 12a, the collective
audit of ``analysis/trace_lint.py``). ``--donate_step`` takes 1
only (see its help). The port adds ``--device {cuda,cpu}`` to every mode
that runs a model.
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
    """GLOBAL-mode strategy flags. Training executes per-layer DP, ZeRO-2/3,
    Megatron TP(+SP), Ulysses (``--use-ulysses``), ring cp
    (``--global_cp_deg``, ``--cp_mode``), vocab TP, sp and cp, and
    pipelines (``--pp_deg``, GPipe or 1F1B by ``--pipeline_type``, one stage
    per process; cp inside 1F1B only) at any world size; serving runs
    world size 1."""
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
                   help="devices to use; serving and training take the process group's "
                        "world size (torchrun --nproc_per_node) and this, when given, must "
                        "equal it")


def _add_device_arg(g):
    g.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs; 'cuda' raises when no GPU is "
                        "visible instead of falling back to the CPU")


def _add_train_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("training")
    _add_device_arg(g)
    g.add_argument("--train_iters", type=int, default=20)
    g.add_argument("--lr", type=float, default=1e-4)
    g.add_argument("--min_lr", type=float, default=1e-5)
    g.add_argument("--weight_decay", type=float, default=0.01)
    g.add_argument("--adam_beta1", type=float, default=0.9)
    g.add_argument("--adam_beta2", type=float, default=0.999)
    g.add_argument("--adam_eps", type=float, default=1e-8)
    g.add_argument("--clip_grad", type=float, default=1.0)
    g.add_argument("--lr_decay_style", type=str, default="cosine",
                   choices=("cosine", "linear", "constant"))
    g.add_argument("--lr_warmup_iters", type=int, default=0)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--log_interval", type=int, default=1)
    g.add_argument("--data_path", type=str, default=None,
                   help="indexed dataset prefix (data/dataset.py write_indexed_dataset), or a "
                        "blend 'W1 PREFIX1 W2 PREFIX2 ...'; default: synthetic data")
    g.add_argument("--split", type=str, default="969,30,1",
                   help="train/valid/test document weights over --data_path "
                        "(Megatron --split semantics)")
    g.add_argument("--eval_interval", type=int, default=0,
                   help="run a valid-split eval pass every N iterations (0=off)")
    g.add_argument("--eval_iters", type=int, default=5,
                   help="batches averaged per eval pass (and for the final test-split eval)")
    g.add_argument("--no_async_loop", dest="async_loop", action="store_false", default=True,
                   help="fully host-serialized loop (no prefetch thread, every step drained "
                        "at once); losses are bit-identical either way")
    g.add_argument("--prefetch_batches", type=int, default=2,
                   help="batches a background thread prepares and copies to the device "
                        "(pinned memory, a side stream) ahead of the step that reads them "
                        "(0 => prepare batches on the critical path)")
    g.add_argument("--donate_step", type=int, default=1, choices=(1,),
                   help="the port's step always updates params and Adam state in place, "
                        "which is what donation buys the reference (one resident copy of "
                        "the state); 0 (keep the step's inputs alive beside new outputs) "
                        "is refused: nothing in the port reads the old state")
    g.add_argument("--inflight_steps", type=int, default=2,
                   help="steps whose metrics may stay undrained: the host goes on to the "
                        "next step while the device finishes the last one's optimizer "
                        "update, and timing, logs and the guard's strike count lag by at "
                        "most this many steps (the skip itself is decided inside each step, "
                        "at the host sync the gradient clip already makes; forced drain at "
                        "eval/save/preemption boundaries; 0 => drain every step)")
    g.add_argument("--save_profiled_memory", type=int, default=0,
                   help="add device memory snapshots (torch.cuda.memory_stats) after the "
                        "first step and at the end to the summary")
    o = p.add_argument_group("observability")
    o.add_argument("--telemetry", type=str, default=None,
                   help="write the run's JSONL event stream (run_start, step, eval, "
                        "checkpoint, anomaly, rollback, preemption, run_end) to this path")
    o.add_argument("--telemetry_buffer", type=int, default=1024,
                   help="bounded queue depth of the background telemetry writer")
    o.add_argument("--xla_trace", type=str, default=None,
                   help="capture a torch.profiler trace (CPU and CUDA activities) of the "
                        "--trace_steps window into this directory, one Chrome trace per rank "
                        "(trace_rank<r>.json; the reference's flag name, whose XLA trace "
                        "becomes the port's torch.profiler trace); a profiler that cannot "
                        "start emits a trace error event and the run goes on")
    o.add_argument("--trace_steps", type=str, default="3:5",
                   help="K:N (inclusive) iteration window for --xla_trace; keep it a few "
                        "steps wide: traces are large")
    o.add_argument("--profile", type=int, default=0,
                   help="log every iteration (the summary is printed either way)")
    o.add_argument("--train_log_dir", type=str, default=None,
                   help="tee rank 0's iteration lines to <dir>/train_<model>.log")
    c = p.add_argument_group("checkpointing")
    c.add_argument("--save", type=str, default=None, help="checkpoint output dir")
    c.add_argument("--load", type=str, default=None, help="checkpoint dir to resume from")
    c.add_argument("--distributed_checkpoint", type=int, default=1,
                   help="accepted for the reference's command lines; checkpoints are "
                        "always sharded, each rank writing its own shards")
    c.add_argument("--load_iteration", type=int, default=None)
    c.add_argument("--save_interval", type=int, default=0, help="0 => only at end")
    r = p.add_argument_group("resilience")
    r.add_argument("--keep_latest_k", type=int, default=0,
                   help="GC all but the newest K checkpoints after each save (0 => keep all)")
    r.add_argument("--emergency_save", type=int, default=1,
                   help="on SIGTERM/SIGINT, save a checkpoint at the next step boundary "
                        "(needs --save) and exit cleanly")
    r.add_argument("--anomaly_guard", type=int, default=1,
                   help="skip updates whose loss/grad norm is NaN/Inf (or spikes past "
                        "--loss_spike_factor) instead of training through them")
    r.add_argument("--loss_spike_factor", type=float, default=0.0,
                   help="treat loss > factor * EMA(accepted losses) as an anomaly "
                        "(0 => NaN/Inf detection only)")
    r.add_argument("--anomaly_min_history", type=int, default=5,
                   help="accepted losses before the spike cap arms")
    r.add_argument("--anomaly_max_strikes", type=int, default=3,
                   help="consecutive anomalies before rolling back to the last checkpoint")
    r.add_argument("--anomaly_max_rollbacks", type=int, default=3,
                   help="rollbacks before giving up with an error")
    r.add_argument("--anomaly_reseed", type=int, default=0,
                   help="offset added to the data-stream step after each rollback, to step "
                        "past a deterministically poisoned batch (0 => replay the same stream)")
    r.add_argument("--ckpt_retries", type=int, default=2,
                   help="retry budget (exponential backoff) for checkpoint save/restore and "
                        "dataloader I/O")
    r.add_argument("--ckpt_retry_backoff", type=float, default=0.5,
                   help="base backoff delay in seconds")
    r.add_argument("--verify_checkpoint", type=int, default=1,
                   help="verify the integrity manifest on resume and fall back to the "
                        "latest intact checkpoint")
    # elastic resume (runtime/elastic.py): checkpoints carry a provenance
    # block, so a run on another world or strategy restores across them
    r.add_argument("--elastic", type=str, default="off", choices=("off", "resume", "search"),
                   help="on --load: 'resume' restores under the --elastic_strategy JSON "
                        "(or, on an unchanged world without one, the saved strategy), "
                        "'search' re-runs the strategy search for the live world size "
                        "under the saved memory budget; 'off' keeps the strict "
                        "same-strategy check (GLS206)")
    r.add_argument("--elastic_strategy", type=str, default=None,
                   help="replacement strategy JSON (implies a cross-strategy restore; "
                        "used by both --elastic modes when given)")
    r.add_argument("--elastic_memory_gb", type=float, default=None,
                   help="memory budget per GPU for the elastic re-search and the "
                        "strategy file's check (default: the budget recorded in the "
                        "checkpoint's provenance, else 16 GB); recorded into new "
                        "checkpoints' provenance")
    # self-healing runs (runtime/health.py, runtime/elastic.migrate): the
    # watchdog, the mesh-health probe and live in-memory migration
    _add_watchdog_args(r, "a step", "makes an emergency save and exits 3", "step time",
                       "the first steps build the kernels")
    r.add_argument("--mesh_probe_interval", type=float, default=0.0,
                   help="seconds between mesh-health probes at step boundaries (live ranks "
                        "against the strategy's, plus one all-reduce under a timeout; 0 = "
                        "off)")
    r.add_argument("--migrate_on_degrade", type=int, default=0,
                   help="when the mesh probe reports a degraded world (or the sdc vote "
                        "quarantines a rank), live-migrate in memory to a strategy for the "
                        "surviving ranks (--elastic_strategy if given, else a fresh search) "
                        "instead of exiting; SIGUSR1 triggers the same migration by hand")
    # silent-corruption sentinel (runtime/sdc.py)
    r.add_argument("--sdc_check", type=str, default="off", choices=("off", "digest", "vote"),
                   help="silent-data-corruption sentinel: 'digest' adds the layout-invariant "
                        "fold of the params to every step (the fold kernel; bitwise "
                        "transparent); 'vote' also folds every data-parallel replica's "
                        "input params and compares them: a lying rank is localized, the "
                        "step applies nothing, the replica is repaired from a healthy one "
                        "and the step re-executed, and a repeat offender is quarantined "
                        "into --migrate_on_degrade; downgrades to 'digest' with a log line "
                        "when the layout has no dp replicas to vote with")
    r.add_argument("--sdc_interval", type=int, default=None,
                   help="emit the sdc_check telemetry heartbeat every N drained steps "
                        "(default 1; the fold is computed every step regardless)")
    r.add_argument("--sdc_strikes", type=int, default=2,
                   help="consecutive mismatches naming the same rank before it is "
                        "quarantined (each first repairs and re-executes; a tied vote only "
                        "re-executes)")
    # online autotuner (runtime/autotune.py)
    r.add_argument("--autotune", type=str, default="off", choices=("off", "observe", "apply"),
                   help="once the step time settles, fold the measured step back into the "
                        "cost tables and search again: 'observe' logs the decision it would "
                        "take, 'apply' swaps to the new winner in memory through live "
                        "migration when it clears the hysteresis margin and the "
                        "remaining-steps amortization check")
    r.add_argument("--autotune_margin", type=float, default=None,
                   help="hysteresis: the winner must beat the incumbent's predicted step "
                        "by more than this fraction to swap (default 0.05)")
    r.add_argument("--autotune_window", type=int, default=None,
                   help="steps in the steady-state detector's window (default 5)")
    r.add_argument("--autotune_rel_std", type=float, default=None,
                   help="stdev/mean a window must stay under to count as settled "
                        "(default 0.15)")


def _add_serve_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("serving")
    _add_device_arg(g)
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
    g.add_argument("--load", type=str, default=None,
                   help="serve the parameters of this train checkpoint directory (of any "
                        "world size; the optimizer state is not read)")
    g.add_argument("--load_iteration", type=int, default=None,
                   help="checkpoint step to serve (default: the newest intact one)")
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
    _add_watchdog_args(r, "a prefill/decode tick", "gracefully drains the batcher and "
                          "exits 3", "tick time", "first ticks build the kernels")
    r.add_argument("--mesh_probe_interval", type=float, default=0.0,
                   help="seconds between mesh-health probes between scheduler iterations "
                        "(live ranks against the strategy's, plus one all-reduce under a "
                        "timeout; 0 = off)")
    r.add_argument("--migrate_on_degrade", type=int, default=0,
                   help="when the mesh probe reports a degraded world, re-plan serving for "
                        "the surviving ranks (--elastic_strategy if given, else a fresh "
                        "--objective serve search), move the params in memory, rebuild the "
                        "KV cache and journal-replay the in-flight requests; a world that "
                        "cannot serve drains and exits 2 (GLS015)")
    r.add_argument("--elastic_strategy", type=str, default=None,
                   help="replacement serve strategy JSON for a degraded mesh (with "
                        "--migrate_on_degrade)")
    r.add_argument("--elastic_memory_gb", type=float, default=None,
                   help="memory budget per GPU for the degraded-world serve re-search "
                        "(default 16 GB)")


def _add_watchdog_args(r, unit: str, escalation: str, timed: str, startup: str):
    r.add_argument("--watchdog", type=float, default=0.0,
                   help="arm the watchdog with this additive floor in seconds (0 = off): "
                        "%s making no progress for watchdog_factor * median(%s) + floor "
                        "seconds first drains and retries, then %s" % (unit, timed, escalation))
    r.add_argument("--watchdog_factor", type=float, default=4.0,
                   help="k in the learned watchdog deadline k * median(%s) + --watchdog "
                        "floor" % timed)
    r.add_argument("--watchdog_startup_s", type=float, default=600.0,
                   help="watchdog deadline before enough %ss have run to learn one (%s)"
                        % (timed.split()[0], startup))


def _add_profile_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("model profiling")
    _add_device_arg(g)
    g.add_argument("--profile_mode", type=str, default="static", choices=("static", "batch", "sequence"))
    g.add_argument("--profile_batch_size", type=int, default=8)
    g.add_argument("--profile_min_batch_size", type=int, default=1)
    g.add_argument("--profile_max_batch_size", type=int, default=8)
    g.add_argument("--batch_size_step", type=int, default=1)
    g.add_argument("--profile_seq_length", type=int, default=None)
    g.add_argument("--profile_min_seq_length", type=int, default=512)
    g.add_argument("--profile_max_seq_length", type=int, default=2048)
    g.add_argument("--seq_length_step", type=int, default=512)
    g.add_argument("--layernum_min", type=int, default=1)
    g.add_argument("--layernum_max", type=int, default=2)
    g.add_argument("--max_tp_deg", type=int, default=8)
    g.add_argument("--profile_dp_type", type=_default_only(
        "zero3", "the model profiler times one device, under no dp type"), default="zero3")
    g.add_argument("--profile_remat", type=int, nargs="?", const=1, default=0,
                   help="also measure the per-remat-policy backward "
                        "recompute fraction (remat_recompute_frac in the "
                        "computation table; TimeCostModel's profiled "
                        "override for the remat search axis); the bare "
                        "flag means 1")
    p.add_argument("--profile_type_model", dest="profile_type", type=_default_only(
        "computation", "one profile run writes both the computation and the memory table"),
        default="computation")


def _add_hardware_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("hardware profiling")
    _add_device_arg(g)
    g.add_argument("--start_mb", type=float, default=1.0)
    g.add_argument("--end_mb", type=float, default=64.0)
    g.add_argument("--scale", type=int, default=2)
    g.add_argument("--avg_or_min_or_first", type=str, default="avg", choices=("avg", "min", "first"))
    g.add_argument("--max_pp_deg", type=int, default=8)
    g.add_argument("--overlap_time_multiply", type=int, default=4)


def _default_only(default: str, why: str):
    """An argparse type for a reference flag the port does not act on: its
    default parses, any other value is refused with `why`, so a reference
    command line still parses and nothing is silently ignored."""
    def parse(value: str) -> str:
        if value != default:
            raise argparse.ArgumentTypeError("only %r is accepted: %s" % (default, why))
        return value
    return parse


def _trace_lint_flag(value: str) -> int:
    if int(value):
        raise argparse.ArgumentTypeError(
            "the trace linter is not ported yet (ROADMAP queue 1 item 12a: the "
            "collective audit of analysis/trace_lint.py)")
    return 0


def _add_search_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("search")
    g.add_argument("--profile_seq_length", type=int, default=None,
                   help="seq length the profiling tables were written at "
                        "(must match --profile_seq_length of the profile run)")
    g.add_argument("--memory_constraint", type=float, default=16.0, help="memory budget per GPU, GB")
    g.add_argument("--search_space", type=str, default="full",
                   choices=("full", "dp+tp", "dp+pp", "3d", "dp", "sdp", "tp", "pp"))
    g.add_argument("--sp_space", type=str, default="tp", choices=("tp+sp", "tp", "sp"))
    for name in ("dp", "tp", "vtp", "pp", "sdp", "ckpt", "tp_consec"):
        g.add_argument("--disable_%s" % name, type=int, default=0)
    g.add_argument("--enable_cp", type=int, default=0)
    g.add_argument("--max_tp_deg_search", dest="search_max_tp_deg", type=int, default=8)
    g.add_argument("--max_pp_deg_search", dest="search_max_pp_deg", type=int, default=8)
    g.add_argument("--max_cp_deg", type=int, default=4)
    g.add_argument("--min_bsz", type=int, default=8)
    g.add_argument("--max_bsz", type=int, default=None)
    g.add_argument("--bsz_scale", type=int, default=8)
    g.add_argument("--settle_bsz", type=int, default=None)
    g.add_argument("--settle_chunk", type=int, default=None)
    g.add_argument("--fine_grained_mode", type=int, default=1)
    g.add_argument("--use_pipeline_costmodel", type=int, default=0)
    for flag in ("--time_profile_mode", "--memory_profile_mode"):
        g.add_argument(flag, type=_default_only(
            "static", "the search reads the profile's mode from its tables"), default="static")
    g.add_argument("--parallel_search", type=int, default=0)
    g.add_argument("--log_dir", type=str, default="logs")
    g.add_argument("--output_config_path", type=str, default=None)
    g.add_argument("--time_profile_path", type=str, default=None,
                   help="explicit computation-profiling JSON to search on "
                        "(overrides the per-model config-dir convention; "
                        "pairs with --memory_profile_path)")
    g.add_argument("--memory_profile_path", type=str, default=None,
                   help="explicit memory-profiling JSON to search on "
                        "(overrides the per-model config-dir convention; "
                        "pairs with --time_profile_path)")
    g.add_argument("--comm_quant", type=str, default="off",
                   choices=("off", "bf16", "int8", "fp8_e4m3"),
                   help="let the search choose per-layer grad/param comm "
                        "precision (the trainer refuses quantized syncs "
                        "until ROADMAP queue 1 item 10)")
    g.add_argument("--comm_quant_block", type=int, default=64,
                   help="blockwise-quantization block size priced by the "
                        "cost models and emitted into the strategy JSON")
    g.add_argument("--comm_quant_budget", type=float, default=1.0,
                   help="max fraction of layers allowed a quantized "
                        "gradient sync (1.0 = all)")
    g.add_argument("--remat_search", type=int, nargs="?", const=1, default=0,
                   help="let the search choose per-layer remat policies "
                        "(none / dots_saveable / full); the bare flag means 1")
    g.add_argument("--objective", type=str, default="train", choices=("train", "serve"),
                   help="'train' maximises training throughput; 'serve' "
                        "maximises decode tokens/s per GPU under the p99 "
                        "latency bounds")
    g.add_argument("--p99_ttft_ms", type=float, default=0.0,
                   help="serve objective: p99 time-to-first-token bound, ms (0 = unbounded)")
    g.add_argument("--p99_tpot_ms", type=float, default=0.0,
                   help="serve objective: p99 time-per-output-token bound, ms (0 = unbounded)")
    g.add_argument("--serve_max_concurrency", type=int, default=8,
                   help="serve objective: decode slots the engine must hold KV for")
    g.add_argument("--serve_page_size", type=int, default=16,
                   help="serve objective: KV page granularity")
    g.add_argument("--serve_hbm_gbps", type=float, default=100.0,
                   help="per-device memory read bandwidth backing the decode roofline")
    g.add_argument("--trace_lint", type=_trace_lint_flag, default=0,
                   help="0 only: the JAX package's winner trace lint has no "
                        "counterpart in the port yet (ROADMAP queue 1 item 12a)")


MODES = ("serve", "train", "search", "profile", "profile_hardware")


def build_parser(mode: str = "serve") -> argparse.ArgumentParser:
    """The parser of one entry point: the model flags, then the strategy
    and the serve or train flags, or the search, profile or hardware
    profile flags."""
    if mode not in MODES:
        raise ValueError("unknown mode %r (one of %s)" % (mode, MODES))
    p = argparse.ArgumentParser("galvatron_tpu_torch-%s" % mode, allow_abbrev=False)
    if mode in MODES:
        p.add_argument("--config_dir", type=str, default="configs",
                       help="where profiled/searched JSON configs live (serve: the "
                            "profiles a degraded-world re-search reads)")
    _add_model_args(p)
    if mode in ("serve", "train"):
        _add_parallel_args(p)
        (_add_serve_args if mode == "serve" else _add_train_args)(p)
    elif mode == "search":
        _add_search_args(p)
    elif mode == "profile":
        _add_profile_args(p)
    else:
        _add_hardware_args(p)
    return p


def initialize_galvatron(argv: Optional[Sequence[str]] = None,
                         mode: str = "serve") -> argparse.Namespace:
    args = build_parser(mode).parse_args(argv)
    args.galvatron_mode = mode
    return args


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
    try:
        cfg = fam.config_fn(size, **overrides)
    except TypeError as e:
        raise ValueError(
            "model overrides %s not supported by family %r (%s); t5/swin use their own "
            "config fields: pass sizes via --model_size or the family config_fn"
            % (sorted(overrides), fam.name, e)) from None
    return fam, cfg
