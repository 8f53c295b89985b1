"""``python -m galvatron_tpu_torch.cli train`` — training on 1..N GPUs.

Port of ``galvatron_tpu/cli/train.py``: the model config and the per-layer
strategy from GLOBAL flags or a searched JSON (``--galvatron_config_path``)
-> strategy lint (train mode, with the model config) -> model (this rank's
shards) -> optimizer (clip + Adam + decoupled weight decay, warmup + decay
schedule, ZeRO-sharded moments) -> optional resume (``--load``) -> the
global batch stream: an indexed corpus (``--data_path``, its ``--split``)
or the reference's synthetic stream, both pure functions of the step
(every rank takes its rows), prepared and copied to the device by a
prefetch thread -> ``--train_iters`` steps of chunked loss and gradients,
each layer under its own layout and remat policy, drained up to
``--inflight_steps`` behind -> a summary with the reference's timing keys,
the losses and the resilience counters, printed by rank 0.

At the loop's boundaries, as in the reference: a valid-split eval every
``--eval_interval`` steps and a final test-split eval (forward only); a
checkpoint every ``--save_interval`` steps and at the end
(``runtime/checkpoint.py``: each rank writes its shards, rank 0 commits the
manifest); the anomaly guard (``--anomaly_guard``: a non-finite or spiking
step applies nothing, ``--anomaly_max_strikes`` consecutive ones roll back
to the newest intact checkpoint and rewind the losses and the stream);
SIGTERM/SIGINT save at the next boundary (``--emergency_save``, every rank
agreeing on it through one all-reduced flag per step).

    python -m galvatron_tpu_torch.cli train --model_type gpt \\
        --model_size gpt-6.7b --set_layernum_manually 1 --num_layers 8 \\
        --global_train_batch_size 8 --chunks 2 --galvatron_config_path s.json
    torchrun --nproc_per_node 4 -m galvatron_tpu_torch.cli train ... \\
        --galvatron_config_path s.json              # one process per GPU

The world size is the process group's (`runtime.distributed`: torchrun's
environment, else one rank); ``--world_size``, when given, must equal it.
The run happens on ``--device`` (default ``cuda``: ``nccl``, the GPU
``LOCAL_RANK``; ``cpu``: ``gloo``); with no GPU visible ``cuda`` raises.
Attention at flash-eligible shapes (head_dim >= 128, a sequence that is a
multiple of 128) goes through the hand-written flash-attention kernels,
forward and backward, on each rank's heads (eval runs the forward alone).
Under a pipeline (``pp_deg > 1``) each rank runs one stage, GPipe or 1F1B
(``--pipeline_type pipedream_flush``), exchanging activations and
cotangents with its neighbours (``parallel.pipeline.P2PTransport``); the
logged loss is the last stage's, broadcast to every rank, and a checkpoint
holds a tied table once. Layers with cp > 1 run ring attention over
their cp group (``--global_cp_deg`` / a JSON's ``cp_sizes_enc``, the
batch zigzag-permuted under ``--cp_mode zigzag``), Ulysses layers
(``--use-ulysses`` / ``use_sp``) their attention after an all-to-all over
tp, and ``--vocab_sp`` / ``--vocab_cp`` shard the embedding's and the
loss's sequence, each inside the 1F1B pipeline too (GPipe refuses cp, as
the reference does). ``--model_type bert`` trains the MLM encoder on the
token stream, ``--model_type vit`` and ``swin`` the image classifiers on a
vision shard (``--data_path``, ``data.dataset.write_vision_dataset``) or
synthetic pixels, ``--model_type t5`` the encoder-decoder on span-corrupted
windows of the corpus (``data.dataset.t5_data_iterator``; encoder and
decoder both ``max_seq_len`` long) or the synthetic seq2seq stream. T5 and
Swin build their own trees (the family's ``build`` hook) and pipeline under
1F1B only; their summary's MFU is the analytic count's (T5's leaves out
cross-attention, ``mfu_note``; Swin has none, only ``images_per_s``).

Elastic resume (``--load`` with ``--elastic resume|search``,
``runtime/elastic.py``): the strategy comes from the checkpoint's
provenance (an unchanged world), ``--elastic_strategy`` or a search for
this world, and the restore moves every rank's shards of the params and
both Adam moments across strategies, world sizes and pipeline divisions
(``runtime/checkpoint.py``); a refusal (GLS2xx) exits with code 2. A plain
``--load`` under another strategy still refuses (GLS206), but for a step
that holds params alone (``tools/convert_checkpoint h2g``): its full params
are sharded into this run's layout, whatever it is, and the optimizer
starts fresh at iteration 0, as in the reference.

A run that survives (the reference's self-healing loop, in its order at
each step boundary: hooks -> preemption -> watchdog -> mesh probe ->
migration -> autotune, every rank taking the same branch through one
all-reduced flag vector, ``runtime.distributed.agree_max``): ``--watchdog``
(``runtime/health.py``: a missed learned deadline drains and retries, a
second one makes an emergency save and `main` exits 3);
``--mesh_probe_interval`` (live ranks
and a timed all-reduce; a degraded world under ``--migrate_on_degrade``
migrates, a probe that times out exits 3 without a collective);
``--sdc_check digest|vote`` (``runtime/sdc.py``: the fold kernel's digest
every step; under vote a lying replica is repaired, the step re-executed
and a repeat offender quarantined into a migration); live migration
(``runtime/elastic.migrate``) on SIGUSR1, a degraded probe, a quarantine
or an autotune swap, moving params and both Adam moments in memory at the
same step, the departing ranks leaving (exit 0); ``--autotune
observe|apply`` (``runtime/autotune.py``: once the step settles, a
re-search on measured tables and, under apply, a swap).

Observability: ``--telemetry`` (rank 0's JSONL event stream, which ``cli
report`` analyses); ``--xla_trace DIR --trace_steps K:N`` (the reference's
flag names) captures a ``torch.profiler`` trace (CPU and CUDA activities)
of steps K..N, each rank exporting ``DIR/trace_rank<r>.json`` (Chrome
format): the window is bracketed by full drains (nothing in flight when it
starts, step N drained with nothing dispatched after it when it stops), so
the trace holds those steps' kernels and no others; ``trace`` events mark
its start, stop or a profiler that could not start (the run goes on, as in
the reference). ``--profile`` logs every iteration (`main` prints the
summary, with or without it); ``--train_log_dir`` tees rank 0's iteration lines to
``<dir>/train_<model>_<size>.log``.
"""

from __future__ import annotations

import math
import os
import signal
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from galvatron_tpu_torch.cli.arguments import (
    hp_config_from_args,
    initialize_galvatron,
    model_config_from_args,
)
from galvatron_tpu_torch.obs import flops as obs_flops
from galvatron_tpu_torch.obs import telemetry
from galvatron_tpu_torch.ops import flash_attention
from galvatron_tpu_torch.profiler.runtime import RuntimeProfiler, device_memory_stats
from galvatron_tpu_torch.runtime import checkpoint as ckpt
from galvatron_tpu_torch.runtime import distributed
from galvatron_tpu_torch.runtime import resilience as rsl
from galvatron_tpu_torch.runtime.dataloader import build_data_iterator
from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler
from galvatron_tpu_torch.runtime.prefetch import (
    DevicePlacer,
    PrefetchIterator,
    PrefetchStalledError,
    consume,
)
from galvatron_tpu_torch.runtime.provenance import build_provenance, model_config_fields


def optimizer_args_from(args) -> OptimizerArgs:
    return OptimizerArgs(
        lr=args.lr,
        min_lr=args.min_lr,
        weight_decay=args.weight_decay,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_eps=args.adam_eps,
        clip_grad=args.clip_grad,
        warmup_steps=args.lr_warmup_iters,
        total_steps=args.train_iters,
        lr_decay_style=args.lr_decay_style,
    )


@dataclass
class TrainRun:
    """Everything one training run steps: the model family, config and
    strategy, the model, this rank's parameters and Adam state, the
    optimizer, the anomaly guard (None under ``--anomaly_guard 0``) and the
    train step as ``cli train`` runs it (with the guard, the step takes the
    guard's spike cap as a fourth argument: `step_args`)."""
    fam: Any
    cfg: Any
    hp: Any
    device: torch.device
    model: Any
    tx: Any
    params: Any
    opt_state: Any
    guard: Optional[rsl.AnomalyGuard]
    step: Callable
    elastic_plan: Any = None  # runtime.elastic.ElasticPlan under --elastic
    sdc_mode: str = "off"  # the sentinel's mode as the step runs it (vote may downgrade)

    def step_args(self) -> tuple:
        """The step's arguments after (params, opt_state, batch)."""
        return (self.guard.spike_cap(),) if self.guard is not None else ()


class BatchStream:
    """The train batches on the device, from a start step: the corpus or
    the synthetic stream (``runtime/dataloader.py``, a pure function of the
    step: resume and rollback reopen it at a step), each global batch made
    and copied to the device by a prefetch thread (``--prefetch_batches``;
    0, or ``--no_async_loop``: made on the caller's thread). Building the
    stream and reading a batch are retried under `retry_policy`; a stalled
    prefetch thread is rebuilt once at the batch it stalled on (an exact
    replay), a second stall raises. `hooks` (``FaultHooks``) may wrap the
    CPU stream before the prefetch thread."""

    def __init__(self, args, run: TrainRun, retry_policy=None, counters=None, hooks=None):
        self.args, self.run, self.hooks = args, run, hooks
        self.retry_policy, self.counters = retry_policy, counters
        async_loop = bool(getattr(args, "async_loop", True))
        self.depth = max(int(getattr(args, "prefetch_batches", 2) or 0), 0) if async_loop else 0
        self.placer = DevicePlacer(run.device) if self.depth else None
        self.prefetch = self.source = None
        self.position = 0  # the stream index of the next batch

    def _retry(self, fn, what):
        return rsl.with_retry(fn, self.retry_policy, self.counters, description=what)

    def _retrying(self, it_):
        while True:
            try:
                b = self._retry(lambda: next(it_), "dataloader")
            except StopIteration:
                return
            yield b

    def open(self, start_step: int):
        """(Re)build the stream at `start_step`, dropping whatever the old
        prefetch thread had buffered."""
        self.close()
        run = self.run
        it_ = self._retry(lambda: build_data_iterator(self.args, run.fam, run.cfg, run.hp,
                                                      start_step=start_step),
                          "dataloader build")
        if self.hooks is not None and self.hooks.wrap_data_iter:
            it_ = self.hooks.wrap_data_iter(it_, start_step)
        if self.depth:
            self.prefetch = PrefetchIterator(self._retrying(it_), depth=self.depth,
                                             place_fn=self.placer)
        else:
            self.source = it_
        self.position = start_step
        return self

    def close(self):
        if self.prefetch is not None:
            self.prefetch.close()
        self.prefetch = self.source = None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self.prefetch is not None:
            try:
                b = consume(next(self.prefetch))
            except PrefetchStalledError as e:
                telemetry.runtime_log("prefetch stalled at batch %d: %s; rebuilding the input "
                                      "pipeline" % (self.position, e))
                self.open(self.position)
                b = consume(next(self.prefetch))
        else:
            b = self._retry(lambda: next(self.source), "dataloader")
            b = {k: v.to(self.run.device) for k, v in b.items()}
        self.position += 1
        return b


def make_step(args, run: "TrainRun", hooks=None):
    """The train step for the run's current model and strategy, under the
    sentinel mode of ``--sdc_check`` (vote downgrades to digest, with a log
    line, where the layout has no dp replicas to vote on: the reference's
    ``build_step_fn``); wrapped by the fault hooks when a test gives them.
    Also the rebuild after a live migration."""
    from galvatron_tpu_torch.runtime import sdc as sdc_mod

    mode = run.sdc_mode
    if mode == "vote":
        reason = sdc_mod.vote_reason(run.hp)
        if reason is not None:
            telemetry.runtime_log("sdc_check=vote downgraded to digest: %s" % reason)
            mode = "digest"
    run.sdc_mode = mode
    fn = run.model.make_train_step(run.tx, guard_anomalies=run.guard is not None,
                                   sdc_check=mode)
    if hooks is not None and hooks.wrap_step_fn:
        fn = hooks.wrap_step_fn(fn)
    run.step = fn
    return fn


def build_model(fam, cfg, hp, device):
    """The model of `hp` on `device`: the family's own build for T5 and
    Swin, else the generic constructor."""
    if fam.build is not None:
        return fam.build(cfg, hp, device)
    return construct_hybrid_parallel_model(cfg, hp, device)


def build(args, device: Optional[torch.device] = None) -> TrainRun:
    """Strategy from the flags or the JSON -> train-mode lint -> model,
    optimizer, parameters, Adam state, guard and step on `device` (by
    default ``--device`` of a world of one; `train` passes the device of
    this rank). The batches come from a `BatchStream`."""
    if device is None:
        device = distributed.local_device(args.device)
    fam, cfg = model_config_from_args(args)
    world = distributed.world_size()
    if args.world_size is not None and args.world_size != world:
        raise ValueError(
            "--world_size %d but the process group has %d rank(s): launch one process "
            "per rank (torchrun --nproc_per_node %d -m galvatron_tpu_torch.cli train ...)"
            % (args.world_size, world, args.world_size))
    lead = distributed.rank() == 0
    elastic_plan = None
    if args.load and getattr(args, "elastic", "off") != "off":
        # the strategy for this world from the checkpoint's provenance, the
        # replacement JSON or a search; the saved one on an unchanged world
        from galvatron_tpu_torch.runtime import elastic as els

        elastic_plan = els.resolve_resume_strategy(args, cfg, world,
                                                   opt_args=optimizer_args_from(args))
        hp = elastic_plan.hp
        if lead and elastic_plan.cross_strategy:
            print("elastic resume (%s): checkpoint strategy (world %d) -> new strategy "
                  "(world %d)" % (elastic_plan.action, elastic_plan.saved_hp.world_size,
                                  hp.world_size))
    else:
        hp = hp_config_from_args(args, cfg.num_layers, world)

    # fail fast on a bad strategy before anything is built
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

    report = _slint.lint_hp(hp, model_cfg=cfg, mode="train",
                            file=getattr(args, "galvatron_config_path", None),
                            sdc_check=getattr(args, "sdc_check", None),
                            sdc_interval=getattr(args, "sdc_interval", None),
                            autotune=getattr(args, "autotune", None),
                            autotune_margin=getattr(args, "autotune_margin", None),
                            elastic_strategy=getattr(args, "elastic_strategy", None))
    for d in report.warnings if lead else ():
        print("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)
    if lead:
        print(hp.describe())

    model = build_model(fam, cfg, hp, device)
    tx, _ = get_optimizer_and_scheduler(optimizer_args_from(args))
    params = model.init_params(args.seed)
    guard = None
    if getattr(args, "anomaly_guard", 0):
        guard = rsl.AnomalyGuard(rsl.AnomalyGuardConfig(
            spike_factor=getattr(args, "loss_spike_factor", 0.0),
            min_history=getattr(args, "anomaly_min_history", 5),
            max_strikes=getattr(args, "anomaly_max_strikes", 3),
            max_rollbacks=getattr(args, "anomaly_max_rollbacks", 3)))
    run = TrainRun(
        fam=fam, cfg=cfg, hp=hp, device=device, model=model, tx=tx, params=params,
        opt_state=model.init_opt_state(tx, params), guard=guard, step=None,
        elastic_plan=elastic_plan, sdc_mode=getattr(args, "sdc_check", "off") or "off")
    make_step(args, run)
    return run


class WedgedWorldError(RuntimeError):
    """The mesh probe's all-reduce did not complete in time: a rank is gone
    and the communicator cannot be trusted. The driver issues no further
    collective; `main` exits with ``runtime.health.WATCHDOG_EXIT_CODE`` and
    the run resumes from its last committed checkpoint."""


def train(args) -> dict:
    """Returns the summary dict: the profiler's timing keys (FLOPs and MFU
    per GPU), the per-step losses, tokens/s (all ranks and per GPU), the
    resilience counters, the eval losses, the checkpoint save/restore
    sizes and times, the flash kernels' launches by route on every rank
    (and this rank's eval launches), the device, the world size and this
    process's rank; with the watchdog, its summary, with the autotuner its
    plans and swaps, with live migrations their records. A rank that left
    the world in a migration returns ``{"departed": True, ...}``. Runs
    inside a process group that it tears down
    (`runtime.distributed.process_group`), unless the world wedged
    (`WedgedWorldError`: no collective may run, the teardown included).
    With ``--telemetry`` rank 0 writes the run's JSONL event stream."""
    with distributed.process_group(args.device) as device:
        sink = None
        if getattr(args, "telemetry", None) and distributed.rank() == 0:
            sink = telemetry.JsonlSink(
                args.telemetry, depth=max(int(getattr(args, "telemetry_buffer", 1024) or 1), 1))
            telemetry.install(sink)
        try:
            return _train(args, device)
        except WedgedWorldError:
            distributed.abandon_group()
            raise
        finally:
            if sink is not None:
                telemetry.uninstall(sink)
                sink.close()


def _flash_routes() -> dict:
    return {"fwd": dict(flash_attention.flash_attention_fwd.routes),
            "bwd": dict(flash_attention.flash_attention_bwd.routes)}


def _routes_since(before: dict) -> list:
    """The flash kernels' launches by route since `before`, per rank (all
    ranks' counts gathered: a head-sliced view under TP must not leave the
    tensor-core route on any of them)."""
    now = _flash_routes()
    mine = {k: {r: n - before[k].get(r, 0) for r, n in now[k].items()
                if n != before[k].get(r, 0)} for k in now}
    if distributed.world_size() == 1:
        return [mine]
    every = [None] * distributed.world_size()
    torch.distributed.all_gather_object(every, mine)
    return every


def _parse_trace_steps(spec) -> tuple:
    """'K:N' -> (K, N) inclusive; a single 'K' traces one step."""
    lo, _, hi = str(spec or "3:5").partition(":")
    lo = int(lo)
    return lo, int(hi) if hi else lo


def _train(args, device) -> dict:
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.runtime import elastic as els
    from galvatron_tpu_torch.runtime import health as hlth
    from galvatron_tpu_torch.runtime import sdc as sdc_mod

    hooks = getattr(args, "fault_hooks", None)  # test seam; None in production
    run = build(args, device)
    if hooks is not None and hooks.wrap_step_fn:
        make_step(args, run, hooks)
    routes = _flash_routes()
    cfg, tx = run.cfg, run.tx
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    step_flops = obs_flops.train_step_flops(cfg, run.hp.global_bsz)
    peak_flops = obs_flops.peak_flops_for(device_kind)

    # ------------------------------------------------------------ resilience
    res = rsl.ResilienceCounters()
    retry_policy = rsl.RetryPolicy(retries=max(getattr(args, "ckpt_retries", 2), 0),
                                   base_delay_s=getattr(args, "ckpt_retry_backoff", 0.5))
    guard = run.guard
    plan = run.elastic_plan
    budget = getattr(args, "elastic_memory_gb", None) or (
        plan.provenance.get("memory_budget_gb") if plan is not None else None)
    provenance = build_provenance(run.hp, cfg, optimizer_args_from(args), memory_budget_gb=budget)
    sdc_interval = max(int(getattr(args, "sdc_interval", 0) or 1), 1)

    def load_params_only(ckpt_dir, step):
        # a step without Adam state (tools/convert_checkpoint h2g): every
        # rank assembles the full params (checked against the manifest) and
        # keeps its shards of the live layout, under any strategy and world
        # size; the optimizer state stays as it is (fresh at the start)
        t0 = time.perf_counter()
        full, meta = ckpt.load_full_params(ckpt_dir, step, cfg, strict_model=False)
        with torch.no_grad():
            for stage, module in run.params.items():
                for name, p in module.named_parameters():
                    p.copy_(run.model._shard(name, full[name].to(p.device, p.dtype), stage))
        nbytes = sum(t.numel() * t.element_size() for t in full.values())
        del full
        meta["restore"] = {"bytes": nbytes, "params_only": True,
                           "seconds": time.perf_counter() - t0}
        ckpt._emit_restore(int(meta["iteration"]), ckpt_dir, meta["restore"], 0)
        return run.params, None, meta

    def load_from(ckpt_dir, iteration):
        # restores in place into the live params and Adam state (a tied
        # table's last-stage copy from the first stage's, which the
        # checkpoint holds once); under --elastic a step of another
        # strategy is restored across strategies
        step = iteration if iteration is not None else next(
            iter(reversed(ckpt.intact_iterations(ckpt_dir))), None)
        manifest = ckpt.read_manifest(ckpt_dir, step) if step is not None else None
        if manifest is not None and "opt_state" not in manifest.get("items", {}):
            return load_params_only(ckpt_dir, step)
        return ckpt.load_checkpoint(
            ckpt_dir, iteration, params_target=run.params, opt_state_target=run.opt_state,
            target=run.model, allow_cross=plan is not None, model_cfg=cfg,
            verify_integrity=bool(getattr(args, "verify_checkpoint", 1)),
            retry_policy=retry_policy, counters=res,
            sdc_check=run.sdc_mode != "off")

    start_iter, restored = 0, None
    if args.load:
        _, _, meta = load_from(args.load, args.load_iteration)
        start_iter = int(meta.get("iteration", 0))
        res.torn_checkpoints_skipped += len(meta.get("torn_iterations", ()))
        restored = dict(meta["restore"], iteration=start_iter)
        if distributed.rank() == 0:
            print("resumed from %s at iteration %d%s" % (
                args.load, start_iter, " across strategies" if restored.get("cross_strategy")
                else " (params only: a fresh optimizer)" if restored.get("params_only")
                else ""))

    telemetry.emit(
        "run_start", model="%s_%s" % (args.model_type, args.model_size or run.fam.default_size),
        world_size=run.hp.world_size, strategy=run.hp.to_json_dict(),
        train_iters=args.train_iters, global_bsz=run.hp.global_bsz, start_iter=start_iter,
        model_flops_per_step=step_flops, peak_flops=peak_flops, device_kind=device_kind,
        pipeline_type=run.hp.pipeline_type, num_layers=run.hp.num_layers,
        resumed_from=args.load or None, model_type=args.model_type,
        hidden_size=getattr(cfg, "hidden_size", None), num_heads=getattr(cfg, "num_heads", None),
        num_kv_heads=getattr(cfg, "num_kv_heads", None),
        ffn_hidden=getattr(cfg, "ffn_hidden", None), vocab_size=getattr(cfg, "vocab_size", None),
        seq_len=getattr(cfg, "max_seq_len", None), mixed_precision=run.hp.mixed_precision,
        activation=getattr(cfg, "activation", None))

    # per-LayerRun cost-model predictions (obs/attribution.py): the
    # telemetry's layer_run rows and the autotuner's FLOPs-share split
    autotune_mode = getattr(args, "autotune", "off") or "off"
    predictions = None

    def predict(hp):
        from galvatron_tpu_torch.obs import attribution

        try:
            rows = attribution.predict_layer_runs(cfg, hp)
        except Exception as e:  # noqa: BLE001 - the analytic tables cannot price it
            telemetry.emit("log", message="layer-run prediction skipped: %s" % e)
            return None
        for row in rows or ():
            telemetry.emit("layer_run", **row)
        return rows

    if telemetry.active_sink() is not None or autotune_mode != "off":
        predictions = predict(run.hp)

    # ------------------------------------------------------- input pipeline
    async_loop = bool(getattr(args, "async_loop", True))
    inflight_window = max(int(getattr(args, "inflight_steps", 2) or 0), 0) if async_loop else 0
    stream = BatchStream(args, run, retry_policy, res, hooks)

    # ------------------------------------------------------------------ eval
    # eval batches are made once up front (the same batches every pass; an
    # empty valid or test split fails here, before any training)
    eval_interval = getattr(args, "eval_interval", 0) or 0
    eval_iters = max(getattr(args, "eval_iters", 5) or 0, 1)
    eval_batches, eval_launches, eval_ms = {}, {"fwd": 0, "bwd": 0}, []
    if eval_interval:
        for split in ("valid", "test"):
            it_ = build_data_iterator(args, run.fam, cfg, run.hp, split=split, device=device)
            eval_batches[split] = [next(it_) for _ in range(eval_iters)]

    def evaluate(split):
        """Mean forward-only loss over the split's batches, drained once."""
        n_fwd = flash_attention.flash_attention_fwd.launches
        n_bwd = flash_attention.flash_attention_bwd.launches
        t0 = time.perf_counter()
        vals = [run.model.eval_loss(run.params, b) for b in eval_batches[split]]
        loss = float(torch.stack(vals).sum()) / eval_iters
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        eval_launches["fwd"] += flash_attention.flash_attention_fwd.launches - n_fwd
        eval_launches["bwd"] += flash_attention.flash_attention_bwd.launches - n_bwd
        return loss

    prof = RuntimeProfiler(warmup=min(2, max(args.train_iters - 1, 0)), device=device,
                           model_flops=step_flops / run.hp.world_size if step_flops
                           else step_flops, peak_flops=peak_flops,
                           model_name="%s_%s" % (args.model_type,
                                                 args.model_size or run.fam.default_size),
                           log_dir=getattr(args, "train_log_dir", None))
    save_memory = bool(getattr(args, "save_profiled_memory", 0))
    preempt = rsl.PreemptionHandler().install() if getattr(args, "emergency_save", 0) else None
    saves = []

    # ------------------------------------------------------ the trace window
    # torch.profiler over steps K..N (--xla_trace, --trace_steps): started
    # before step K is dispatched with nothing in flight, stopped when step
    # N has drained with nothing dispatched after it (see the loop), so the
    # device timeline holds exactly the window's kernels. A profiler that
    # cannot start or stop emits an error event and the run goes on.
    trace_dir = getattr(args, "xla_trace", None)
    trace_lo, trace_hi = _parse_trace_steps(getattr(args, "trace_steps", None))
    trace = {"prof": None, "done": trace_dir is None}

    def start_trace():
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            trace["prof"] = profile(activities=acts)
            trace["prof"].start()
            telemetry.emit("trace", action="start", dir=trace_dir, first_step=trace_lo,
                           last_step=trace_hi)
        except Exception as e:  # noqa: BLE001 - tracing is best effort, as in the reference
            trace.update(prof=None, done=True)
            telemetry.emit("trace", action="error", error=str(e))
            if distributed.rank() == 0:
                print("torch.profiler trace skipped (%s): %s" % (type(e).__name__, e))

    def maybe_stop_trace(iteration=None):
        if trace["prof"] is None or (iteration is not None and iteration < trace_hi):
            return
        p = trace["prof"]
        trace.update(prof=None, done=True)
        try:
            with prof.boundary():  # the export is not the next step's time
                p.stop()
                os.makedirs(trace_dir, exist_ok=True)
                p.export_chrome_trace(os.path.join(trace_dir,
                                                   "trace_rank%d.json" % distributed.rank()))
            telemetry.emit("trace", action="stop", dir=trace_dir)
        except Exception as e:  # noqa: BLE001
            telemetry.emit("trace", action="error", error=str(e))
            if distributed.rank() == 0:
                print("torch.profiler trace stop failed (%s): %s" % (type(e).__name__, e))

    # -------------------------------------------------------- self-healing
    # the watchdog (runtime/health.py): a monitor thread armed around every
    # loop body, its deadline learned from the step time; a first miss asks
    # for a drain and retry, a second one for the emergency-save exit (3)
    wd = None
    if getattr(args, "watchdog", 0):
        wd = hlth.Watchdog(hlth.WatchdogConfig(
            floor_s=float(args.watchdog),
            factor=float(getattr(args, "watchdog_factor", 4.0)),
            startup_deadline_s=float(getattr(args, "watchdog_startup_s", 600.0)),
        )).start()
    # the mesh probe: live ranks against the strategy's plus one timed
    # all-reduce, at step boundaries every --mesh_probe_interval seconds
    # (`probe_devices_fn` is the test seam for a simulated lost rank)
    probe_fn = getattr(args, "probe_devices_fn", None) or (
        hooks.probe_devices_fn if hooks is not None else None)

    def new_monitor(interval_s):
        return hlth.MeshHealthMonitor(interval_s=interval_s, devices_fn=probe_fn, device=device)

    mesh_monitor = None
    if getattr(args, "mesh_probe_interval", 0):
        mesh_monitor = new_monitor(float(args.mesh_probe_interval))
    # live-migration requests: SIGUSR1 (a manual re-plan), a degraded probe
    # under --migrate_on_degrade or an sdc quarantine; consumed at the next
    # step boundary, where params and Adam state are consistent
    migrate_req = {"pending": False, "reason": None, "world": None, "survivors": None}
    usr1 = {"seen": False}
    prev_usr1 = None
    if hasattr(signal, "SIGUSR1") and threading.current_thread() is threading.main_thread():
        def _on_usr1(signum, frame):
            usr1["seen"] = True

        prev_usr1 = signal.signal(signal.SIGUSR1, _on_usr1)
    migrations = []
    # the silent-corruption sentinel (runtime/sdc.py): the strike ladder of
    # the replica vote, the ranks it convicted and the recovery request
    sdc_ladder = None
    if run.sdc_mode == "vote":
        sdc_ladder = sdc_mod.VoteLadder(strikes=max(int(getattr(args, "sdc_strikes", 2) or 2), 1))
    sdc_quarantined = set()
    sdc_req = {"pending": False, "votes": None, "tie_rounds": 0}
    # the online autotuner (runtime/autotune.py)
    tuner = None
    if autotune_mode != "off":
        from galvatron_tpu_torch.runtime import autotune as AT

        tuner = AT.OnlineAutotuner(AT.AutotuneConfig(
            mode=autotune_mode, margin=getattr(args, "autotune_margin", None) or 0.05,
            window=getattr(args, "autotune_window", None) or 5,
            rel_std=getattr(args, "autotune_rel_std", None) or 0.15))

    def save_now(iteration: int, emergency: bool = False):
        meta = {"iteration": iteration}
        if emergency:
            meta["emergency"] = True
            meta["signal"] = interrupted
        # collective: every rank retries its own write and they agree; the
        # manifest records the state's layout-invariant folds beside the
        # sha256s, which a restore under another strategy is held to
        folds = {"params": sdc_mod.state_fold(run.model, run.params),
                 "opt_state": sdc_mod.state_fold(run.model, run.params, run.opt_state)}
        p_view, o_view = run.model.checkpoint_view(run.params, run.opt_state)
        with prof.boundary():
            info = ckpt.save_checkpoint(
                args.save, iteration, p_view, o_view, run.hp, train_meta=meta,
                keep_latest_k=getattr(args, "keep_latest_k", 0) or None, provenance=provenance,
                meta={"model_type": args.model_type, "model_size": args.model_size,
                      "model_config": model_config_fields(cfg)},
                retry_policy=retry_policy, counters=res, folds=folds)
        saves.append({k: v for k, v in info.items() if k != "items"})
        saves[-1].update(iteration=iteration, digests=info["items"])

    losses, loss_iters, valid_losses = [], [], []  # loss_iters: rollback truncation
    inflight = deque()  # (iteration, metrics) dispatched but not yet drained
    interrupted = None
    last_save = None
    it = start_iter

    def emit_step_event(d_it, metrics, loss, disp_ms):
        if telemetry.active_sink() is None:
            return
        iter_ms = prof.all_times_ms[-1] if prof.all_times_ms else None
        mem = device_memory_stats(device)
        grad_norm = float(metrics["grad_norm"])
        telemetry.emit(
            "step", iter=d_it, loss=loss if math.isfinite(loss) else None, iter_ms=iter_ms,
            dispatch_ms=disp_ms,
            host_blocked_ms=prof.host_blocked_ms[-1] if d_it >= prof.warmup else None,
            hbm_in_use_mb=mem["bytes_in_use"] / 2**20 or None,
            hbm_peak_mb=mem["peak_bytes_in_use"] / 2**20 or None,
            mfu=obs_flops.mfu(prof.model_flops, iter_ms, peak_flops),
            model_flops_per_s=obs_flops.flops_per_s(prof.model_flops, iter_ms),
            grad_norm=grad_norm if math.isfinite(grad_norm) else None)

    def drain_one():
        """Drain the oldest in-flight step: its time, log line, telemetry,
        the sentinel's and the guard's accounting. Returns (iteration,
        rollback_needed)."""
        d_it, metrics, disp_ms = inflight.popleft()
        prof.end(d_it, n_samples=run.hp.global_bsz)
        if wd is not None:
            # a drain is the loop's liveness signal and the deadline's data
            wd.observe_step_time(prof.all_times_ms[-1])
            wd.progress(d_it, inflight=len(inflight))
        if tuner is not None:
            tuner.observe_step(prof.all_times_ms[-1] if prof.all_times_ms else None,
                               iteration=d_it)
        loss = float(metrics["loss"])
        if distributed.rank() == 0 and (getattr(args, "profile", 0)
                                        or d_it % max(args.log_interval, 1) == 0):
            prof.log_iteration(d_it, {"loss": loss, "grad_norm": float(metrics["grad_norm"])})
        emit_step_event(d_it, metrics, loss, disp_ms)
        maybe_stop_trace(d_it)
        if save_memory and not prof.memory_snapshots:
            prof.profile_memory(d_it, "after_step")
        if sdc_ladder is not None and metrics.get("sdc_mismatch"):
            # the replicas disagreed: the step applied nothing and its loss
            # came from a corrupt replica; record nothing, drain_inflight
            # runs the repair / re-execute / quarantine ladder
            sdc_req.update(pending=True, votes=metrics["sdc_votes"])
            return d_it, False
        if run.sdc_mode != "off" and "sdc_fold" in metrics and d_it % sdc_interval == 0:
            fold, sumsq = sdc_mod.fold_value(metrics["sdc_fold"])
            res.sdc_checks += 1
            telemetry.emit("sdc_check", mode=run.sdc_mode, iter=d_it, fold=fold, sumsq=sumsq)
        verdict = guard.observe(loss) if guard is not None else "ok"
        if verdict == "ok":
            losses.append(loss)
            loss_iters.append(d_it)
            return d_it, False
        # the step itself applied nothing (guard_anomalies); only account
        # and maybe roll back
        res.anomalies_skipped += 1
        telemetry.emit("anomaly_skip", iter=d_it, verdict=verdict,
                       loss=loss if math.isfinite(loss) else None, strikes=guard.strikes)
        if distributed.rank() == 0:
            print("iteration %d: %s anomaly (loss %r) — update skipped (strike %d/%d)"
                  % (d_it, verdict, loss, guard.strikes, guard.cfg.max_strikes))
        return d_it, guard.should_roll_back

    def sdc_recover(d_it, votes):
        """A drained step's replica vote disagreed. The step applied
        nothing, and the loop drains it as soon as it is dispatched (no
        later step has run), so the live state IS the mismatching step's
        input. Vote on the host, repair the convicted replica from a
        healthy one, reopen the stream at the mismatching step and run it
        again: bitwise a clean run, because the fold is exact. A rank that
        keeps striking is quarantined into the degraded-mesh migration."""
        nonlocal it
        ids = sdc_mod.vote_device_ids(run.model)
        verdict = sdc_ladder.observe(votes, ids)
        res.sdc_mismatches += 1
        suspects = verdict["suspects"]
        telemetry.emit("sdc_mismatch", iter=d_it, action=verdict["action"],
                       suspects=suspects or None, folds=votes,
                       strikes=verdict["strikes"] or None)
        if distributed.rank() == 0:
            print("iteration %d: replica vote mismatch (%s) — %s%s"
                  % (d_it, " ".join("0x%08x" % v for v in votes), verdict["action"],
                     " (suspect ranks %s)" % suspects if suspects else ""))
        inflight.clear()
        if suspects:
            sdc_req["tie_rounds"] = 0
            sdc_mod.repair_from_replica(run.model, run.params, run.opt_state, suspects)
        else:
            # detected but not localizable (a tie, e.g. dp=2): re-execute
            # and hope the lie was transient, a bounded number of times
            sdc_req["tie_rounds"] += 1
            if sdc_req["tie_rounds"] > sdc_ladder.strikes:
                raise rsl.TrainingAnomalyError(
                    "replica folds keep disagreeing with no majority at iteration %d (%d "
                    "consecutive tied votes); cannot localize the lying rank"
                    % (d_it, sdc_req["tie_rounds"]))
        res.sdc_reexecutions += 1
        it = d_it
        stream.open(d_it)
        if verdict["quarantine"]:
            sdc_quarantined.update(int(d) for d in verdict["quarantine"])
            res.sdc_quarantines += 1
            avail = [r for r in range(distributed.world_size()) if r not in sdc_quarantined]
            telemetry.emit("sdc_quarantine", iter=d_it,
                           device_ids=sorted(int(d) for d in verdict["quarantine"]),
                           strikes=verdict["strikes"] or None, reason="replica_vote")
            if distributed.rank() == 0:
                print("iteration %d: rank(s) %s quarantined after %d consecutive strikes — "
                      "%d rank(s) survive" % (d_it, sorted(verdict["quarantine"]),
                                             sdc_ladder.strikes, len(avail)))
            if mesh_monitor is not None:
                mesh_monitor.quarantined_ids.update(verdict["quarantine"])
            if getattr(args, "migrate_on_degrade", 0):
                migrate_req.update(pending=True, reason="sdc_quarantine", world=len(avail),
                                   survivors=avail)
            else:
                raise rsl.TrainingAnomalyError(
                    "rank(s) %s convicted of silent corruption at iteration %d; restart "
                    "without them or pass --migrate_on_degrade 1 to migrate off them in "
                    "place" % (sorted(verdict["quarantine"]), d_it))

    def drain_inflight(window: int) -> bool:
        """Drain until at most `window` steps remain in flight (0: the
        forced drain at eval/save/preemption boundaries). On a rollback or
        an sdc recovery the rest of the window is discarded (it extends the
        abandoned trajectory) and the state and stream are restored here.
        Returns True iff that happened."""
        nonlocal it
        while len(inflight) > window:
            d_it, need_rollback = drain_one()
            if sdc_req["pending"]:
                sdc_req.update(pending=False)
                sdc_recover(d_it, sdc_req["votes"])
                return True
            if not need_rollback:
                continue
            intact = ckpt.intact_iterations(args.save) if args.save else []
            if res.rollbacks >= guard.cfg.max_rollbacks or not intact:
                raise rsl.TrainingAnomalyError(
                    "persistent training anomalies at iteration %d (%d consecutive; %d "
                    "rollbacks used, %s checkpoints to roll back to)"
                    % (d_it, guard.strikes, res.rollbacks, len(intact) if args.save else "no"))
            res.rollbacks += 1
            inflight.clear()
            with prof.boundary():
                _, _, meta = load_from(args.save, None)
            it = int(meta.get("iteration", 0))
            res.torn_checkpoints_skipped += len(meta.get("torn_iterations", ()))
            while loss_iters and loss_iters[-1] >= it:
                loss_iters.pop()
                losses.pop()
            while valid_losses and valid_losses[-1][0] > it:
                valid_losses.pop()
            offset = res.rollbacks * getattr(args, "anomaly_reseed", 0)
            stream.open(it + offset)
            guard.reset_after_rollback()
            telemetry.emit("rollback", to_iter=it, at_iter=d_it, count=res.rollbacks,
                           stream_offset=offset)
            if distributed.rank() == 0:
                print("rolled back to checkpoint iteration %d (rollback %d/%d, stream offset "
                      "+%d)" % (it, res.rollbacks, guard.cfg.max_rollbacks, offset))
            return True
        return False

    def do_migrate(reason, target_world=None, target_hp=None, survivors=None):
        """Live migration (``runtime/elastic.migrate``) at a step boundary
        with the window drained and the prefetch thread stopped: resolve a
        strategy for the surviving ranks (``--elastic_strategy`` or a fresh
        search; the autotuner passes its winner), move params and both Adam
        moments onto it in memory, rebuild the step and reopen the stream
        at the SAME step, as a save and an ``--elastic resume`` under the
        target would continue. Returns "swapped", "departed" (this rank left
        the world) or None (nothing to do); refusals raise GLS2xx
        (GLS207 for what a live migration cannot do)."""
        nonlocal provenance, mesh_monitor
        if wd is not None:
            wd.disarm()
        if drain_inflight(0):
            # a rollback or an sdc recovery won this boundary; the request is
            # dropped (the next trigger raises it against the restored run)
            return None
        world = distributed.world_size()
        avail = [r for r in (survivors if survivors is not None else range(world))
                 if r not in sdc_quarantined]
        if target_hp is not None:
            new_hp, action, new_world = target_hp, "autotune", target_hp.world_size
        else:
            new_world = int(target_world or len(avail))
            new_hp = action = None
            last_err = None
            for w in range(new_world, 0, -1):
                try:
                    new_hp, action = els.resolve_migration_strategy(args, cfg, w, run.hp)
                    new_world = w
                    break
                except DiagnosticError as e:
                    # a quarantined world (3 of 4 ranks) often has no strategy
                    # at its exact size; shrink until one fits
                    last_err = e
                    if reason != "sdc_quarantine":
                        raise
            if new_hp is None:
                raise last_err
            if new_world < len(avail) and distributed.rank() == 0:
                print("migration (%s): no feasible strategy for all %d surviving rank(s); "
                      "migrating to %d" % (reason, len(avail), new_world))
        if new_hp.to_json_dict() == run.hp.to_json_dict() and new_world == world:
            telemetry.runtime_log("migration (%s): the resolved strategy is the running one; "
                                  "nothing to swap" % reason)
            return None
        stream.close()
        from_hp = run.hp
        result = els.migrate(run.model, run.params, run.opt_state, new_hp,
                             survivors=avail[:new_world], reason=reason, iteration=it,
                             build_model=lambda c, h, d: build_model(run.fam, c, h, d),
                             sdc_check=run.sdc_mode != "off")
        record = {"reason": reason, "action": action, "iteration": it,
                  "from_world": from_hp.world_size, "to_world": new_hp.world_size,
                  "seconds": result.seconds, "device_extra_gb": result.device_extra_gb,
                  "to_strategy": new_hp.to_json_dict()}
        migrations.append(record)
        if result.departed:
            return "departed"
        run.model, run.params, run.opt_state, run.hp = (result.model, result.params,
                                                        result.opt_state, new_hp)
        if run.sdc_mode != "off":
            run.sdc_mode = getattr(args, "sdc_check", "off")  # vote again where it can
        make_step(args, run, hooks)
        provenance = build_provenance(run.hp, cfg, optimizer_args_from(args),
                                      memory_budget_gb=getattr(args, "elastic_memory_gb", None))
        sdc_quarantined.clear()  # the convicted ranks left; the survivors renumbered
        if sdc_ladder is not None:
            sdc_ladder.reset()
        if mesh_monitor is not None:
            mesh_monitor = new_monitor(mesh_monitor.interval_s)
        stream.open(it)
        if distributed.rank() == 0:
            print("live migration (%s/%s) at iteration %d: world %d -> %d, %s, %.3f s"
                  % (reason, action, it, from_hp.world_size, run.hp.world_size,
                     "same pipeline layout" if result.same_layout else "pipeline relayout",
                     result.seconds))
        return "swapped"

    def autotune_plan(steady_ms):
        """One planning epoch of the online autotuner: fold the measured
        steady step (agreed over the ranks) into the cost tables, search
        again under the original budget with the global batch pinned and,
        under ``apply``, swap through `do_migrate` when the predicted saving
        clears the margin and amortizes over the remaining steps. Returns
        what `do_migrate` returned (None when nothing was swapped)."""
        nonlocal predictions
        from galvatron_tpu_torch.runtime import autotune as AT

        hp = run.hp
        remaining = max(args.train_iters - it, 0)
        budget_gb = getattr(args, "elastic_memory_gb", None) or \
            provenance.get("memory_budget_gb") or els.DEFAULT_MEMORY_GB
        from_json = hp.to_json_dict()
        incumbent_ms = winner_ms = new_hp = tables = None
        base = els.analytic_model_profiles(cfg, max_tp=hp.world_size)
        if base is not None and steady_ms is not None:
            # the port has no compiled-program memory figure: the memory
            # tables stay as the base prices them
            tables = AT.calibrate_from_run(cfg, hp, base[0], base[1], predictions or [],
                                           steady_ms)
        if tables is not None:
            tcfg, mcfg = tables
            try:
                new_hp = els.search_surviving_strategy(
                    cfg, hp.world_size, hp.global_bsz, budget_gb, model_type=args.model_type,
                    config_dir=getattr(args, "config_dir", None),
                    default_dp_type=hp.default_dp_type, time_config=tcfg, memory_config=mcfg,
                    remat_search=True)
            except Exception as e:  # noqa: BLE001 - a failed re-search must not kill the run
                telemetry.runtime_log("autotune search failed: %s" % e)
                new_hp = None
            if new_hp is not None:
                for k in ("scan_layers", "remat_policy", "tp_comm_mode", "tp_comm_quant",
                          "mixed_precision"):
                    setattr(new_hp, k, getattr(hp, k))
                incumbent_ms = AT.predicted_step_ms(cfg, hp, tcfg, mcfg)
                winner_ms = AT.predicted_step_ms(cfg, new_hp, tcfg, mcfg)
        decision = tuner.decide(incumbent_ms, winner_ms, remaining,
                                identical=new_hp is not None and new_hp.to_json_dict() == from_json,
                                target_hp=new_hp)
        outcome, wall_ms = None, 0.0
        if decision.swap and tuner.config.mode == "apply":
            t0 = time.perf_counter()
            outcome = do_migrate("autotune", target_hp=decision.target_hp)
            wall_ms = (time.perf_counter() - t0) * 1e3
        swapped = outcome == "swapped"
        telemetry.emit(
            "autotune", action="plan", iter=it, mode=tuner.config.mode, reason=decision.reason,
            steady_step_ms=steady_ms, incumbent_ms=incumbent_ms, winner_ms=winner_ms,
            predicted_saving_ms=decision.predicted_saving_ms, margin=tuner.config.margin,
            remaining_steps=remaining, swap_cost_ms=decision.swap_cost_ms,
            swapped=int(swapped), from_strategy=from_json,
            to_strategy=new_hp.to_json_dict() if new_hp is not None else None)
        plans.append({"iteration": it, "reason": decision.reason, "swapped": swapped,
                      "steady_step_ms": steady_ms, "incumbent_ms": incumbent_ms,
                      "winner_ms": winner_ms,
                      "to_strategy": new_hp.to_json_dict() if new_hp is not None else None})
        if distributed.rank() == 0:
            print("autotune (%s) at iteration %d: %s (steady %.2f ms, incumbent %s ms, winner "
                  "%s ms)" % (tuner.config.mode, it, "swapping" if swapped else decision.reason,
                              steady_ms or -1.0,
                              "%.2f" % incumbent_ms if incumbent_ms else "-",
                              "%.2f" % winner_ms if winner_ms else "-"))
        if swapped:
            tuner.mark_swapped(it, wall_ms, decision.predicted_saving_ms)
            predictions = predict(run.hp)
        return outcome

    plans = []
    departed = False
    stream.open(start_iter)
    try:
        while True:
            if interrupted is None and it < args.train_iters:
                if hooks is not None and hooks.on_step:
                    hooks.on_step(it)
                # every rank takes the same branches: one agreement per boundary
                flags = distributed.agree_max([
                    float(preempt is not None and preempt.triggered),
                    float(wd is not None and wd.abort_requested),
                    float(wd is not None and wd.retry_requested),
                    float(mesh_monitor is not None and mesh_monitor.due()),
                    float(usr1["seen"]),
                    float(tuner is not None and tuner.plan_pending),
                    (tuner.steady_step_ms() or 0.0) if tuner is not None else 0.0,
                ], device)
                usr1["seen"] = False
                if flags[0]:
                    interrupted = (preempt.signal_name if preempt is not None else None) \
                        or "SIGTERM"
                    telemetry.emit("preemption", signal=interrupted, iter=it)
                if wd is not None and interrupted is None:
                    if flags[1]:
                        # a second missed deadline: the emergency-save exit
                        # (main() exits with the watchdog's code)
                        interrupted = "watchdog"
                    elif flags[2]:
                        wd.take_retry_request()
                        telemetry.runtime_log("watchdog: draining %d in-flight step(s) after "
                                              "a stall at iteration %d" % (len(inflight), it))
                        if drain_inflight(0):
                            continue
                if interrupted is None and flags[3]:
                    verdict = mesh_monitor.probe()
                    if verdict["status"] != "healthy":
                        telemetry.emit("watchdog", action="mesh_probe", iter=it,
                                       status=verdict["status"], expected=verdict["expected"],
                                       live=verdict["live"],
                                       missing_ids=verdict["missing_ids"] or None,
                                       detail=verdict.get("error"))
                        telemetry.runtime_log("mesh probe: %s (expected %d ranks, live %d)"
                                              % (verdict["status"], verdict["expected"],
                                                 verdict["live"]))
                    if verdict["status"] == "wedged":
                        raise WedgedWorldError(
                            "mesh probe at iteration %d: %s; resume from the last committed "
                            "checkpoint (--elastic resume)" % (it, verdict.get("error")))
                    if verdict["status"] == "degraded" and getattr(args, "migrate_on_degrade", 0):
                        migrate_req.update(pending=True, reason="degraded_mesh",
                                           world=verdict["live"],
                                           survivors=verdict["live_ids"])
                if interrupted is None and (migrate_req["pending"] or flags[4]):
                    req = dict(migrate_req) if migrate_req["pending"] else \
                        {"reason": "sigusr1", "world": None, "survivors": None}
                    migrate_req.update(pending=False)
                    outcome = do_migrate(req["reason"], req["world"],
                                         survivors=req["survivors"])
                    if outcome == "departed":
                        departed = True
                        break
                    continue
                if interrupted is None and flags[5]:
                    outcome = autotune_plan(flags[6] or None)
                    if outcome == "departed":
                        departed = True
                        break
                    if outcome is not None:
                        continue
            if interrupted is not None or it >= args.train_iters:
                # a rollback surfacing in the final drain resumes training,
                # unless a preemption is exiting (its save takes priority)
                if drain_inflight(0) and interrupted is None:
                    continue
                if wd is not None:
                    wd.disarm()  # the exit saves are not step work
                break
            if not trace["done"] and trace["prof"] is None and it >= trace_lo:
                if drain_inflight(0):
                    continue
                with prof.boundary():  # nor is the profiler's start
                    start_trace()
            if wd is not None:
                wd.arm(it, "fetch", inflight=len(inflight))
            batch = next(stream)
            prof.start(it)
            # with the guard, the cap comes from the losses drained so far: it
            # lags the step by at most `inflight_steps` (NaN/Inf gating is exact)
            run.params, run.opt_state, metrics = run.step(run.params, run.opt_state, batch,
                                                          *run.step_args())
            inflight.append((it, metrics, prof.dispatched(it)))
            if wd is not None:
                wd.arm(it, "inflight", inflight=len(inflight))
            it += 1
            # a replica vote that disagreed is known at dispatch (the step
            # read it in its one host transfer): recover now, before any
            # step runs from the frozen state (a fault that stops lying
            # would otherwise let a descendant apply an update out of turn)
            # (and the trace window's last step drains with nothing after it)
            window = 0 if metrics.get("sdc_mismatch") or (
                trace["prof"] is not None and it > trace_hi) else inflight_window
            if drain_inflight(window):
                continue
            if eval_interval and it % eval_interval == 0:
                if drain_inflight(0):
                    continue
                if wd is not None:
                    wd.disarm()  # eval passes are slow by design
                with prof.boundary():
                    vloss = evaluate("valid")
                valid_losses.append((it, vloss))
                telemetry.emit("eval", iter=it, split="valid", loss=vloss)
                if distributed.rank() == 0:
                    print("iteration %d: valid loss %.6f" % (it, vloss))
            if args.save and args.save_interval and it % args.save_interval == 0:
                if drain_inflight(0):
                    continue
                if wd is not None:
                    wd.disarm()  # checkpoint I/O has its own retry containment
                save_now(it)
                last_save = it
        if not departed:
            if interrupted is not None and args.save and last_save != it:
                save_now(it, emergency=True)
                res.emergency_saves += 1
                last_save = it
                if distributed.rank() == 0:
                    print("emergency checkpoint at iteration %d (%s)" % (it, interrupted))
            elif args.save and last_save != it:
                save_now(it)
                last_save = it
            prof.loop_fence()
    finally:
        stream.close()
        maybe_stop_trace()
        prof.close()
        if preempt is not None:
            preempt.uninstall()
        if wd is not None:
            wd.stop()
        if prev_usr1 is not None:
            signal.signal(signal.SIGUSR1, prev_usr1)
    if departed:
        return {"departed": True, "losses": losses, "loss_iters": loss_iters,
                "migrations": migrations, "resilience": res.as_dict(), "iteration": it,
                "rank": None, "device": str(device)}
    if save_memory:
        prof.profile_memory(it, "end")
    summary = prof.summary()
    summary["losses"] = losses
    summary["loss_iters"] = loss_iters
    summary["resilience"] = res.as_dict()
    if tuner is not None:
        summary["autotune"] = {"plans": tuner.plans, "swaps": tuner.swaps, "epochs": plans}
    if wd is not None:
        summary["watchdog"] = wd.summary()
    if migrations:
        summary["migrations"] = migrations
    if run.sdc_mode != "off" or getattr(args, "sdc_check", "off") != "off":
        summary["sdc_mode"] = run.sdc_mode
    if interrupted is not None:
        summary["interrupted"] = interrupted
    if eval_interval:
        summary["valid_losses"] = valid_losses
        summary["test_loss"] = evaluate("test")
        telemetry.emit("eval", iter=it, split="test", loss=summary["test_loss"])
        if distributed.rank() == 0:
            print("final test loss %.6f" % summary["test_loss"])
    summary["eval_flash_launches"] = eval_launches
    summary["eval_pass_ms"] = eval_ms
    summary["checkpoint_saves"] = saves
    if restored is not None:
        summary["checkpoint_restore"] = restored
    summary["flash_routes"] = _routes_since(routes)
    if getattr(cfg, "max_seq_len", None):
        summary["tokens_per_s"] = summary["samples_per_s"] * cfg.max_seq_len
        summary["tokens_per_s_per_gpu"] = summary["tokens_per_s"] / run.hp.world_size
    if run.fam.data_kind == "vision":
        summary["images_per_s"] = summary["samples_per_s"]
    note = obs_flops.flops_note(cfg)
    if note:
        summary["mfu_note"] = note
    summary["world_size"] = run.hp.world_size
    summary["rank"] = distributed.rank()
    summary["device"] = str(device)
    summary["device_kind"] = device_kind
    summary["strategy"] = run.hp.to_json_dict()
    telemetry.emit("run_end", summary={
        k: v for k, v in summary.items()
        if k not in ("losses", "loss_iters", "valid_losses", "checkpoint_saves",
                     "checkpoint_restore", "memory_snapshots", "migrations", "strategy",
                     "autotune", "watchdog")})
    return summary


def main(argv: Optional[list] = None):
    from galvatron_tpu_torch.runtime.health import WATCHDOG_EXIT_CODE

    args = initialize_galvatron(argv=argv, mode="train")
    try:
        summary = train(args)
    except WedgedWorldError as e:
        # the world's collective did not complete: no save (it would need
        # one), the exit code that says "resume me"
        print("wedged world: %s; exiting %d" % (e, WATCHDOG_EXIT_CODE), file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(WATCHDOG_EXIT_CODE)
    except Exception as e:
        from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

        if isinstance(e, DiagnosticError) and any(
                d.code.startswith("GLS2") for d in e.diagnostics):
            # the elastic-resume refusal contract: the diagnostics on stderr
            # and exit code 2, so a supervisor tells "needs operator input"
            # from "retry me"
            for d in e.diagnostics:
                print(d.format(), file=sys.stderr)
            sys.exit(2)
        raise
    if summary.get("departed"):
        print("left the world in a live migration at iteration %d (%s)"
              % (summary["iteration"], summary["migrations"][-1]["reason"]))
        return summary
    if summary["rank"] == 0:
        print({k: v for k, v in summary.items()
               if k not in ("losses", "loss_iters", "checkpoint_saves", "checkpoint_restore")})
        print("losses %s" % " ".join(repr(x) for x in summary["losses"]))
    if (summary.get("watchdog") or {}).get("escalated"):
        # the run wedged, evacuated through the emergency save and stopped
        # cleanly: exit 3 tells the supervisor "resume me, and read the
        # watchdog events" rather than "retry blindly"
        print("watchdog escalated: emergency state saved; exiting %d" % WATCHDOG_EXIT_CODE,
              file=sys.stderr)
        sys.exit(WATCHDOG_EXIT_CODE)
    return summary


if __name__ == "__main__":
    main()
