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
starts fresh at iteration 0, as in the reference. The
silent-corruption sentinel, the watchdog, live migration and the
autotuner refuse with a ValueError naming their ROADMAP item, or argparse
refuses their flags.
"""

from __future__ import annotations

import math
import sys
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
from galvatron_tpu_torch.runtime.provenance import build_provenance


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
                            file=getattr(args, "galvatron_config_path", None))
    for d in report.warnings if lead else ():
        print("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)
    if lead:
        print(hp.describe())

    if fam.build is not None:  # families with their own tree (t5, swin)
        model = fam.build(cfg, hp, device)
    else:
        model = construct_hybrid_parallel_model(cfg, hp, device)
    tx, _ = get_optimizer_and_scheduler(optimizer_args_from(args))
    params = model.init_params(args.seed)
    guard = None
    if getattr(args, "anomaly_guard", 0):
        guard = rsl.AnomalyGuard(rsl.AnomalyGuardConfig(
            spike_factor=getattr(args, "loss_spike_factor", 0.0),
            min_history=getattr(args, "anomaly_min_history", 5),
            max_strikes=getattr(args, "anomaly_max_strikes", 3),
            max_rollbacks=getattr(args, "anomaly_max_rollbacks", 3)))
    return TrainRun(
        fam=fam, cfg=cfg, hp=hp, device=device, model=model, tx=tx, params=params,
        opt_state=model.init_opt_state(tx, params), guard=guard,
        step=model.make_train_step(tx, guard_anomalies=guard is not None),
        elastic_plan=elastic_plan)


def train(args) -> dict:
    """Returns the summary dict: the profiler's timing keys (FLOPs and MFU
    per GPU), the per-step losses, tokens/s (all ranks and per GPU), the
    resilience counters, the eval losses, the checkpoint save/restore
    sizes and times, the flash kernels' launches by route on every rank
    (and this rank's eval launches), the device, the world size and this
    process's rank. Runs inside a process group that it tears down
    (`runtime.distributed.process_group`). With ``--telemetry`` rank 0
    writes the run's JSONL event stream."""
    with distributed.process_group(args.device) as device:
        sink = None
        if getattr(args, "telemetry", None) and distributed.rank() == 0:
            sink = telemetry.JsonlSink(
                args.telemetry, depth=max(int(getattr(args, "telemetry_buffer", 1024) or 1), 1))
            telemetry.install(sink)
        try:
            return _train(args, device)
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


def _any_rank(flag: bool, device) -> bool:
    """True when `flag` is true on any rank (every rank must call it)."""
    if distributed.world_size() == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def _train(args, device) -> dict:
    run = build(args, device)
    routes = _flash_routes()
    cfg, hp, model, tx = run.cfg, run.hp, run.model, run.tx
    world = hp.world_size
    lead = distributed.rank() == 0
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    step_flops = obs_flops.train_step_flops(cfg, hp.global_bsz)
    peak_flops = obs_flops.peak_flops_for(device_kind)

    # ------------------------------------------------------------ resilience
    res = rsl.ResilienceCounters()
    retry_policy = rsl.RetryPolicy(retries=max(getattr(args, "ckpt_retries", 2), 0),
                                   base_delay_s=getattr(args, "ckpt_retry_backoff", 0.5))
    hooks = getattr(args, "fault_hooks", None)  # test seam; None in production
    guard, step_fn = run.guard, run.step
    if hooks is not None and hooks.wrap_step_fn:
        step_fn = hooks.wrap_step_fn(step_fn)
    params, opt_state = run.params, run.opt_state
    plan = run.elastic_plan
    budget = getattr(args, "elastic_memory_gb", None) or (
        plan.provenance.get("memory_budget_gb") if plan is not None else None)
    provenance = build_provenance(hp, cfg, optimizer_args_from(args), memory_budget_gb=budget)

    def load_params_only(ckpt_dir, step):
        # a step without Adam state (tools/convert_checkpoint h2g): every
        # rank assembles the full params (checked against the manifest) and
        # keeps its shards of the live layout, under any strategy and world
        # size; the optimizer state stays as it is (fresh at the start)
        t0 = time.perf_counter()
        full, meta = ckpt.load_full_params(ckpt_dir, step, cfg, strict_model=False)
        with torch.no_grad():
            for stage, module in params.items():
                for name, p in module.named_parameters():
                    p.copy_(model._shard(name, full[name].to(p.device, p.dtype), stage))
        nbytes = sum(t.numel() * t.element_size() for t in full.values())
        del full
        meta["restore"] = {"bytes": nbytes, "params_only": True,
                           "seconds": time.perf_counter() - t0}
        ckpt._emit_restore(int(meta["iteration"]), ckpt_dir, meta["restore"], 0)
        return params, None, meta

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
            ckpt_dir, iteration, params_target=params, opt_state_target=opt_state,
            target=model, allow_cross=plan is not None, model_cfg=cfg,
            verify_integrity=bool(getattr(args, "verify_checkpoint", 1)),
            retry_policy=retry_policy, counters=res)

    start_iter, restored = 0, None
    if args.load:
        _, _, meta = load_from(args.load, args.load_iteration)
        start_iter = int(meta.get("iteration", 0))
        res.torn_checkpoints_skipped += len(meta.get("torn_iterations", ()))
        restored = dict(meta["restore"], iteration=start_iter)
        if lead:
            print("resumed from %s at iteration %d%s" % (
                args.load, start_iter, " across strategies" if restored.get("cross_strategy")
                else " (params only: a fresh optimizer)" if restored.get("params_only")
                else ""))

    telemetry.emit(
        "run_start", model="%s_%s" % (args.model_type, args.model_size or run.fam.default_size),
        world_size=world, strategy=hp.to_json_dict(), train_iters=args.train_iters,
        global_bsz=hp.global_bsz, start_iter=start_iter, model_flops_per_step=step_flops,
        peak_flops=peak_flops, device_kind=device_kind, pipeline_type=hp.pipeline_type,
        num_layers=hp.num_layers, resumed_from=args.load or None, model_type=args.model_type,
        hidden_size=getattr(cfg, "hidden_size", None), num_heads=getattr(cfg, "num_heads", None),
        num_kv_heads=getattr(cfg, "num_kv_heads", None),
        ffn_hidden=getattr(cfg, "ffn_hidden", None), vocab_size=getattr(cfg, "vocab_size", None),
        seq_len=getattr(cfg, "max_seq_len", None), mixed_precision=hp.mixed_precision,
        activation=getattr(cfg, "activation", None))

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
            it_ = build_data_iterator(args, run.fam, cfg, hp, split=split, device=device)
            eval_batches[split] = [next(it_) for _ in range(eval_iters)]

    def evaluate(split):
        """Mean forward-only loss over the split's batches, drained once."""
        n_fwd = flash_attention.flash_attention_fwd.launches
        n_bwd = flash_attention.flash_attention_bwd.launches
        t0 = time.perf_counter()
        vals = [model.eval_loss(params, b) for b in eval_batches[split]]
        loss = float(torch.stack(vals).sum()) / eval_iters
        eval_ms.append((time.perf_counter() - t0) * 1e3)
        eval_launches["fwd"] += flash_attention.flash_attention_fwd.launches - n_fwd
        eval_launches["bwd"] += flash_attention.flash_attention_bwd.launches - n_bwd
        return loss

    prof = RuntimeProfiler(warmup=min(2, max(args.train_iters - 1, 0)), device=device,
                           model_flops=step_flops / world if step_flops else step_flops,
                           peak_flops=peak_flops)
    save_memory = bool(getattr(args, "save_profiled_memory", 0))
    preempt = rsl.PreemptionHandler().install() if getattr(args, "emergency_save", 0) else None
    saves = []

    def save_now(iteration: int, emergency: bool = False):
        meta = {"iteration": iteration}
        if emergency:
            meta["emergency"] = True
            meta["signal"] = interrupted
        # collective: every rank retries its own write and they agree
        p_view, o_view = model.checkpoint_view(params, opt_state)
        with prof.boundary():
            info = ckpt.save_checkpoint(
                args.save, iteration, p_view, o_view, hp, train_meta=meta,
                keep_latest_k=getattr(args, "keep_latest_k", 0) or None, provenance=provenance,
                meta={"model_type": args.model_type, "model_size": args.model_size},
                retry_policy=retry_policy, counters=res)
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
        """Drain the oldest in-flight step: its time, log line, telemetry
        and the guard's accounting. Returns (iteration, rollback_needed)."""
        d_it, metrics, disp_ms = inflight.popleft()
        prof.end(d_it, n_samples=hp.global_bsz)
        loss = float(metrics["loss"])
        if lead and d_it % max(args.log_interval, 1) == 0:
            prof.log_iteration(d_it, {"loss": loss, "grad_norm": float(metrics["grad_norm"])})
        emit_step_event(d_it, metrics, loss, disp_ms)
        if save_memory and not prof.memory_snapshots:
            prof.profile_memory(d_it, "after_step")
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
        if lead:
            print("iteration %d: %s anomaly (loss %r) — update skipped (strike %d/%d)"
                  % (d_it, verdict, loss, guard.strikes, guard.cfg.max_strikes))
        return d_it, guard.should_roll_back

    def drain_inflight(window: int) -> bool:
        """Drain until at most `window` steps remain in flight (0: the
        forced drain at eval/save/preemption boundaries). On a rollback the
        rest of the window is discarded (it extends the abandoned
        trajectory) and the state and stream are restored here. Returns True
        iff a rollback happened."""
        nonlocal it
        while len(inflight) > window:
            d_it, need_rollback = drain_one()
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
            if lead:
                print("rolled back to checkpoint iteration %d (rollback %d/%d, stream offset "
                      "+%d)" % (it, res.rollbacks, guard.cfg.max_rollbacks, offset))
            return True
        return False

    stream.open(start_iter)
    try:
        while True:
            if interrupted is None and it < args.train_iters:
                if hooks is not None and hooks.on_step:
                    hooks.on_step(it)
                if preempt is not None and _any_rank(preempt.triggered, device):
                    # every rank stops at the same boundary
                    interrupted = preempt.signal_name or "SIGTERM"
                    telemetry.emit("preemption", signal=interrupted, iter=it)
            if interrupted is not None or it >= args.train_iters:
                # a rollback surfacing in the final drain resumes training,
                # unless a preemption is exiting (its save takes priority)
                if drain_inflight(0) and interrupted is None:
                    continue
                break
            batch = next(stream)
            prof.start(it)
            # with the guard, the cap comes from the losses drained so far: it
            # lags the step by at most `inflight_steps` (NaN/Inf gating is exact)
            params, opt_state, metrics = step_fn(params, opt_state, batch, *run.step_args())
            inflight.append((it, metrics, prof.dispatched(it)))
            it += 1
            if drain_inflight(inflight_window):
                continue
            if eval_interval and it % eval_interval == 0:
                if drain_inflight(0):
                    continue
                with prof.boundary():
                    vloss = evaluate("valid")
                valid_losses.append((it, vloss))
                telemetry.emit("eval", iter=it, split="valid", loss=vloss)
                if lead:
                    print("iteration %d: valid loss %.6f" % (it, vloss))
            if args.save and args.save_interval and it % args.save_interval == 0:
                if drain_inflight(0):
                    continue
                save_now(it)
                last_save = it
        if interrupted is not None and args.save and last_save != it:
            save_now(it, emergency=True)
            res.emergency_saves += 1
            last_save = it
            if lead:
                print("emergency checkpoint at iteration %d (%s)" % (it, interrupted))
        elif args.save and last_save != it:
            save_now(it)
            last_save = it
        prof.loop_fence()
    finally:
        stream.close()
        if preempt is not None:
            preempt.uninstall()
    if save_memory:
        prof.profile_memory(it, "end")
    summary = prof.summary()
    summary["losses"] = losses
    summary["loss_iters"] = loss_iters
    summary["resilience"] = res.as_dict()
    if interrupted is not None:
        summary["interrupted"] = interrupted
    if eval_interval:
        summary["valid_losses"] = valid_losses
        summary["test_loss"] = evaluate("test")
        telemetry.emit("eval", iter=it, split="test", loss=summary["test_loss"])
        if lead:
            print("final test loss %.6f" % summary["test_loss"])
    summary["eval_flash_launches"] = eval_launches
    summary["eval_pass_ms"] = eval_ms
    summary["checkpoint_saves"] = saves
    if restored is not None:
        summary["checkpoint_restore"] = restored
    summary["flash_routes"] = _routes_since(routes)
    if getattr(cfg, "max_seq_len", None):
        summary["tokens_per_s"] = summary["samples_per_s"] * cfg.max_seq_len
        summary["tokens_per_s_per_gpu"] = summary["tokens_per_s"] / world
    if run.fam.data_kind == "vision":
        summary["images_per_s"] = summary["samples_per_s"]
    note = obs_flops.flops_note(cfg)
    if note:
        summary["mfu_note"] = note
    summary["world_size"] = world
    summary["rank"] = distributed.rank()
    summary["device"] = str(device)
    summary["device_kind"] = device_kind
    telemetry.emit("run_end", summary={
        k: v for k, v in summary.items()
        if k not in ("losses", "loss_iters", "valid_losses", "checkpoint_saves",
                     "checkpoint_restore", "memory_snapshots")})
    return summary


def main(argv: Optional[list] = None):
    args = initialize_galvatron(argv=argv, mode="train")
    try:
        summary = train(args)
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
    if summary["rank"] == 0:
        print({k: v for k, v in summary.items()
               if k not in ("losses", "loss_iters", "checkpoint_saves", "checkpoint_restore")})
        print("losses %s" % " ".join(repr(x) for x in summary["losses"]))
    return summary


if __name__ == "__main__":
    main()
