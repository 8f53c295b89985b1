"""``python -m galvatron_tpu_torch.cli train`` — training on 1..N GPUs.

Port of the core of ``galvatron_tpu/cli/train.py``: the model config and the
per-layer strategy from GLOBAL flags or a searched JSON
(``--galvatron_config_path``) -> strategy lint (train mode, with the model
config) -> model (this rank's shards) -> optimizer (clip + Adam + decoupled
weight decay, warmup + decay schedule, ZeRO-sharded moments) -> the
synthetic token stream of the reference (same batches for one seed, every
rank takes its rows) -> ``--train_iters`` steps of chunked loss and
gradients, each layer under its own layout and remat policy -> a summary
with the reference's timing keys and the losses, printed by rank 0.

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
forward and backward, on each rank's heads. Pipelines, context parallelism
and Ulysses refuse with a ValueError naming their ROADMAP item.
Checkpoints, real data (``--data_path``), evaluation, telemetry and the
resilience machinery are not ported yet, and their flags are refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch

from galvatron_tpu_torch.cli.arguments import (
    hp_config_from_args,
    initialize_galvatron,
    model_config_from_args,
)
from galvatron_tpu_torch.obs import flops as obs_flops
from galvatron_tpu_torch.ops import flash_attention
from galvatron_tpu_torch.profiler.runtime import RuntimeProfiler
from galvatron_tpu_torch.runtime import distributed
from galvatron_tpu_torch.runtime.dataloader import get_train_iterator
from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler


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
    """Everything one training run steps: the model config and strategy,
    this rank's parameters and Adam state, the optimizer, the train step
    and the synthetic batch stream (global batches: the step takes this
    rank's rows)."""
    cfg: Any
    hp: Any
    device: torch.device
    tx: Any
    params: Any
    opt_state: Any
    step: Callable
    data: Iterator


def build(args, device: Optional[torch.device] = None) -> TrainRun:
    """Strategy from the flags or the JSON -> train-mode lint -> model,
    optimizer, parameters, Adam state, step and stream on `device` (by
    default ``--device`` of a world of one; `train` passes the device of
    this rank)."""
    if device is None:
        device = distributed.local_device(args.device)
    fam, cfg = model_config_from_args(args)
    if fam.data_kind != "lm":
        raise ValueError("data_kind %r is not ported yet" % fam.data_kind)
    world = distributed.world_size()
    if args.world_size is not None and args.world_size != world:
        raise ValueError(
            "--world_size %d but the process group has %d rank(s): launch one process "
            "per rank (torchrun --nproc_per_node %d -m galvatron_tpu_torch.cli train ...)"
            % (args.world_size, world, args.world_size))
    hp = hp_config_from_args(args, cfg.num_layers, world)

    # fail fast on a bad strategy before anything is built
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

    lead = distributed.rank() == 0
    report = _slint.lint_hp(hp, model_cfg=cfg, mode="train",
                            file=getattr(args, "galvatron_config_path", None))
    for d in report.warnings if lead else ():
        print("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)
    if lead:
        print(hp.describe())

    model = construct_hybrid_parallel_model(cfg, hp, device)
    tx, _ = get_optimizer_and_scheduler(optimizer_args_from(args))
    params = model.init_params(args.seed)
    return TrainRun(
        cfg=cfg, hp=hp, device=device, tx=tx, params=params,
        opt_state=model.init_opt_state(tx, params), step=model.make_train_step(tx),
        data=get_train_iterator(hp, cfg.vocab_size, cfg.max_seq_len, seed=args.seed,
                                device=device))


def train(args) -> dict:
    """Returns the summary dict: the profiler's timing keys (FLOPs and MFU
    per GPU), the per-step losses, tokens/s (all ranks and per GPU), the
    flash kernels' launches by route on every rank, the device, the world
    size and this process's rank. Runs inside a process group that it
    tears down (`runtime.distributed.process_group`)."""
    with distributed.process_group(args.device) as device:
        return _train(args, device)


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


def _train(args, device) -> dict:
    run = build(args, device)
    routes = _flash_routes()
    cfg, hp = run.cfg, run.hp
    world = hp.world_size
    lead = distributed.rank() == 0
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    flops = obs_flops.train_step_flops(cfg, hp.global_bsz)
    prof = RuntimeProfiler(
        warmup=min(2, max(args.train_iters - 1, 0)),
        device=device,
        model_flops=flops / world if flops else flops,
        peak_flops=obs_flops.peak_flops_for(device_kind),
    )
    params, opt_state = run.params, run.opt_state
    losses = []
    for it in range(args.train_iters):
        batch = next(run.data)
        prof.start(it)
        params, opt_state, metrics = run.step(params, opt_state, batch)
        prof.end(it, n_samples=hp.global_bsz)
        loss = float(metrics["loss"])
        if lead and it % max(args.log_interval, 1) == 0:
            prof.log_iteration(it, {"loss": loss, "grad_norm": float(metrics["grad_norm"])})
        losses.append(loss)
    summary = prof.summary()
    summary["losses"] = losses
    summary["flash_routes"] = _routes_since(routes)
    summary["tokens_per_s"] = summary["samples_per_s"] * cfg.max_seq_len
    summary["tokens_per_s_per_gpu"] = summary["tokens_per_s"] / world
    summary["world_size"] = world
    summary["rank"] = distributed.rank()
    summary["device"] = str(device)
    summary["device_kind"] = device_kind
    return summary


def main(argv: Optional[list] = None):
    args = initialize_galvatron(argv=argv, mode="train")
    summary = train(args)
    if summary["rank"] == 0:
        print({k: v for k, v in summary.items() if k != "losses"})
        print("losses %s" % " ".join(repr(x) for x in summary["losses"]))
    return summary


if __name__ == "__main__":
    main()
