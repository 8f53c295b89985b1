"""``python -m galvatron_tpu_torch.cli train`` — training on one device.

Port of the core of ``galvatron_tpu/cli/train.py``: the model config and the
per-layer strategy from GLOBAL flags or a searched JSON
(``--galvatron_config_path``) -> strategy lint (train mode) -> model ->
optimizer (clip + Adam + decoupled weight decay, warmup + decay schedule) ->
the synthetic token stream of the reference (same batches for one seed) ->
``--train_iters`` steps of chunked loss and gradients, each layer under its
own remat policy -> a summary with the reference's timing keys and the
losses.

    python -m galvatron_tpu_torch.cli train --model_type llama \\
        --model_size llama-7b --set_layernum_manually 1 --num_layers 8 \\
        --global_train_batch_size 8 --chunks 2 --device cuda

The run happens on ``--device`` (default ``cuda``); with no GPU visible
``cuda`` raises. Attention at flash-eligible shapes (head_dim >= 128, a
sequence that is a multiple of 128) goes through the hand-written
flash-attention kernels, forward and backward. Any layout other than world
size 1 refuses with a ValueError. Checkpoints, real data (``--data_path``),
evaluation, telemetry and the resilience machinery are not ported yet, and
their flags are refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch

from galvatron_tpu_torch.cli.arguments import (
    hp_config_from_args,
    initialize_galvatron,
    model_config_from_args,
    resolve_device,
)
from galvatron_tpu_torch.obs import flops as obs_flops
from galvatron_tpu_torch.profiler.runtime import RuntimeProfiler
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
    the parameters and Adam state, the optimizer, the train step and
    the synthetic batch stream."""
    cfg: Any
    hp: Any
    device: torch.device
    tx: Any
    params: Any
    opt_state: Any
    step: Callable
    data: Iterator


def build(args) -> TrainRun:
    """Strategy from the flags or the JSON -> train-mode lint -> model,
    optimizer, parameters, Adam state, step and stream on ``--device``."""
    device = resolve_device(args.device)
    fam, cfg = model_config_from_args(args)
    if fam.data_kind != "lm":
        raise ValueError("data_kind %r is not ported yet" % fam.data_kind)
    hp = hp_config_from_args(args, cfg.num_layers, args.world_size or 1)

    # fail fast on a bad strategy before anything is built
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

    report = _slint.lint_hp(hp, file=getattr(args, "galvatron_config_path", None), mode="train")
    for d in report.warnings:
        print("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)
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
    """Returns the summary dict: the profiler's timing keys, the per-step
    losses, tokens/s and the device."""
    run = build(args)
    cfg, hp, device = run.cfg, run.hp, run.device
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    prof = RuntimeProfiler(
        warmup=min(2, max(args.train_iters - 1, 0)),
        device=device,
        model_flops=obs_flops.train_step_flops(cfg, hp.global_bsz),
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
        if it % max(args.log_interval, 1) == 0:
            prof.log_iteration(it, {"loss": loss, "grad_norm": float(metrics["grad_norm"])})
        losses.append(loss)
    summary = prof.summary()
    summary["losses"] = losses
    summary["tokens_per_s"] = summary["samples_per_s"] * cfg.max_seq_len
    summary["device"] = str(device)
    summary["device_kind"] = device_kind
    return summary


def main(argv: Optional[list] = None):
    args = initialize_galvatron(argv=argv, mode="train")
    summary = train(args)
    print({k: v for k, v in summary.items() if k != "losses"})
    return summary


if __name__ == "__main__":
    main()
