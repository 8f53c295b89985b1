"""Where a train step's time goes on the GPU: steady steps of the port's
train step under ``torch.profiler``.

    python -m galvatron_tpu_torch.tools.profile_train \\
        [--cell llama|gpt_zero3|gpt_zero2|bert|vit|t5] [--warmup 2] [--steps 2] \\
        [--top 15] [--trace_dir chiprun_out]

The run is a configuration that ``chip_smoke.py`` trains
(``tools/train_cell.py``: the LLaMA cell, the GPT cell through the layout
path with layers 0-3 ZeRO-3 or with ZeRO-2 everywhere, BERT-large with
every layer plain dp, ViT-huge on synthetic pixels, or T5-large with every
layer plain dp on the synthetic seq2seq stream; its strategy JSON is
written into ``--trace_dir`` or ``build/galvatron_tpu_torch``), built by
``cli.train.build`` at world size 1 and stepped as ``cli train`` steps it:
the same step (with the anomaly guard as the flags set it, on by default)
on batches from the same prefetched stream (``cli.train.BatchStream``).
After
``--warmup`` untraced steps it traces ``--steps`` steps and prints the wall
time per step, the device-busy time (the sum of kernel times the profiler
records), the device's idle share, the device time by kind (the
flash-attention forward and backward kernels, matrix products, the rest),
the optimizer update's share of the step (CUDA events around it), the
plain attention path's device time (`plain_attention_ms`: the kernels of
the batched products of ``ops.attention._xla_attention`` and their
gradients, and of every op, forward or backward, that reads a tensor of
the attention scores' shape, (..., S, S); the fp32 casts of q, k and v
are left out) and the kernels that take the most device time. Needs a
CUDA GPU; raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import torch

# device-kernel name fragments -> kind (first match wins)
_KINDS = (
    ("flash_attn_fwd", ("flash_fwd",)),
    ("flash_attn_bwd", ("BwdParams",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("collective", ("nccl",)),
)


def kind_of(kernel: str) -> str:
    for kind, fragments in _KINDS:
        if any(f in kernel for f in fragments):
            return kind
    return "other"


def plain_attention_ms(prof, seq_len: int) -> float:
    """Device ms of the kernels that the plain attention path's ops
    launched themselves (each kernel counted once, on the innermost op):
    the batched products (the plain attention's einsums; every projection
    is a 2-D product) and every op with an input of the scores' shape
    (..., seq_len, seq_len). Needs a trace recorded with
    ``record_shapes``."""
    from torch.autograd import DeviceType

    def scores(shapes):
        return any(len(s) >= 2 and list(s[-2:]) == [seq_len, seq_len] for s in shapes or ())

    return sum(ev.self_device_time_total for ev in prof.key_averages(group_by_input_shape=True)
               if ev.device_type == DeviceType.CPU
               and (ev.key == "aten::bmm" or scores(ev.input_shapes))) / 1e3


def breakdown(prof, wall_ms: float, steps: int, top: int, seq_len: int) -> Dict:
    from galvatron_tpu_torch.tools.profile_serve import kernel_rows

    rows = kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    kinds: Dict[str, float] = {}
    for key, ms, _ in rows:
        kinds[kind_of(key)] = kinds.get(kind_of(key), 0.0) + ms
    attention = plain_attention_ms(prof, seq_len)
    return {
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "plain_attention_ms_per_step": attention / steps,
        "plain_attention_share_of_busy": attention / busy if busy else None,
        "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms > 0 else None,
        "by_kind_ms_per_step": {k: v / steps for k, v in sorted(kinds.items(), key=lambda x: -x[1])},
        "top": [{"kernel": k[:120], "ms_per_step": ms / steps,
                 "share_of_busy": ms / busy if busy else None, "calls_per_step": n / steps}
                for k, ms, n in rows[:top]],
    }


def main(argv: List[str] = None) -> Dict:
    p = argparse.ArgumentParser("galvatron_tpu_torch-profile_train")
    p.add_argument("--cell", default="llama",
                   choices=("llama", "gpt_zero3", "gpt_zero2", "bert", "vit", "t5"))
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--trace_dir", default=None)
    p.add_argument("--t5_batch", type=int, default=None,
                   help="the t5 cell's global batch, in one micro-batch (default: the "
                        "cell's 32 in 4): the trace's cost grows with the ops it records")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA GPU (torch.cuda.is_available() is False)")

    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.cli.arguments import initialize_galvatron
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.tools import train_cell

    out_dir = args.trace_dir or os.path.join("build", "galvatron_tpu_torch")
    if args.cell == "llama":
        train_argv = train_cell.argv(train_cell.write_strategy(out_dir))
    elif args.cell == "bert":
        train_argv = train_cell.bert_argv(train_cell.write_bert_strategy(out_dir))
    elif args.cell == "vit":
        train_argv = train_cell.vit_argv()
    elif args.cell == "t5" and args.t5_batch:
        train_argv = train_cell.t5_argv(train_cell.write_t5_strategy(
            out_dir, bsz=args.t5_batch, chunks=1), bsz=args.t5_batch, chunks=1)
    elif args.cell == "t5":
        train_argv = train_cell.t5_argv(train_cell.write_t5_strategy(out_dir))
    else:
        train_argv = train_cell.gpt_argv(train_cell.write_gpt_strategy(
            out_dir, fsdp=args.cell == "gpt_zero3"))
    targs = initialize_galvatron(train_argv, mode="train")
    torch.backends.cuda.matmul.allow_tf32 = False
    with distributed.process_group(targs.device) as device:
        run = cli_train.build(targs, device)
        stream = cli_train.BatchStream(targs, run).open(0)
        try:
            return _profile(args, run, stream, train_argv)
        finally:
            stream.close()


def _profile(args, run, stream, train_argv) -> Dict:
    from torch.profiler import ProfilerActivity, profile

    params, state, tx = run.params, run.opt_state, run.tx
    for _ in range(args.warmup):
        params, state, _ = run.step(params, state, next(stream), *run.step_args())

    # the optimizer update's device time, from events around tx.update
    # (the step has synchronised once before it, reading the gradient norm)
    update, update_ms = tx.update, []

    def timed_update(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        norm = update(*a, **kw)
        end.record()
        end.synchronize()
        update_ms.append(start.elapsed_time(end))
        return norm

    tx.update = timed_update
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            params, state, metrics = run.step(params, state, next(stream), *run.step_args())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    hp = run.hp
    out = {"device": torch.cuda.get_device_name(0), "cell": args.cell, "argv": train_argv,
           "num_layers": run.cfg.num_layers, "global_bsz": hp.global_bsz, "chunks": hp.chunks,
           "seq_len": run.cfg.max_seq_len, "checkpoint": [s.checkpoint for s in hp.layers],
           "remat_policy": [s.remat_policy for s in hp.layers], "steps": args.steps,
           "guard": run.guard is not None, "prefetch_batches": stream.depth,
           "loss": float(metrics["loss"])}
    out.update(breakdown(prof, wall, args.steps, args.top, run.cfg.max_seq_len))
    out["optimizer_ms_per_step"] = sum(update_ms) / len(update_ms)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "profile_train_%s.json" % args.cell))
    print("train step: wall %.2f ms, device busy %.2f ms, idle share %.3f" % (
        out["wall_ms_per_step"], out["device_busy_ms_per_step"], out["idle_share"]))
    for kind, ms in out["by_kind_ms_per_step"].items():
        print("  %-15s %9.3f ms %5.1f%%" % (kind, ms, 100 * ms / out["device_busy_ms_per_step"]))
    print("  optimizer update %.3f ms per step (CUDA events)" % out["optimizer_ms_per_step"])
    print("  plain attention %.3f ms per step, %.1f%% of busy" % (
        out["plain_attention_ms_per_step"], 100 * (out["plain_attention_share_of_busy"] or 0)))
    for row in out["top"]:
        print("  %9.3f ms %5.1f%% x%-6g %s" % (row["ms_per_step"], 100 * row["share_of_busy"],
                                             row["calls_per_step"], row["kernel"]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
