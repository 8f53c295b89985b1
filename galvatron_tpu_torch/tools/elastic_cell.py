"""Elastic resume on N GPUs of one host: a world-N checkpoint resumed on N/2.

    python -m galvatron_tpu_torch.tools.elastic_cell --gpus 4 --out chiprun_out/elastic4

On the LLaMA configuration of ``tools/train_cell.py`` (LLaMA-7B width,
depth 8, seq 2048, bf16, global batch 8 in 2 micro-batches, its remat mix)
under a world-N strategy that mixes Megatron tp 2, ZeRO-3, ZeRO-2 and
vocab tp 2 (`write_strategy`), each run a ``cli train`` under ``torchrun``
(NCCL) with its log under ``--out``:

1. ``STEPS`` steps at world N, saving at step 3 (each rank its shards)
   and at the end: the reference losses;
2. ``--elastic search --elastic_memory_gb MEMORY_GB`` at world N/2 from
   that checkpoint to ``STEPS``: the search re-plans for N/2 GPUs under the
   global batch and the budget (analytic tables), and the restore moves
   every rank's shards of the params and both Adam moments across the
   strategies, checking that the restored leaves, gathered one at a time
   and cut again under the saved strategy, reproduce the manifest's sha256
   records (a mismatch exits 2, GLS016).

Prints the plan, the restore's seconds and the device memory its
continuity check took beyond the live state (its telemetry event), the
resumed losses beside the reference's (relative difference: the layouts
round differently in bf16) and a JSON summary, also written to
``--out``/summary.json, with the card's name and power limit. ``--device
cpu --tiny`` rehearses the same runs on gloo ranks at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

STEPS = 6
SAVE_AT = 3
MEMORY_GB = 32.0
TINY = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size", "64",
        "--num_attention_heads", "4", "--ffn_hidden_size", "96", "--num_layers", "8",
        "--vocab_size", "128", "--seq_length", "64"]


def write_strategy(out_dir: str, gpus: int) -> str:
    """The world-`gpus` strategy: layers 0-3 Megatron tp 2 (1 and 3
    ZeRO-3), 4-7 plain dp (5 ZeRO-3), ZeRO-2 by default, vocab tp 2, the
    train cell's remat mix."""
    from galvatron_tpu_torch.tools import train_cell as C

    path = os.path.join(out_dir, "strategy_world%d.json" % gpus)
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": "2,2,2,2,1,1,1,1",
                   "tp_consecutive_flags": ",".join(["1"] * C.LAYERS),
                   "dp_types_enc": "0,1,0,1,0,1,0,0", "default_dp_type": "zero2", "vtp": 2,
                   "checkpoint": ",".join(map(str, C.CHECKPOINT)),
                   "remat_policy": ",".join(C.REMAT_POLICY),
                   "global_bsz": C.GLOBAL_BSZ, "chunks": C.CHUNKS}, f)
    return path


def _run(n: int, argv, log_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), "-m", "galvatron_tpu_torch.cli", "train"] + list(argv)
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT)
    with open(log_path) as f:
        text = f.read()
    if proc.returncode != 0:
        raise RuntimeError("%s failed (%d); log %s:\n%s" % (" ".join(cmd), proc.returncode,
                                                           log_path, text[-6000:]))
    losses = [line for line in text.splitlines() if line.startswith("losses ")][-1]
    return [float(x) for x in losses.split()[1:]]


def _events(path, kind):
    with open(path) as f:
        return [e for e in map(json.loads, f) if e.get("type") == kind]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--memory_gb", type=float, default=MEMORY_GB)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true", help="a tiny LLaMA (CPU rehearsal)")
    p.add_argument("--out", default=os.path.join("chiprun_out", "elastic_cell"))
    args = p.parse_args(argv)

    from galvatron_tpu_torch.tools import train_cell as C

    os.makedirs(args.out, exist_ok=True)
    strategy = write_strategy(args.out, args.gpus)
    base = (TINY + ["--mixed_precision", "bf16"] if args.tiny else C.model_argv()) + [
        "--device", args.device, "--global_train_batch_size", str(C.GLOBAL_BSZ), "--chunks",
        str(C.CHUNKS), "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(C.SEED),
        "--train_iters", str(STEPS), "--log_interval", "1"]
    ckpt = os.path.join(args.out, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    card = ["cpu"] if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    full = _run(args.gpus, base + ["--galvatron_config_path", strategy, "--save", ckpt,
                                   "--save_interval", str(SAVE_AT)],
                os.path.join(args.out, "full.log"))
    telemetry = os.path.join(args.out, "resume.jsonl")
    resumed = _run(args.gpus // 2, base + [
        "--load", ckpt, "--load_iteration", str(SAVE_AT), "--elastic", "search",
        "--elastic_memory_gb", str(args.memory_gb), "--telemetry", telemetry],
        os.path.join(args.out, "resume.log"))
    restore = _events(telemetry, "checkpoint_restore")[-1]
    plan = _events(telemetry, "run_start")[-1]["strategy"]
    if not restore.get("cross_strategy") or len(resumed) != STEPS - SAVE_AT:
        raise RuntimeError("the world-%d run did not resume across strategies: %s, losses %s"
                           % (args.gpus // 2, restore, resumed))
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, full[SAVE_AT:])]
    summary = {"card": card, "gpus": args.gpus, "resumed_on": args.gpus // 2,
               "memory_gb": args.memory_gb, "saved_strategy": json.load(open(strategy)),
               "plan": plan, "restore_ms": restore.get("duration_ms"),
               "restore_device_extra_gb": restore.get("device_extra_gb"), "full_losses": full,
               "resumed_losses": resumed, "loss_rel_err": rel}
    shutil.rmtree(ckpt, ignore_errors=True)
    print("world %d -> %d (--elastic search, %.0f GB): plan %s; restore %.2f s (device memory "
          "%s GB beyond the live state); resumed losses %s vs uninterrupted %s (max rel %.3g)" % (
              args.gpus, args.gpus // 2, args.memory_gb,
              {k: plan[k] for k in plan if k in ("pp_deg", "tp_sizes_enc", "dp_types_enc",
                                                  "checkpoint", "vtp", "chunks")},
              (restore.get("duration_ms") or 0.0) / 1e3, restore.get("device_extra_gb"), resumed,
              full[SAVE_AT:], max(rel)),
          flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
