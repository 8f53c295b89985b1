"""Galvatron's loop on N GPUs of one host: profile, search, train, validate.

    python -m galvatron_tpu_torch.tools.loop_cell --gpus 4 \\
        --memory_constraint 44 16 --out chiprun_out/loop4

On the LLaMA configuration of ``tools/train_cell.py`` (LLaMA-7B width,
depth 8, seq 2048, bf16, global batch 8 in 2 micro-batches), each step a
subprocess with its log under ``--out``:

1. ``cli profile-hardware`` under ``torchrun --nproc_per_node N``: the
   NCCL all-reduce, p2p and all-to-all tables and the overlap coefficient;
2. ``cli profile`` in one process: the per-layer tables (as
   ``chip_smoke.py`` phase 12 runs it);
3. for each budget (GB per GPU): ``cli search`` at ``GALVATRON_WORLD_SIZE=N``
   (CPU) writes a strategy JSON; ``cli train`` under ``torchrun`` trains it
   as ``train_cell.argv`` says (its summary from the telemetry's ``run_end``
   event); this module's ``--validate`` mode under ``torchrun`` holds the
   cost model's predicted step ms and peak memory against a measured train
   step (``profiler/validate.py``; the peak is the largest rank's).

Prints one line per budget and, last, a JSON summary (also written to
``--out``/summary.json) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _torchrun(n: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n)]


def _run(cmd, log_path, env=None):
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-6000:]
        raise RuntimeError("%s failed (%d); log %s:\n%s" % (" ".join(cmd), proc.returncode,
                                                           log_path, tail))


def validate(strategy: str, config_dir: str, out: str) -> None:
    """One rank of the ``--validate`` mode (under torchrun)."""
    import torch

    from galvatron_tpu_torch.cli.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.cli.search import _hardware_paths
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.profiler import validate as V
    from galvatron_tpu_torch.profiler.model import ModelProfileArgs, ModelProfiler
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.tools import train_cell as C
    from galvatron_tpu_torch.utils.jsonio import read_json_config

    args = initialize_galvatron(argv=C.model_argv(), mode="search")
    cfg = model_config_from_args(args)[1]
    paths = ModelProfiler(cfg, "llama", ModelProfileArgs(config_dir=config_dir)).config_paths()
    comp, mem = read_json_config(paths["computation"]), read_json_config(paths["memory"])
    with distributed.process_group("cuda") as dev:
        world = distributed.world_size()
        hw = {k: read_json_config(path) for k, path in _hardware_paths(config_dir, world).items()
              if os.path.exists(path)}
        hp = HybridParallelConfig.from_json(strategy, world_size=world)
        tv, mv = V.validate(cfg, hp, comp, mem, hw)
        peak = torch.tensor([mv.measured_mb], device=dev)
        torch.distributed.all_reduce(peak, op=torch.distributed.ReduceOp.MAX)
        if distributed.rank() == 0:
            with open(out, "w") as f:
                json.dump({"predicted_ms": tv.predicted_ms, "measured_ms": tv.measured_ms,
                           "time_ratio": tv.ratio, "predicted_mb": mv.predicted_mb,
                           "measured_mb_rank0": mv.measured_mb,
                           "measured_mb_max": float(peak.item()),
                           "memory_ratio": float(peak.item()) / mv.predicted_mb}, f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--memory_constraint", type=float, nargs="+", default=[44.0])
    p.add_argument("--out", default=os.path.join("chiprun_out", "loop_cell"))
    p.add_argument("--validate", nargs=3, metavar=("STRATEGY", "CONFIG_DIR", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.validate:
        return validate(*args.validate)

    from galvatron_tpu_torch.tools import train_cell as C

    os.makedirs(args.out, exist_ok=True)
    cfg_dir = os.path.join(args.out, "configs")
    cli = ["-m", "galvatron_tpu_torch.cli"]
    model = C.model_argv()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    _run(_torchrun(args.gpus) + cli + ["profile-hardware", "--config_dir", cfg_dir],
         os.path.join(args.out, "profile_hardware.log"))
    _run([sys.executable] + cli + ["profile"] + model + [
        "--config_dir", cfg_dir, "--profile_batch_size", "8", "--layernum_min", "1",
        "--layernum_max", "3", "--profile_remat", "1"], os.path.join(args.out, "profile.log"))
    hardware = {name: json.load(open(os.path.join(cfg_dir, name)))
                for name in sorted(os.listdir(cfg_dir)) if "chips" in name or "overlap" in name}
    summary = {"card": card, "gpus": args.gpus, "hardware": hardware, "budgets": {}}
    env = dict(os.environ, GALVATRON_WORLD_SIZE=str(args.gpus))
    for gb in args.memory_constraint:
        tag = "%gGB" % gb
        strategy = os.path.join(args.out, "strategy_%s.json" % tag)
        _run([sys.executable] + cli + ["search"] + model + [
            "--config_dir", cfg_dir, "--memory_constraint", str(gb), "--settle_bsz",
            str(C.GLOBAL_BSZ), "--settle_chunk", str(C.CHUNKS), "--output_config_path",
            strategy, "--log_dir", os.path.join(args.out, "search_logs")],
            os.path.join(args.out, "search_%s.log" % tag), env=env)
        telemetry = os.path.join(args.out, "train_%s.jsonl" % tag)
        _run(_torchrun(args.gpus) + cli + ["train"] + C.argv(strategy) + [
            "--telemetry", telemetry], os.path.join(args.out, "train_%s.log" % tag))
        with open(telemetry) as f:
            run_end = [json.loads(line) for line in f if '"run_end"' in line][-1]["summary"]
        val = os.path.join(args.out, "validate_%s.json" % tag)
        _run(_torchrun(args.gpus) + ["-m", "galvatron_tpu_torch.tools.loop_cell", "--validate",
                                     strategy, cfg_dir, val],
             os.path.join(args.out, "validate_%s.log" % tag))
        with open(strategy) as f, open(val) as g:
            row = {"strategy": json.load(f), "validate": json.load(g),
                   "train": {k: run_end.get(k) for k in ("steady_step_ms", "device_step_ms",
                                                          "peak_hbm_mb", "mfu",
                                                          "tokens_per_s_per_gpu",
                                                          "flash_routes")}}
        summary["budgets"][tag] = row
        v = row["validate"]
        print("%s on %d GPUs: strategy %s; train step %.1f ms, peak %.2f GB (rank 0); validate "
              "%.1f ms predicted / %.1f measured (%.3f), %.2f GB predicted / %.2f measured "
              "(max over ranks, %.3f)" % (
                  tag, args.gpus, {k: row["strategy"][k] for k in row["strategy"]
                                   if k in ("pp_deg", "tp_sizes_enc", "dp_types_enc",
                                            "checkpoint", "vtp", "chunks")},
                  row["train"]["steady_step_ms"], row["train"]["peak_hbm_mb"] / 1024.0,
                  v["predicted_ms"], v["measured_ms"], v["time_ratio"],
                  v["predicted_mb"] / 1024.0, v["measured_mb_max"] / 1024.0,
                  v["memory_ratio"]), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
