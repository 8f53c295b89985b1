"""Long context on N GPUs of one host: ``cli train`` under ring cp, Ulysses
and both on one layer.

    python -m galvatron_tpu_torch.tools.long_context_cell --gpus 4 \\
        --out chiprun_out/lc4

LLaMA-7B width (h 4096, 32 heads of 128, ffn 11008, vocab 32000) at depth
8 (cut from 32 for memory, as ``tools/train_cell.py`` says), sequence
32768, bf16, one sequence per step (global batch 1, one micro-batch), full
remat on every layer, 4 steps, trained under ``torchrun --nproc_per_node
N`` through each of:

- ``cp4_zigzag``: every layer cp N (zigzag), vocab cp N;
- ``ulysses4``: every layer tp N with Ulysses sp, vocab tp N with vocab sp;
- ``ulysses2_cp2``: every layer tp 2 with Ulysses and cp N/2 (zigzag),
  vocab tp 2 with vocab sp and vocab cp N/2.

Each run's log and telemetry go under ``--out``; the summary (step ms end
to end and on the device, tokens/s per GPU, MFU, rank 0's peak memory, the
flash routes, the losses from rank 0's log) is printed per run and, last,
as one JSON line (also ``--out``/summary.json) with the card's name and
power limit and the largest relative spread of one step's loss over the
layouts (one model, seed and batch: the layouts must agree to rounding).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from galvatron_tpu_torch.tools import train_cell as C
from galvatron_tpu_torch.tools.loop_cell import _run, _torchrun

SEQ = 32768
STEPS = 4


def strategies(gpus: int):
    """name -> (per-layer tp, use_sp, cp; vocab tp, vsp, vcp)."""
    half = gpus // 2
    return {
        "cp%d_zigzag" % gpus: (1, 0, gpus, 1, 0, gpus),
        "ulysses%d" % gpus: (gpus, 1, 1, gpus, 1, 1),
        "ulysses2_cp%d" % half: (2, 1, half, 2, 1, half),
    }


def write_strategy(out_dir: str, name: str, tp: int, sp: int, cp: int, vtp: int, vsp: int,
                   vcp: int) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "long_context_%s.json" % name)
    n = C.LAYERS
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join([str(tp)] * n),
                   "tp_consecutive_flags": ",".join(["1"] * n),
                   "use_sp": ",".join([str(sp)] * n), "cp_sizes_enc": ",".join([str(cp)] * n),
                   "dp_types_enc": ",".join(["0"] * n), "checkpoint": ",".join(["1"] * n),
                   "vtp": vtp, "vsp": vsp, "vcp": vcp, "cp_mode": "zigzag",
                   "global_bsz": 1, "chunks": 1}, f)
    return path


def argv(strategy_path: str, telemetry: str):
    return C.model_argv() + [
        "--set_seqlen_manually", "1", "--seq_length", str(SEQ), "--device", "cuda",
        "--global_train_batch_size", "1", "--chunks", "1",
        "--galvatron_config_path", strategy_path, "--train_iters", str(STEPS),
        "--lr", "1e-4", "--lr_warmup_iters", "1", "--seed", str(C.SEED),
        "--telemetry", telemetry]


def _losses(log_path: str):
    """The per-step losses rank 0 prints (``losses ...``) in a run's log."""
    with open(log_path) as f:
        lines = [line for line in f if line.startswith("losses ")]
    return [float(x) for x in lines[-1].split()[1:]]


def main(args=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--out", default=os.path.join("chiprun_out", "long_context_cell"))
    a = p.parse_args(args)
    os.makedirs(a.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    summary = {"card": card, "gpus": a.gpus, "seq": SEQ, "layers": C.LAYERS, "runs": {}}
    for name, layout in strategies(a.gpus).items():
        strategy = write_strategy(a.out, name, *layout)
        telemetry = os.path.join(a.out, "train_%s.jsonl" % name)
        log = os.path.join(a.out, "train_%s.log" % name)
        _run(_torchrun(a.gpus) + ["-m", "galvatron_tpu_torch.cli", "train"]
             + argv(strategy, telemetry), log)
        with open(telemetry) as f:
            run_end = [json.loads(line) for line in f if '"run_end"' in line][-1]["summary"]
        row = {k: run_end.get(k) for k in ("steady_step_ms", "device_step_ms",
                                           "tokens_per_s_per_gpu", "mfu", "peak_hbm_mb",
                                           "flash_routes")}
        row["losses"] = _losses(log)
        summary["runs"][name] = row
        print("%s on %d GPUs (llama-7b width, %d layers, seq %d, full remat): step %.1f ms end "
              "to end, device %.1f ms, %.0f tokens/s per GPU, MFU %.3f, peak %.2f GiB (rank 0), "
              "losses %s" % (name, a.gpus, C.LAYERS, SEQ, row["steady_step_ms"],
                             row["device_step_ms"], row["tokens_per_s_per_gpu"], row["mfu"],
                             row["peak_hbm_mb"] / 1024.0, row["losses"]), flush=True)
    steps = zip(*[r["losses"] for r in summary["runs"].values()])
    summary["loss_rel_spread"] = max((max(ls) - min(ls)) / abs(min(ls)) for ls in steps)
    print("losses agree across the layouts within %.3g relative" % summary["loss_rel_spread"])
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.exit(main())
