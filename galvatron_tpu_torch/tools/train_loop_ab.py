"""The train loop's options side by side, in one process on one GPU.

    python -m galvatron_tpu_torch.tools.train_loop_ab [--cell llama|gpt_zero2] \\
        [--repeats 2] [--out chiprun_out/train_loop_ab.json]

Runs ``cli.train.main`` on a configuration of ``tools/train_cell.py`` (the
one ``chip_smoke.py`` trains) under four loops, in the order a b c d d c b a
(each repeat reversed), so a drift of the card's clock or temperature over
the call falls on every variant alike:

- ``sync_unguarded``: ``--anomaly_guard 0 --no_async_loop`` (the loop of
  the slice before the guard and the prefetch thread: batches made on the
  critical path, every step drained);
- ``sync_guarded``: ``--no_async_loop`` (the guard alone);
- ``async_unguarded``: ``--anomaly_guard 0`` (prefetch thread and the
  two-step drain window alone);
- ``default``: guard, prefetch and drain window, as a user runs it.

Prints one line per run (the step ms end to end: the median step period,
from one step's end to the next's on the device's clock, idle included;
the device ms: the stream's busy span of a step; the fenced loop wall per
step; host blocked ms; MFU, from the periods) and a JSON summary with the
medians per variant and whether every run's losses equal the first run's
bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess

VARIANTS = {
    "sync_unguarded": ["--anomaly_guard", "0", "--no_async_loop"],
    "sync_guarded": ["--no_async_loop"],
    "async_unguarded": ["--anomaly_guard", "0"],
    "default": [],
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", choices=("llama", "gpt_zero2"), default="llama")
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--out", default=os.path.join("chiprun_out", "train_loop_ab.json"))
    args = p.parse_args(argv)

    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.tools import train_cell as C

    out_dir = os.path.dirname(args.out) or "."
    base = (C.argv(C.write_strategy(out_dir)) if args.cell == "llama"
            else C.gpt_argv(C.write_gpt_strategy(out_dir, fsdp=False)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    order = list(VARIANTS)
    runs = []
    for r in range(args.repeats):
        for name in (order if r % 2 == 0 else order[::-1]) + \
                (order[::-1] if r % 2 == 0 else order):
            s = cli_train.main(base + ["--log_interval", "100"] + VARIANTS[name])
            runs.append(dict(variant=name, steady_step_ms=s["steady_step_ms"],
                             device_step_ms=s["device_step_ms"],
                             wall_ms_per_iter=s.get("wall_ms_per_iter"),
                             host_blocked_ms=s.get("host_blocked_ms"), mfu=s.get("mfu"),
                             losses=s["losses"]))
            print("%-16s step %.2f ms end to end, device %.2f ms, loop wall %.2f ms/step, host "
                  "blocked %.3f ms, MFU %.4f"
                  % (name, s["steady_step_ms"], s["device_step_ms"],
                     s.get("wall_ms_per_iter", float("nan")),
                     s.get("host_blocked_ms", float("nan")), s.get("mfu", float("nan"))),
                  flush=True)
    summary = {"card": card, "cell": args.cell, "runs": runs,
               "losses_bitwise_equal": all(r["losses"] == runs[0]["losses"] for r in runs),
               "median_steady_step_ms": {n: statistics.median(
                   r["steady_step_ms"] for r in runs if r["variant"] == n) for n in VARIANTS},
               "median_device_step_ms": {n: statistics.median(
                   r["device_step_ms"] for r in runs if r["variant"] == n) for n in VARIANTS},
               "median_wall_ms_per_iter": {n: statistics.median(
                   r["wall_ms_per_iter"] for r in runs if r["variant"] == n) for n in VARIANTS}}
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(card)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    return summary


if __name__ == "__main__":
    main()
