"""T5's relative-position bias, forward and backward, two ways on one card.

``models.t5.position_bias`` builds the (1, heads, S, S) bias as a gather of
the (buckets, heads) table; its backward (`models.t5._TableRows`) sums each
head's gradient per bucket with ``torch.bincount``. The gather's own
backward (plain autograd indexing) scatters S * S * heads atomic adds onto
the table's few rows. This times both at T5-large's 16 heads, in turns
(gather, bincount, bincount, gather), with CUDA events, and holds the two
gradients against each other.

    python -m galvatron_tpu_torch.tools.bench_t5_bias --seq 512 4096
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from galvatron_tpu_torch.models import t5 as T5


def _bias(table, n, cfg, custom: bool):
    lookup = T5._bucket_table(n, True, cfg.rel_buckets, cfg.rel_max_distance,
                              str(table.device))
    pos = torch.arange(n, device=table.device)
    bucket = lookup[pos[None, :] - pos[:, None] + n - 1]
    if custom:
        return T5._TableRows.apply(table.float(), bucket)
    return table.float()[bucket].permute(2, 0, 1)


def bench(n: int, reps: int = 10) -> dict:
    """Median ms of a forward + backward per way (two runs each) and the
    gradients' largest difference relative to the gather's largest."""
    cfg = T5.t5_config("t5-large")
    dev = torch.device("cuda")
    table = torch.randn(cfg.rel_buckets, cfg.num_heads, device=dev, requires_grad=True)
    g = torch.randn(cfg.num_heads, n, n, device=dev)
    out, grads = {}, {}
    for name, custom in (("gather", False), ("bincount", True), ("bincount_2", True),
                         ("gather_2", False)):
        def once():
            table.grad = None
            (_bias(table, n, cfg, custom) * g).sum().backward()
        for _ in range(3):
            once()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            once()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name + "_ms"] = statistics.median(times)
        grads[name] = table.grad.clone()
    out["grad_rel_diff"] = float((grads["bincount"] - grads["gather"]).abs().max()
                                 / grads["gather"].abs().max())
    return out


def main(argv=None):
    p = argparse.ArgumentParser("T5 relative-bias forward + backward, gather vs bincount")
    p.add_argument("--seq", type=int, nargs="+", default=[512, 4096])
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    results = {n: bench(n) for n in a.seq}
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
