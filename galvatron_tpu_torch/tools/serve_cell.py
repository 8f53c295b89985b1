"""Serve LLaMA-7B (32 layers) on one GPU and on N GPUs through ``cli serve``.

    python -m galvatron_tpu_torch.tools.serve_cell --gpus 4 --out chiprun_out/serve4
    python -m galvatron_tpu_torch.tools.serve_cell --device cpu --tiny --out build/serve_tiny

Two ``torchrun`` launches, one per world (world 1, then N), each running a
list of ``cli serve`` invocations in one process group (this module as the
worker, ``--runs PLAN``; every run is ``cli.serve.main`` on its argv, with
the CLI's fault-injection seam where a run needs one):

- **perf** (bf16, the CLI's default): phase 7's load of ``chip_smoke.py``
  (16 requests, prompts of 100-1500 tokens, 32 new, 8 slots, pages of 128)
  at world 1 and under tp N, tp N/2 x dp 2 and dp N, each after a short
  warm-up run of its layout (the kernels are built first; NCCL makes a
  group's communicator at its first collective): TTFT and TPOT p50/p99,
  tokens/s per GPU, every rank's peak memory and forward-kernel launches,
  and the first decode tick's logits, held against world 1's within
  ``chip_smoke.TOL_REPLAY`` on the slots whose prefill sampled world 1's
  token (a bf16 near-tie may pick another);
- **parity** (fp32 compute, the tests' ``fp32_compute``): 4 requests of up
  to 300 tokens, 6 new, under every layout: the greedy tokens equal world
  1's;
- **migration** (fp32 compute, last: ranks leave): the parity load under
  dp N whose mesh probe loses ranks N/2.. at decode step 2:
  ``--migrate_on_degrade`` moves the params onto tp 2 for the N/2
  survivors (``--elastic_strategy``) and journal-replays the in-flight
  requests; its seconds and replayed / shed counts, and the completed
  tokens equal to world 1's.

Writes ``summary.json`` (and each launch's log) under ``--out`` and exits
non-zero when a check fails. ``--tiny`` cuts the model to a 2-layer llama
(h 256, 4 heads) and the loads, for a rehearsal on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = ["--model_type", "llama", "--model_size", "llama-7b"]
TINY_MODEL = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size",
              "256", "--num_attention_heads", "4", "--ffn_hidden_size", "128", "--num_layers",
              "2", "--vocab_size", "64", "--seq_length", "512"]
PERF_LOAD = ["--serve_max_concurrency", "8", "--serve_page_size", "128", "--num_requests", "16",
             "--prompt_len_min", "100", "--prompt_len_max", "1500", "--max_new_tokens", "32",
             "--rate_rps", "0", "--seed", "1234"]
PARITY_LOAD = ["--serve_max_concurrency", "4", "--serve_page_size", "128", "--num_requests", "4",
               "--prompt_len_min", "100", "--prompt_len_max", "300", "--max_new_tokens", "6",
               "--rate_rps", "0", "--seed", "1234"]
TINY_LOAD = ["--serve_page_size", "128", "--prompt_len_min", "100", "--prompt_len_max", "300",
             "--rate_rps", "0", "--seed", "1234"]
LOGIT_TICKS = 1  # decode ticks whose logits are kept
# chip_smoke.TOL_REPLAY: bf16 logits of two equivalent paths through 32
# layers (chip_smoke.TOL_DECODE's 0.15 for 4 layers, scaled to 8x the layers)
TOL_LOGITS = 0.15 * 8 ** 0.5


def _layouts(n: int) -> Dict[str, int]:
    """name -> tp of every layer (the rest of the world is dp)."""
    return {"tp%d" % n: n, "tp%d_dp2" % (n // 2): n // 2, "dp%d" % n: 1} if n > 1 else {}


def _strategy(path: str, tp: int, layers: int) -> str:
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join([str(tp)] * layers),
                   "tp_consecutive_flags": ",".join(["1"] * layers),
                   "dp_types_enc": ",".join(["0"] * layers), "global_bsz": 8}, f)
    return path


def plan(world: int, out: str, device: str, tiny: bool) -> List[dict]:
    """The runs of one launch."""
    layers = 2 if tiny else 32
    model = TINY_MODEL if tiny else MODEL
    perf = TINY_LOAD + ["--serve_max_concurrency", "4", "--num_requests", "6",
                        "--max_new_tokens", "4"] if tiny else PERF_LOAD
    parity = TINY_LOAD + ["--serve_max_concurrency", "4", "--num_requests", "4",
                          "--max_new_tokens", "4"] if tiny else PARITY_LOAD
    base = model + ["--device", device, "--world_size", str(world),
                    "--global_train_batch_size", "8"]
    layouts = _layouts(world) or {"world1": 1}
    runs = []
    warm = ["--num_requests", "2", "--max_new_tokens", "2"]
    for name, tp in layouts.items():
        s = _strategy(os.path.join(out, "w%d_%s.json" % (world, name)), tp, layers)
        runs.append(dict(name="warmup_" + name, argv=base + perf + warm +
                         ["--galvatron_config_path", s], fp32=False, logits=0))
        runs.append(dict(name="perf_" + name, argv=base + perf + ["--galvatron_config_path", s],
                         fp32=False, logits=LOGIT_TICKS))
    for name, tp in layouts.items():
        s = os.path.join(out, "w%d_%s.json" % (world, name))
        runs.append(dict(name="parity_" + name, argv=base + parity +
                         ["--galvatron_config_path", s, "--mixed_precision", "fp32"],
                         fp32=True, logits=0))
    if world > 1:
        dst = _strategy(os.path.join(out, "w%d_to_tp2.json" % world), 2, layers)
        src = os.path.join(out, "w%d_dp%d.json" % (world, world))
        runs.append(dict(name="migration", argv=base + parity + [
            "--galvatron_config_path", src, "--mixed_precision", "fp32",
            "--mesh_probe_interval", "0.000001", "--migrate_on_degrade", "1",
            "--elastic_strategy", dst], fp32=True, logits=0,
            lose=dict(at=2, live=world // 2)))
    return runs


# ------------------------------------------------------------------ worker
def _run_all(plan_path: str) -> None:
    """Every run of the plan on this rank (under torchrun); rank 0 writes
    each summary (and the kept logits) beside the plan."""
    import dataclasses

    import numpy as np
    import torch

    from galvatron_tpu_torch.cli import serve as S
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    import gc

    from galvatron_tpu_torch.ops import flash_attention

    with open(plan_path) as f:
        runs = json.load(f)
    device = "cuda" if "cuda" in runs[0]["argv"] else "cpu"
    dev = distributed.local_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.ensure_initialized(dev)
    if device == "cuda":
        flash_attention.build()  # the forward kernel, before any timed run
    out_dir = os.path.dirname(plan_path)
    orig_cfg, orig_parse = S.model_config_from_args, S.initialize_galvatron

    def fp32(args):
        fam, cfg = orig_cfg(args)
        return fam, dataclasses.replace(cfg, compute_dtype=torch.float32)

    for run in runs:
        kept, state = [], {"lost": False}

        def wrap(fn, kept=kept, run=run):
            def decode(tokens, active, pages):
                nxt, logits = fn(tokens, active, pages)
                if len(kept) < run["logits"]:
                    kept.append((np.array(tokens), np.array(active), logits))
                return nxt, logits
            return decode

        def on_step(step, state=state, run=run):
            if step >= run["lose"]["at"]:
                state["lost"] = True

        def probe(state=state, run=run):
            world = distributed.world_size()
            return list(range(run["lose"]["live"] if state["lost"] else world))

        gc.collect()  # the previous run's model (its closures hold it in cycles)
        if device == "cuda":
            torch.cuda.empty_cache()
        hooks = FaultHooks(wrap_step_fn=wrap if run["logits"] else None,
                           on_step=on_step if run.get("lose") else None,
                           probe_devices_fn=probe if run.get("lose") else None)
        args = orig_parse(argv=run["argv"])
        args.fault_hooks = hooks
        S.initialize_galvatron = lambda argv=None, args=args: args
        if run["fp32"]:
            S.model_config_from_args = fp32
        t0 = time.perf_counter()
        try:
            summary = S.main()
        finally:
            S.model_config_from_args, S.initialize_galvatron = orig_cfg, orig_parse
        if summary.get("departed"):
            return
        summary["run_s"] = time.perf_counter() - t0
        if distributed.rank() == 0:
            with open(os.path.join(out_dir, "%s.json" % run["name"]), "w") as f:
                json.dump(summary, f, default=str)
            if kept:
                np.savez(os.path.join(out_dir, "%s_logits.npz" % run["name"]),
                         **{"tokens%d" % i: t for i, (t, _, _) in enumerate(kept)},
                         **{"active%d" % i: a for i, (_, a, _) in enumerate(kept)},
                         **{"logits%d" % i: lg for i, (_, _, lg) in enumerate(kept)})
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ driver
def _launch(world: int, out: str, runs: List[dict], timeout: int) -> float:
    plan_path = os.path.join(out, "plan_w%d.json" % world)
    with open(plan_path, "w") as f:
        json.dump(runs, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), "-m", "galvatron_tpu_torch.tools.serve_cell", "--runs", plan_path]
    t0 = time.perf_counter()
    with open(os.path.join(out, "launch_w%d.log" % world), "w") as log:
        proc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                              timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        with open(os.path.join(out, "launch_w%d.log" % world)) as f:
            print(f.read()[-6000:], file=sys.stderr)
        raise SystemExit("serve_cell: the world-%d launch exited %d" % (world, proc.returncode))
    return seconds


def _load(out: str, name: str) -> dict:
    with open(os.path.join(out, name + ".json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("serve_cell")
    p.add_argument("--gpus", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default=os.path.join("chiprun_out", "serve4"))
    p.add_argument("--timeout", type=int, default=1500)
    p.add_argument("--runs", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.runs:
        _run_all(a.runs)
        return 0
    import numpy as np

    os.makedirs(a.out, exist_ok=True)
    n = a.gpus
    launch_s = {}
    for world in (1, n):
        launch_s[world] = _launch(world, a.out, plan(world, a.out, a.device, a.tiny), a.timeout)
    problems, rows = [], {}
    ref_perf, ref_parity = _load(a.out, "perf_world1"), _load(a.out, "parity_world1")
    ref_logits = np.load(os.path.join(a.out, "perf_world1_logits.npz"))
    for name in ["world1"] + list(_layouts(n)):
        perf, parity = _load(a.out, "perf_" + name), _load(a.out, "parity_" + name)
        lg = np.load(os.path.join(a.out, "perf_%s_logits.npz" % name))
        # the slots whose prefill sampled world 1's token (a bf16 near-tie
        # may pick another, and then the tick's inputs differ)
        same = lg["active0"] & (lg["tokens0"] == ref_logits["tokens0"])
        err = float(np.abs(lg["logits0"][same] - ref_logits["logits0"][same]).max()) \
            if same.any() else float("nan")
        rows[name] = dict(
            world=perf["world_size"], requests=perf["requests"], shed=perf["shed"],
            ttft_ms=perf["ttft_ms"], tpot_ms=perf["tpot_ms"],
            tokens_per_s=perf["tokens_per_s"], tokens_per_s_per_gpu=perf["tokens_per_s_per_chip"],
            peak_memory_gb=[r["peak_memory_gb"] for r in perf["per_rank"]],
            flash_fwd_launches=[r["flash_fwd_launches"] for r in perf["per_rank"]],
            decode_steps=perf["decode_steps"], wall_s=perf["wall_s"], run_s=perf["run_s"],
            first_tick_logit_err=err, first_tokens_equal=int(same.sum()),
            active_slots=int(lg["active0"].sum()),
            fp32_tokens_equal=parity["outputs"] == ref_parity["outputs"])
        if perf["shed"] or perf["requests"] != ref_perf["requests"]:
            problems.append("%s served %d, shed %d" % (name, perf["requests"], perf["shed"]))
        if 2 * same.sum() < lg["active0"].sum() or not err <= TOL_LOGITS:
            problems.append("%s: first decode tick against world 1: %d of %d slots sampled "
                            "world 1's first token, logits err %.4f on them (tol %.3f)"
                            % (name, same.sum(), lg["active0"].sum(), err, TOL_LOGITS))
        if not rows[name]["fp32_tokens_equal"]:
            problems.append("%s: fp32 greedy tokens differ from world 1's" % name)
    mig = _load(a.out, "migration") if n > 1 else None
    if mig is not None:
        rec = mig["migrations"][0] if mig["migrations"] else {}
        rows["migration"] = dict(from_world=rec.get("from_world"), to_world=rec.get("to_world"),
                                 seconds=rec.get("seconds"), replayed=rec.get("replayed"),
                                 shed=rec.get("shed"), requests=mig["requests"],
                                 tokens_equal=mig["outputs"] == ref_parity["outputs"])
        if not (rec.get("to_world") == n // 2 and rec.get("replayed", 0) > 0
                and rows["migration"]["tokens_equal"]):
            problems.append("migration: %s" % rows["migration"])
    summary = dict(gpus=n, device=a.device, tiny=a.tiny, launch_s=launch_s, rows=rows,
                   problems=problems)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for name, r in rows.items():
        print("%s: %s" % (name, json.dumps(r)))
    if problems:
        print("serve_cell: FAIL: %s" % "; ".join(problems), file=sys.stderr)
        return 1
    print("serve_cell: ok (%s)" % ", ".join("world %d %.1f s" % kv for kv in launch_s.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
