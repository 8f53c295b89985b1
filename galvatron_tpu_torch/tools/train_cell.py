"""The training configurations the port times on the GPU, defined once:
``chip_smoke.py`` trains them through ``cli.train.main`` and
``tools/profile_train.py`` traces the LLaMA one through ``cli.train.build``.

LLaMA-7B width (h 4096, 32 heads, head_dim 128, ffn 11008, vocab 32000) at
depth 8, cut from 32 for memory: fp32 parameters, gradients and two Adam
moments take 16 B per parameter, 108 GB at full depth and 30 GB at depth 8.
Sequence 2048, global batch 8 in 2 micro-batches, bf16 compute, and a
strategy JSON that mixes per-layer remat: layers 0-3 ``full``, 4-5
``dots_saveable``, 6-7 none. lr 1e-4 with 2 warmup steps over ``STEPS``.

GPT-6.7B width (h 4096, 32 heads, head_dim 128, ffn 16384, vocab 50257,
sequence 2048, the tied head) at depth 8, cut from 32 for the same reason
(6.7 B parameters are ~107 GB of state; depth 8 is ~1.83 B, ~29 GB), with
the same batch, remat mix and schedule, through the layout path: layers
0-3 ZeRO-3 (``fsdp=1``), the rest ZeRO-2 (``default_dp_type=zero2``), at
world size 1 over one-rank process groups. `write_gpt_strategy(fsdp=False)`
is the same strategy with every ``fsdp`` 0, and `write_gpt_world4_strategy`
runs the same model on 4 GPUs (``torchrun --nproc_per_node 4``) under a mix
of every layout of the slice.
"""

from __future__ import annotations

import json
import os
from typing import List

LAYERS = 8
STEPS = 6
GLOBAL_BSZ = 8
CHUNKS = 2
CHECKPOINT = [1, 1, 1, 1, 1, 1, 0, 0]
REMAT_POLICY = ["full"] * 4 + ["dots_saveable"] * 2 + ["full"] * 2
SEED = 1234


def write_strategy(out_dir: str) -> str:
    """Write the strategy JSON into `out_dir`; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_cell_strategy.json")
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join(["1"] * LAYERS),
                   "tp_consecutive_flags": ",".join(["1"] * LAYERS),
                   "dp_types_enc": ",".join(["0"] * LAYERS),
                   "checkpoint": ",".join(map(str, CHECKPOINT)),
                   "remat_policy": ",".join(REMAT_POLICY),
                   "global_bsz": GLOBAL_BSZ, "chunks": CHUNKS}, f)
    return path


GPT_FSDP = [1, 1, 1, 1, 0, 0, 0, 0]


def write_gpt_strategy(out_dir: str, fsdp: bool = True) -> str:
    """Write the GPT strategy JSON (every ``fsdp`` 0 with `fsdp` False)
    into `out_dir`; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_cell_gpt_%s.json" % ("zero3" if fsdp else "zero2"))
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join(["1"] * LAYERS),
                   "tp_consecutive_flags": ",".join(["1"] * LAYERS),
                   "dp_types_enc": ",".join(str(x if fsdp else 0) for x in GPT_FSDP),
                   "default_dp_type": "zero2",
                   "checkpoint": ",".join(map(str, CHECKPOINT)),
                   "remat_policy": ",".join(REMAT_POLICY),
                   "global_bsz": GLOBAL_BSZ, "chunks": CHUNKS}, f)
    return path


# GPT across 4 GPUs: every layout of the slice in one strategy (Megatron
# TP+SP on neighbouring and strided ranks, tp 4, ZeRO-3 with and without tp,
# plain dp 4 under ZeRO-2); vocab 50257 does not split over vocab tp
GPT_WORLD4_TP = [2, 2, 4, 4, 2, 1, 1, 2]
GPT_WORLD4_CONSEC = [1, 1, 1, 1, 0, 1, 1, 1]
GPT_WORLD4_FSDP = [0, 1, 0, 1, 0, 1, 0, 0]


def write_gpt_world4_strategy(out_dir: str) -> str:
    """Write the 4-GPU GPT strategy JSON into `out_dir`; returns its path
    (the same model, batch and remat mix as `gpt_argv`'s)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_cell_gpt_world4.json")
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join(map(str, GPT_WORLD4_TP)),
                   "tp_consecutive_flags": ",".join(map(str, GPT_WORLD4_CONSEC)),
                   "dp_types_enc": ",".join(map(str, GPT_WORLD4_FSDP)),
                   "default_dp_type": "zero2",
                   "checkpoint": ",".join(map(str, CHECKPOINT)),
                   "remat_policy": ",".join(REMAT_POLICY),
                   "global_bsz": GLOBAL_BSZ, "chunks": CHUNKS}, f)
    return path


def gpt_argv(strategy_path: str) -> List[str]:
    """The ``cli train`` arguments of the GPT configuration."""
    return [
        "--model_type", "gpt", "--model_size", "gpt-6.7b", "--set_layernum_manually", "1",
        "--num_layers", str(LAYERS), "--mixed_precision", "bf16", "--device", "cuda",
        "--global_train_batch_size", str(GLOBAL_BSZ), "--chunks", str(CHUNKS),
        "--galvatron_config_path", strategy_path, "--train_iters", str(STEPS),
        "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(SEED),
    ]


def argv(strategy_path: str) -> List[str]:
    """The ``cli train`` arguments of the configuration."""
    return [
        "--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
        "--num_layers", str(LAYERS), "--mixed_precision", "bf16", "--device", "cuda",
        "--global_train_batch_size", str(GLOBAL_BSZ), "--chunks", str(CHUNKS),
        "--galvatron_config_path", strategy_path, "--train_iters", str(STEPS),
        "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(SEED),
    ]
