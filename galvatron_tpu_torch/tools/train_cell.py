"""The one training configuration the port times on the GPU, defined once:
``chip_smoke.py`` trains it through ``cli.train.main`` and
``tools/profile_train.py`` traces it through ``cli.train.build``.

LLaMA-7B width (h 4096, 32 heads, head_dim 128, ffn 11008, vocab 32000) at
depth 8, cut from 32 for memory: fp32 parameters, gradients and two Adam
moments take 16 B per parameter, 108 GB at full depth and 30 GB at depth 8.
Sequence 2048, global batch 8 in 2 micro-batches, bf16 compute, and a
strategy JSON that mixes per-layer remat: layers 0-3 ``full``, 4-5
``dots_saveable``, 6-7 none. lr 1e-4 with 2 warmup steps over ``STEPS``.
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


def argv(strategy_path: str) -> List[str]:
    """The ``cli train`` arguments of the configuration."""
    return [
        "--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
        "--num_layers", str(LAYERS), "--mixed_precision", "bf16", "--device", "cuda",
        "--global_train_batch_size", str(GLOBAL_BSZ), "--chunks", str(CHUNKS),
        "--galvatron_config_path", strategy_path, "--train_iters", str(STEPS),
        "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(SEED),
    ]
