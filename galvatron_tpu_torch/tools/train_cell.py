"""The training configurations the port times on the GPU, defined once:
``chip_smoke.py`` trains them through ``cli.train.main`` and
``tools/profile_train.py`` traces the LLaMA one through ``cli.train.build``.

LLaMA-7B width (h 4096, 32 heads, head_dim 128, ffn 11008, vocab 32000) at
depth 8, cut from 32 for memory: fp32 parameters, gradients and two Adam
moments take 16 B per parameter, 108 GB at full depth and 30 GB at depth 8.
Sequence 2048, global batch 8 in 2 micro-batches, bf16 compute, and a
strategy JSON that mixes per-layer remat: layers 0-3 ``full``, 4-5
``dots_saveable``, 6-7 none. lr 1e-4 with 2 warmup steps over ``STEPS``.

`model_argv` gives the LLaMA model's flags alone, for ``cli profile`` and
``cli search`` (``chip_smoke.py`` phase 12, ``tools/loop_cell.py``).

GPT-6.7B width (h 4096, 32 heads, head_dim 128, ffn 16384, vocab 50257,
sequence 2048, the tied head) at depth 8, cut from 32 for the same reason
(6.7 B parameters are ~107 GB of state; depth 8 is ~1.83 B, ~29 GB), with
the same batch, remat mix and schedule, through the layout path: layers
0-3 ZeRO-3 (``fsdp=1``), the rest ZeRO-2 (``default_dp_type=zero2``), at
world size 1 over one-rank process groups. `write_gpt_strategy(fsdp=False)`
is the same strategy with every ``fsdp`` 0, and `write_gpt_world4_strategy`
runs the same model on 4 GPUs (``torchrun --nproc_per_node 4``) under a mix
of every layout of the slice.

Pipelines on one card (``chip_smoke.py`` phase 11): the LLaMA
configuration with the global batch in ``PP_CHUNKS`` micro-batches, at pp
2 divided 4,4 (`write_pp_strategy`), as a world of 2 that one process
hosts (``parallel.pipeline.LocalTransport``), under GPipe and 1F1B, beside
the same configuration unpipelined (division ``[8]``, pp 1). Its remat mix
has phase 8's counts (4 layers ``full``, 2 ``dots_saveable``, 2 none) laid
out the same on both stages, as GPipe requires (the reference's
``validate_pipeline_config``): per stage ``full, full, dots_saveable,
none``. The GPT
configuration divided 5,3 under 1F1B for ``GPT_PP_STEPS`` steps (its tied
table on both stages). `pp_argv` gives the ``cli train`` flags of either
model (the same flags train pp 4 on four GPUs under ``torchrun``).

The encoder families at their published sizes and full depth
(``chip_smoke.py`` phase 14): BERT-large (h 1024, 16 heads, head_dim 64,
24 layers, ffn 4096, vocab 30522, sequence 512, post-norm, tied MLM head;
~335 M parameters, ~5.4 GB of fp32 state) on the synthetic token stream,
global batch 32 in 2 micro-batches (`write_bert_strategy`: every layer
plain dp, or layers 0-11 ZeRO-3 and the rest ZeRO-2), and ViT-huge (h 1280,
16 heads, head_dim 80, 32 layers, 16 x 16 patches of 224 x 224 images: 197
positions, 1000 classes; ~632 M parameters, ~10.1 GB of state) from a
vision shard of `VISION_IMAGES` seeded uint8 images (`write_vision_shard`,
~77 MB), global batch 64 in 2 micro-batches. Neither shape takes the flash
kernels (head_dim below 128; 197 is no multiple of 128): attention runs
its plain path.

The encoder-decoder and hierarchical families (``chip_smoke.py`` phase 16),
at their published sizes and full depth: T5-large (d_model 1024, 16 heads x
d_kv 64, d_ff 4096, relu, 24 + 24 layers, vocab 32128, tied; ~738 M
parameters, ~11.8 GB of fp32 state), encoder and decoder 512 tokens long,
global batch 32 in 4 micro-batches, from span-corrupted windows of a
seeded corpus (`write_t5_corpus`; the corrupted encoder streams end in a
key-padding tail), every layer plain dp or the encoder ZeRO-3 and the
decoder ZeRO-2 (`write_t5_strategy`), and pp 2 (an encoder stage and a
decoder stage) under 1F1B; Swin-large at 224 with window 7 (embed 192,
depths 2/2/18/2, heads 6/12/24/48, 1000 classes; ~197 M parameters) from
the vision shard, global batch 64 in 2 micro-batches, and pp 2 divided
12/12 (the boundary inside Swin stage 2). T5 always has a relative bias
and Swin computes its window attention inline: neither takes the flash
kernels.
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


def model_argv() -> List[str]:
    """The model flags of the LLaMA configuration (alone, as ``cli profile``
    and ``cli search`` take them)."""
    return ["--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
            "--num_layers", str(LAYERS), "--mixed_precision", "bf16"]


def argv(strategy_path: str) -> List[str]:
    """The ``cli train`` arguments of the configuration."""
    return model_argv() + [
        "--device", "cuda", "--global_train_batch_size", str(GLOBAL_BSZ), "--chunks", str(CHUNKS),
        "--galvatron_config_path", strategy_path, "--train_iters", str(STEPS),
        "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(SEED),
    ]


PP_CHUNKS = 4
PP_DIVISION = [4, 4]
PP_CHECKPOINT = [1, 1, 1, 0] * 2
PP_REMAT_POLICY = ["full", "full", "dots_saveable", "full"] * 2
GPT_PP_DIVISION = [5, 3]
GPT_PP_STEPS = 3


def write_pp_strategy(out_dir: str, division: List[int], pipeline_type: str = "gpipe",
                      gpt: bool = False) -> str:
    """Write the strategy JSON of a pipeline of `division` (``[LAYERS]``:
    no pipeline) with the stage-uniform remat mix and ``PP_CHUNKS``
    micro-batches (GPT: ZeRO-2 by default, as `write_gpt_strategy`) into
    `out_dir`; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_cell_%s_pp_%s_%s.json" % (
        "gpt" if gpt else "llama", "_".join(map(str, division)), pipeline_type))
    with open(path, "w") as f:
        json.dump({"pp_deg": len(division), "pp_division": ",".join(map(str, division)),
                   "pipeline_type": pipeline_type,
                   "tp_sizes_enc": ",".join(["1"] * LAYERS),
                   "tp_consecutive_flags": ",".join(["1"] * LAYERS),
                   "dp_types_enc": ",".join(["0"] * LAYERS),
                   "default_dp_type": "zero2" if gpt else "ddp",
                   "checkpoint": ",".join(map(str, PP_CHECKPOINT)),
                   "remat_policy": ",".join(PP_REMAT_POLICY),
                   "global_bsz": GLOBAL_BSZ, "chunks": PP_CHUNKS}, f)
    return path


def pp_argv(strategy_path: str, gpt: bool = False) -> List[str]:
    """The ``cli train`` arguments of a `write_pp_strategy` configuration
    (``GPT_PP_STEPS`` steps for GPT)."""
    base = gpt_argv(strategy_path) if gpt else argv(strategy_path)
    base[base.index("--chunks") + 1] = str(PP_CHUNKS)
    if gpt:
        base[base.index("--train_iters") + 1] = str(GPT_PP_STEPS)
    return base


BERT_SIZE, BERT_LAYERS, BERT_BSZ = "bert-large", 24, 32
BERT_ZERO3_LAYERS = 12
VIT_SIZE, VIT_BSZ = "vit-huge", 64
VISION_IMAGES = 512
ENCODER_CHUNKS = 2


def write_bert_strategy(out_dir: str, zero3: bool = False) -> str:
    """Write the BERT strategy JSON (every layer plain dp; with `zero3`,
    layers 0-11 ZeRO-3 and the rest ZeRO-2) into `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_cell_bert_%s.json" % ("zero3" if zero3 else "dp"))
    fsdp = [1 if zero3 and i < BERT_ZERO3_LAYERS else 0 for i in range(BERT_LAYERS)]
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join(["1"] * BERT_LAYERS),
                   "tp_consecutive_flags": ",".join(["1"] * BERT_LAYERS),
                   "dp_types_enc": ",".join(map(str, fsdp)),
                   "default_dp_type": "zero2" if zero3 else "ddp",
                   "global_bsz": BERT_BSZ, "chunks": ENCODER_CHUNKS}, f)
    return path


def bert_argv(strategy_path: str) -> List[str]:
    """The ``cli train`` arguments of the BERT configuration."""
    return ["--model_type", "bert", "--model_size", BERT_SIZE, "--mixed_precision", "bf16",
            "--device", "cuda", "--global_train_batch_size", str(BERT_BSZ),
            "--chunks", str(ENCODER_CHUNKS), "--galvatron_config_path", strategy_path,
            "--train_iters", str(STEPS), "--lr", "1e-4", "--lr_warmup_iters", "2",
            "--seed", str(SEED)]


def write_vision_shard(out_dir: str, images: int = VISION_IMAGES) -> str:
    """Write `images` seeded uint8 224 x 224 RGB images and labels over
    1000 classes as a vision shard in `out_dir`; returns its prefix."""
    import numpy as np

    from galvatron_tpu_torch.data.dataset import write_vision_dataset

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "vision_shard")
    rng = np.random.RandomState(SEED)
    write_vision_dataset(prefix, rng.randint(0, 256, (images, 224, 224, 3), dtype=np.uint8),
                         rng.randint(0, 1000, images))
    return prefix


def vit_argv(data_path: str = None) -> List[str]:
    """The ``cli train`` arguments of the ViT configuration: from the vision
    shard `data_path` (all of it the train split), or synthetic pixels."""
    out = ["--model_type", "vit", "--model_size", VIT_SIZE, "--mixed_precision", "bf16",
           "--device", "cuda", "--global_train_batch_size", str(VIT_BSZ),
           "--chunks", str(ENCODER_CHUNKS), "--train_iters", str(STEPS), "--lr", "1e-4",
           "--lr_warmup_iters", "2", "--seed", str(SEED)]
    if data_path:
        out += ["--data_path", data_path, "--split", "1,0,0"]
    return out


T5_SIZE, T5_ENC_LAYERS, T5_LAYERS, T5_BSZ, T5_CHUNKS = "t5-large", 24, 48, 32, 4
T5_CORPUS_DOCS = 600
T5_CORPUS_LEN = (256, 2048)  # document lengths, uniform
SWIN_SIZE, SWIN_LAYERS, SWIN_BSZ, SWIN_CHUNKS = "swin-large", 24, 64, 2


def _write_json(out_dir: str, name: str, cfg: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _layers_json(n: int, fsdp: List[int], bsz: int, chunks: int, pp: int,
                 default_dp_type: str) -> dict:
    out = {"pp_deg": pp, "tp_sizes_enc": ",".join(["1"] * n),
           "tp_consecutive_flags": ",".join(["1"] * n),
           "dp_types_enc": ",".join(map(str, fsdp)), "default_dp_type": default_dp_type,
           "global_bsz": bsz, "chunks": chunks}
    if pp > 1:
        out.update(pp_division=",".join([str(n // pp)] * pp), pipeline_type="pipedream_flush")
    return out


def write_t5_strategy(out_dir: str, zero: bool = False, pp: int = 1, bsz: int = T5_BSZ,
                      chunks: int = T5_CHUNKS) -> str:
    """Write the T5 strategy JSON (every layer plain dp; with `zero`, the
    encoder layers ZeRO-3 and the decoder layers ZeRO-2; with `pp` 2, an
    encoder stage and a decoder stage under 1F1B; global batch `bsz` in
    `chunks` micro-batches) into `out_dir`."""
    fsdp = [1 if zero and i < T5_ENC_LAYERS else 0 for i in range(T5_LAYERS)]
    name = "train_cell_t5_%s_pp%d%s.json" % ("zero" if zero else "dp", pp, "" if (
        bsz, chunks) == (T5_BSZ, T5_CHUNKS) else "_b%d_c%d" % (bsz, chunks))
    return _write_json(out_dir, name, _layers_json(T5_LAYERS, fsdp, bsz, chunks, pp,
                                                   "zero2" if zero else "ddp"))


def write_t5_corpus(out_dir: str) -> str:
    """Write `T5_CORPUS_DOCS` seeded documents of random token ids (below
    the 100 sentinel ids at the top of the vocab) as an indexed corpus in
    `out_dir`; returns its prefix."""
    import numpy as np

    from galvatron_tpu_torch.data.dataset import write_indexed_dataset

    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, "t5_corpus")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(T5_CORPUS_LEN[0], T5_CORPUS_LEN[1] + 1, T5_CORPUS_DOCS)
    write_indexed_dataset(prefix, [rng.randint(0, 32000, n) for n in lens])
    return prefix


def t5_argv(strategy_path: str, data_path: str = None, bsz: int = T5_BSZ,
            chunks: int = T5_CHUNKS) -> List[str]:
    """The ``cli train`` arguments of the T5 configuration: span corruption
    of the corpus `data_path` (all of it the train split), or the synthetic
    seq2seq stream."""
    out = ["--model_type", "t5", "--model_size", T5_SIZE, "--mixed_precision", "bf16",
           "--device", "cuda", "--global_train_batch_size", str(bsz),
           "--chunks", str(chunks), "--galvatron_config_path", strategy_path,
           "--train_iters", str(STEPS), "--lr", "1e-4", "--lr_warmup_iters", "2",
           "--seed", str(SEED)]
    if data_path:
        out += ["--data_path", data_path, "--split", "1,0,0"]
    return out


def write_swin_strategy(out_dir: str, pp: int = 1) -> str:
    """Write the Swin strategy JSON (every block plain dp; with `pp` 2, two
    stages of 12 blocks under 1F1B) into `out_dir`."""
    return _write_json(out_dir, "train_cell_swin_pp%d.json" % pp,
                       _layers_json(SWIN_LAYERS, [0] * SWIN_LAYERS, SWIN_BSZ, SWIN_CHUNKS, pp,
                                    "ddp"))


def swin_argv(strategy_path: str, data_path: str = None) -> List[str]:
    """The ``cli train`` arguments of the Swin configuration: from the
    vision shard `data_path`, or synthetic pixels."""
    out = ["--model_type", "swin", "--model_size", SWIN_SIZE, "--mixed_precision", "bf16",
           "--device", "cuda", "--global_train_batch_size", str(SWIN_BSZ),
           "--chunks", str(SWIN_CHUNKS), "--galvatron_config_path", strategy_path,
           "--train_iters", str(STEPS), "--lr", "1e-4", "--lr_warmup_iters", "2",
           "--seed", str(SEED)]
    if data_path:
        out += ["--data_path", data_path, "--split", "1,0,0"]
    return out
