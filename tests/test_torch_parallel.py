"""Port parity, per-layer layouts at world size 2 and 4 on gloo.

The tiny GPT of ``tests/conftest.py`` (h 64, 4 heads, 4 layers, vocab 128)
and a tiny GQA llama (for the kv-head splits) run every strategy of this
slice in one spawned world per world size (``torchrun --standalone``, this
file as the worker): each rank loads the
same full weights, keeps its shards, computes the loss and gradients of one
global batch (rows with uneven valid-token counts), and rank 0 writes the
gathered results. They are held against the JAX package's UNSHARDED
``lm_loss_fn`` / ``jax.grad`` on the CPU (ROADMAP queue 3: the unsharded
reference, not the reference's manual TP paths):

- loss within 2e-5 absolute;
- every gathered gradient within 1e-4 * max|g| + 1e-6;
- three train steps of the heterogeneous strategy (chunks 2, ZeRO-2
  default): losses within 5e-5, gathered params and Adam moments within
  5e-5 * the max of their tree against optax on one device;
- a planted fault (a reduce-scatter in place of the slice in one
  re-layout's backward) must fail the gradient check;
- random init gives every world size the same weights, and re-layouts
  there and back give every rank its shard;
- at world 2, the train CLI under a strategy of Megatron TP (tp 2),
  ZeRO-3 and ZeRO-2 layers saves at step 3 (each rank its shards) and a
  resumed run's losses equal an uninterrupted run's bit for bit; resuming
  that checkpoint under another strategy with a plain ``--load`` is
  refused with GLS206, and with ``--elastic resume --elastic_strategy``
  restores across strategies (every layer plain dp, tp 1 everywhere, 1F1B
  pp 2; the pp 2 checkpoint below under pp 1; and, in the pytest process,
  at world 1): the restored params and both Adam moments equal the saved
  ones bit for bit and the resumed losses stay within 5e-5 of the
  uninterrupted run's;
- pipelines through the point-to-point transport (one stage per rank,
  ``batch_isend_irecv`` on gloo): GPipe and 1F1B, an uneven 2,2,1,1
  division over four stages, ZeRO-3 with remat on every layer, tp 2 with
  ZeRO-3 and vocab TP inside each stage, each against the unsharded
  reference; a tied GPT under 1F1B (3,1 division) trains three steps
  within the trajectory limits with both copies of its table bitwise
  equal; and at world 2 a 1F1B pp 2 run saves through the train CLI
  (the tied table once), resumes bit for bit, reassembles with
  ``load_full_params`` into exactly the trained parameters, and refuses a
  resume under pp 1 with GLS206;
- long context: Ulysses (tp 2 and 4 with sp), ring cp in both
  ``cp_mode``s, Ulysses with cp on one layer, vocab sp and vocab cp, a
  mixed [cp2, cp1, tp2, Ulysses 2] zigzag strategy, a key-padded batch
  under cp 2, cp and Ulysses inside 1F1B, each through ``prepare_batch``
  (the zigzag permutation) against the unsharded reference on the natural
  order, and ring layers (cp 4 padded, cp 2, Ulysses 2 with cp 2) of a
  GPT at the flash kernels' head_dim 128 on 512 tokens, which on GPUs run
  the kernels over NCCL; the reference's heterogeneous trajectory ([tp2, Ulysses 4,
  cp2 + ZeRO-3, remat]) trains three steps within the trajectory limits;
  at world 2 the divergence case: with query/key weights scaled by 8 the
  port's [cp2, cp1] zigzag loss matches the unsharded loss, while the JAX
  package's sharded run of the same strategy, whose attention outside the
  ring masks the permuted sequence by index, is off by at least 100 times
  the port's error; a cp 2 + Ulysses + vocab sp save through the train
  CLI resumes bit for bit; and the train CLI runs the plan ``cli search
  --sp_space tp+sp --enable_cp 1`` writes for a world of 2;
- the families with their own trees, against the JAX package's
  unsharded ``t5_loss_fn`` / ``swin_loss_fn`` at the reference's pp 2
  gate sizes: T5 under tp 2 + ZeRO-3 + vocab tp 2 (Megatron-SP), Swin
  under tp 2 + ZeRO-2, both as pp 2 x tp 2 1F1B pipelines at world 4 (the
  reference's ``_cfg_t5_pp2`` / ``_cfg_swin_pp2``), and as pp 2 pipelines
  at world 2: T5's (h, mem) channel and Swin's merged grid between ranks;
  T5 with its sequence sharded (cp 2 in either cp mode, on the natural
  batch and on one in zigzag order with its true positions, Ulysses 2, cp
  2 with vocab cp 2 and Ulysses 2 with vocab sp at world 2, Ulysses 2 with
  cp 2 at world 4), and the plan ``cli search --sp_space tp+sp
  --enable_cp 1`` writes for T5 at world 2 trained by ``cli train``;
- a converted HF checkpoint (``tools/convert_checkpoint h2g``, params
  only, written at world 1) loaded by ``cli train --load`` at world 2
  under Megatron tp 2 with vocab tp 2 and ZeRO-3, without ``--elastic``:
  its losses within the trajectory limit of the same load at world 1;
- the hardware profiler (``profiler/hardware.py``) on the same world:
  ``profile_all`` writes the JAX package's file names and keys (its
  HardwareProfiler on a 2- and 4-device CPU mesh; the quantization toll
  left out of the overlap file), and every collective it times (all-reduce,
  all-gather, reduce-scatter, all-to-all, the p2p ring) computes the right
  result on every group size and placement.

``python tests/test_torch_parallel.py --report DIR`` prints the tolerances
the parity reached; the same workers run on GPUs (NCCL) with ``--device
cuda`` (see the script's usage).

The worker half of this file imports torch only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S_LEN, V = 8, 32, 128
PAD = (0, 5, 11, 0, 3, 20, 0, 8)  # padded tail per row: uneven valid tokens
GPT = dict(hidden_size=64, num_heads=4, num_layers=4, vocab_size=V, max_seq_len=64)
# a GQA llama: one kv head, so tp 4 replicates the kv projection (the
# reference's GLS007 case tp % num_kv_heads == 0) and tp 2 keeps it so
LLAMA = dict(hidden_size=64, num_heads=4, num_kv_heads=1, num_layers=2, ffn_hidden=96,
             vocab_size=V, max_seq_len=64)
# the same llama at depth 6, for the uneven 2,2,1,1 division of four stages
LLAMA6 = dict(LLAMA, num_layers=6)
# the GPT with its query and key weights scaled by SHARP: attention sharp
# enough that a wrong causal mask moves the loss well past the limits
SHARP = 8.0
# a GPT at the flash kernels' shape (head_dim 128) on a longer sequence,
# for ring layers on the card: every block of a cp 4 zigzag ring (S / 8
# rows) a multiple of the kernels' 64-row tile
GPT_HD128 = dict(hidden_size=256, num_heads=2, num_layers=2, vocab_size=V, max_seq_len=512)
MODEL_SEQ = {"gpt_hd128": 512}  # the others take S_LEN
# the encoder families: a post-norm BERT (token types, embedding norm, tied
# MLM head) on a key-padded batch, and a ViT (12 x 12 images in 4 x 4
# patches and a cls token: 10 positions, a classification head)
BERT = dict(hidden_size=64, num_heads=4, num_layers=4, ffn_hidden=128, vocab_size=96,
            max_seq_len=S_LEN)
VIT = dict(hidden_size=64, num_heads=4, num_layers=4, ffn_hidden=128, image_size=12,
           patch_size=4, num_classes=10)
# the families with their own trees, at the reference's pp 2 gate
# configurations (``__graft_entry__``'s ``_cfg_t5_pp2`` / ``_cfg_swin_pp2``):
# a T5 with an encoder and a decoder of two layers on a key-padded batch,
# and a Swin of two stages (32 x 32 images: 8 x 8 and 4 x 4 patch grids,
# window 4, a shifted block and a merge)
T5 = dict(hidden_size=64, num_heads=4, head_dim=16, ffn_hidden=128, num_enc_layers=2,
          num_dec_layers=2, vocab_size=256, max_seq_len=S_LEN)
SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), image_size=32, patch_size=4,
            window=4, mlp_ratio=2.0, num_classes=10)
ENCODERS = ("bert", "vit", "t5", "swin")  # each with its own batch (`encoder_batch_np`)
MODELS = ("gpt", "llama", "llama6", "gpt_sharp", "gpt_hd128") + ENCODERS
# a key-padded batch (``attn_mask``): the padded tail of each row (PAD)
# is also out of the loss
OPT = dict(lr=1e-3, min_lr=1e-4, warmup_steps=1, total_steps=10)
TRAJ_STEPS = 3
LOSS_TOL, GRAD_REL, GRAD_ABS, TRAJ_TOL = 2e-5, 1e-4, 1e-6, 5e-5

# (name, kwargs of HybridParallelConfig.uniform or a "layers" list, world)
_L = dict  # a LayerStrategy's kwargs
CASES = {
    4: {
        "dp4": dict(),
        "zero2": dict(default_dp_type="zero2"),
        "zero3": dict(sdp=1),
        "tp2_megatron_sp": dict(tp=2),
        "tp2_no_sp": dict(tp=2, sequence_parallel=False),
        "tp2_nonconsec": dict(layers=[_L(tp=2, tp_consec=0)] * 4),
        "tp4": dict(tp=4),
        "vtp2_tied": dict(vocab_tp=2),
        "vtp2_tied_embed_sdp": dict(vocab_tp=2, embed_sdp=1, tp=2),
        "hetero": dict(layers=[_L(tp=2), _L(tp=4, fsdp=1), _L(fsdp=1), _L(checkpoint=1)],
                       chunks=2, default_dp_type="zero2"),
        # collectives inside selective (dots_saveable) and full remat replays
        "tp2_zero3_remat": dict(layers=[_L(tp=2, fsdp=1, checkpoint=1,
                                           remat_policy="dots_saveable"),
                                        _L(tp=2, checkpoint=1)] * 2, chunks=2),
        "llama_gqa_tp4_kv_replicated": dict(model="llama", tp=4, vocab_tp=2),
        "llama_gqa_tp2_zero3": dict(model="llama", layers=[_L(tp=2, fsdp=1), _L(tp=4)]),
        # pipelines (one stage per rank pair or rank): ZeRO-3 + remat on
        # every layer, an uneven division over four stages, and tp 2 with
        # ZeRO-3 and vocab TP inside each stage
        "pp2_zero3_remat_1f1b": dict(pp=2, sdp=1, checkpoint=1, chunks=2,
                                     default_dp_type="zero2", pipeline_type="pipedream_flush"),
        "pp4_uneven_1f1b": dict(model="llama6", pp=4, pp_division=[2, 2, 1, 1], chunks=4,
                                pipeline_type="pipedream_flush"),
        "pp2_tp2_zero3_vtp2_1f1b": dict(pp=2, layers=[_L(tp=2, fsdp=1, checkpoint=1),
                                                      _L(tp=2)] * 2,
                                        vocab_tp=2, chunks=2, default_dp_type="zero2",
                                        pipeline_type="pipedream_flush"),
        # long context: Ulysses over four ranks, Ulysses with cp (under
        # remat: the ring and the all-to-alls replay in the backward), GQA
        # kv heads expanded for Ulysses, cp and Ulysses inside 1F1B
        "ulysses4": dict(tp=4, sp=1),
        "ulysses2_cp2_remat": dict(tp=2, sp=1, cp=2, checkpoint=1, chunks=2),
        "ulysses2_cp2_ring": dict(tp=2, sp=1, cp=2, cp_mode="ring"),
        "llama_gqa_ulysses4_cp_vocab": dict(model="llama", tp=4, sp=1, vocab_cp=2,
                                            vocab_tp=2, vocab_sp=1),
        "cp4_zigzag_padded": dict(cp=4, padded=True),
        # Megatron TP+SP with cp on the layers and on the vocab layers
        "tp2_cp2_vtp2_vcp2": dict(tp=2, cp=2, vocab_tp=2, vocab_cp=2),
        "pp2_cp2_1f1b": dict(pp=2, cp=2, chunks=2, pipeline_type="pipedream_flush"),
        "pp2_tp2_ulysses_1f1b": dict(pp=2, layers=[_L(tp=2, sp=1), _L(tp=2)] * 2, vocab_tp=2,
                                     chunks=2, default_dp_type="zero2",
                                     pipeline_type="pipedream_flush"),
        # ring layers at the kernels' shape: on GPUs the ring runs the flash
        # kernels over NCCL (P2PRing)
        "hd128_cp4_zigzag_padded": dict(model="gpt_hd128", cp=4, padded=True),
        "hd128_cp2_zigzag": dict(model="gpt_hd128", cp=2),
        "hd128_ulysses2_cp2": dict(model="gpt_hd128", tp=2, sp=1, cp=2),
        # the encoder families
        "bert_tp2_vtp2_zero3": dict(model="bert", tp=2, vocab_tp=2, sdp=1),
        "vit_tp2_zero2": dict(model="vit", tp=2, default_dp_type="zero2", chunks=2),
        "bert_pp2_tp2_1f1b": dict(model="bert", pp=2, tp=2, vocab_tp=2, chunks=2,
                                  pipeline_type="pipedream_flush"),
        "vit_pp2_1f1b": dict(model="vit", pp=2, chunks=2, default_dp_type="zero2",
                             pipeline_type="pipedream_flush"),
        # T5 and Swin: tp 2 under ZeRO-3 + vocab tp 2 (Megatron-SP) and
        # under ZeRO-2; the reference's pp 2 x tp 2 gate configurations
        "t5_tp2_zero3_vtp2": dict(model="t5", tp=2, sdp=1, vocab_tp=2),
        "swin_tp2_zero2": dict(model="swin", tp=2, default_dp_type="zero2", chunks=2),
        "t5_pp2_tp2_1f1b": dict(model="t5", pp=2, tp=2, chunks=2,
                                pipeline_type="pipedream_flush"),
        "swin_pp2_tp2_1f1b": dict(model="swin", pp=2, tp=2, chunks=2,
                                  pipeline_type="pipedream_flush"),
        # one layer a stage: T5's token table on stages 0, 2 and 3 and each
        # relative table on two stages sum their gradients over the pp group
        "t5_pp4_1f1b": dict(model="t5", pp=4, chunks=4, pipeline_type="pipedream_flush"),
        # T5 under Ulysses 2 with cp 2 on every layer: the key/value gather
        # over cp after the all-to-all, the relative table's head chunk
        "t5_ulysses2_cp2": dict(model="t5", tp=2, sp=1, cp=2),
    },
    2: {
        "dp2": dict(),
        "tp2": dict(tp=2),
        "pp2_gpipe": dict(pp=2, chunks=4),
        "pp2_zero3_remat_1f1b": dict(pp=2, sdp=1, checkpoint=1, chunks=2,
                                     pipeline_type="pipedream_flush"),
        "ulysses2": dict(tp=2, sp=1),
        "cp2_zigzag": dict(cp=2),
        "cp2_ring": dict(cp=2, cp_mode="ring"),
        "vsp2": dict(vocab_tp=2, vocab_sp=1),
        "vcp2": dict(vocab_cp=2),
        "mixed_cp2_cp1_tp2_ulysses2": dict(layers=[_L(cp=2), _L(), _L(tp=2), _L(tp=2, sp=1)]),
        "cp2_padded": dict(cp=2, padded=True),
        "sharp_cp2_cp1": dict(model="gpt_sharp", layers=[_L(cp=2), _L()] * 2),
        "bert_tp2_vtp2_zero3": dict(model="bert", tp=2, vocab_tp=2, sdp=1),
        "vit_tp2_zero2": dict(model="vit", tp=2, default_dp_type="zero2", chunks=2),
        "bert_pp2_1f1b": dict(model="bert", pp=2, chunks=2, pipeline_type="pipedream_flush"),
        "vit_pp2_1f1b": dict(model="vit", pp=2, chunks=4, pipeline_type="pipedream_flush"),
        # a bidirectional ring over a key-padded batch, and the
        # classification head over a sequence-sharded vocab layout
        "bert_cp2_padded": dict(model="bert", cp=2),
        "vit_vcp2": dict(model="vit", vocab_cp=2),
        # T5's (h, mem) channel and Swin's merged grid between two ranks
        "t5_pp2_1f1b": dict(model="t5", pp=2, chunks=4, pipeline_type="pipedream_flush"),
        "swin_pp2_1f1b": dict(model="swin", pp=2, chunks=2, pipeline_type="pipedream_flush"),
        # T5 with its sequence sharded: cp 2 in either mode (keys and values
        # gathered, the bias rows of the rank's positions), Ulysses over tp
        # 2, cp with vocab cp, Ulysses with vocab sp
        "t5_cp2": dict(model="t5", cp=2),
        "t5_cp2_ring": dict(model="t5", cp=2, cp_mode="ring"),
        "t5_ulysses2": dict(model="t5", tp=2, sp=1),
        "t5_cp2_vocab_cp": dict(model="t5", cp=2, vocab_cp=2),
        "t5_ulysses2_vsp2": dict(model="t5", tp=2, sp=1, vocab_tp=2, vocab_sp=1),
        # a batch in zigzag order with its true positions (``positions``,
        # ``dec_positions``): the bias rows and the causal mask follow them
        "t5_cp2_zigzag_batch": dict(model="t5", cp=2, zigzag_batch=True),
    },
}
# the divergence case and its strategy, run by the JAX package too
DIVERGENCE_CASE = "sharp_cp2_cp1"
# the reference's heterogeneous trajectory strategy (world 8 there), fed
# through prepare_batch: the zigzag permutation for its cp 2 layer
LC_TRAJ_CASE = dict(layers=[_L(tp=2), _L(tp=4, sp=1), _L(cp=2, fsdp=1), _L(checkpoint=1)],
                    chunks=2, default_dp_type="zero2")
# a tied GPT trained through a pipeline at world 2: its table lives on both
# stages and must stay bitwise equal
PP_TRAJ_CASE = dict(pp=2, pp_division=[3, 1], chunks=2, default_dp_type="zero2",
                    pipeline_type="pipedream_flush")
TRAJ_CASE = "hetero"
FAULT_CASE = "hetero"
INIT_SEED = 5
# re-layouts of a (8, 32, 4) tensor at world 4 (sub-axes m0, m1), there and back
RELAYOUTS = [
    ((("m0", "m1"), (), ()), (("m0",), ("m1",), ())),   # dp4 -> tp2 with Megatron-SP
    ((("m0",), ("m1",), ()), ((), ("m0", "m1"), ())),   # tp2+SP -> tp4+SP
    ((("m1",), ("m0",), ()), (("m0",), ("m1",), ())),   # tp_consec 0 -> 1
    (((), (), ()), (("m0", "m1"), (), ())),              # replicated -> dp4
    ((("m0", "m1"), (), ()), (("m0", "m1"), (), ())),    # no change
]


def batch_np(seq=S_LEN):
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, V, (B, seq))
    loss_mask = np.ones((B, seq), np.float32)
    for row, pad in enumerate(PAD):
        if pad:
            loss_mask[row, -pad:] = 0.0
    return tokens, np.roll(tokens, -1, axis=1), loss_mask


def case_batch_np(padded=False, seq=S_LEN):
    """(tokens, labels, loss_mask, attn_mask): with `padded` every row's PAD
    tail is key padding too (attn_mask), as it is out of the loss."""
    tokens, labels, loss_mask = batch_np(seq)
    return tokens, labels, loss_mask, loss_mask.copy() if padded else None


def encoder_batch_np(family):
    """The global batch of a family with its own batch: for BERT, tokens
    with token types and key-padding tails (PAD, also out of the loss) and
    random labels; for ViT and Swin, standard-normal pixels and class
    labels; for T5, encoder tokens with PAD key-padding tails and decoder
    tokens with PAD tails out of the loss."""
    rng = np.random.RandomState(13)
    if family in ("vit", "swin"):
        c = VIT if family == "vit" else SWIN
        size = c["image_size"]
        return {"pixels": rng.randn(B, size, size, 3).astype(np.float32),
                "labels": rng.randint(0, c["num_classes"], (B,))}
    tokens, _, mask = batch_np()
    if family == "t5":
        v = T5["vocab_size"]
        return {"tokens": tokens % v, "attn_mask": mask.copy(),
                "dec_tokens": rng.randint(0, v, (B, S_LEN)),
                "labels": rng.randint(0, v, (B, S_LEN)), "loss_mask": mask[:, ::-1].copy()}
    types = (np.arange(S_LEN)[None, :] >= rng.randint(4, S_LEN - 4, (B, 1))).astype(np.int64)
    return {"tokens": tokens % BERT["vocab_size"],
            "positions": np.broadcast_to(np.arange(S_LEN), (B, S_LEN)).copy(),
            "labels": rng.randint(0, BERT["vocab_size"], (B, S_LEN)), "loss_mask": mask,
            "attn_mask": mask.copy(), "token_type_ids": types}


def _ref_key(kw):
    """The unsharded reference a case is held against: its model, on the
    padded batch where it asks for one."""
    return kw.get("model", "gpt") + ("_padded" if kw.get("padded") else "")


# ======================================================================= worker
def _hp(kw, world, num_layers):
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy

    kw = dict(kw)
    kw.pop("model", None)
    kw.pop("padded", None)
    kw.pop("zigzag_batch", None)
    layers = kw.pop("layers", None)
    kw.setdefault("global_bsz", B)
    if layers is None:
        return HybridParallelConfig.uniform(world, num_layers, **kw)
    return HybridParallelConfig(world_size=world, pp=kw.pop("pp", 1),
                                layers=[LayerStrategy(**s) for s in layers], **kw)


def _worker(world: int, inputs: str, out: str, fault: bool, device_name: str = "cpu",
            serve_ckpt: str = None) -> None:
    """One rank: every case of `world` on `device_name` (``cpu``: gloo;
    ``cuda``: NCCL, one GPU per rank, fp32 without TF32). `serve_ckpt` is
    the world-2 worker's train checkpoint (its ``ckpt_w2``), which the
    world-4 worker serves when given."""
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    from galvatron_tpu_torch.models import base as TM
    from galvatron_tpu_torch.ops.flash_attention import HEAD_DIMS
    from galvatron_tpu_torch.parallel import comm
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime import sdc
    from galvatron_tpu_torch.runtime.dataloader import prepare_batch
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import AdamState, OptimizerArgs, \
        get_optimizer_and_scheduler

    from galvatron_tpu_torch.models.bert import bert_config
    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.models.swin import swin_config
    from galvatron_tpu_torch.models.t5 import t5_config
    from galvatron_tpu_torch.models.vit import vit_config

    dev = distributed.local_device(device_name)
    distributed.ensure_initialized(dev, timeout_s=120)
    rank = distributed.rank()
    data = np.load(inputs)
    full = {m: {k[len(m) + 1:]: torch.from_numpy(data[k]).to(dev) for k in data.files
                if k.startswith(m + "/")} for m in MODELS}
    cfgs = {"gpt": TM.TransformerConfig(**GPT, compute_dtype=torch.float32),
            "llama": llama_config("llama-0.3b", compute_dtype=torch.float32, **LLAMA),
            "llama6": llama_config("llama-0.3b", compute_dtype=torch.float32, **LLAMA6)}
    cfgs["gpt_sharp"] = cfgs["gpt"]
    cfgs["gpt_hd128"] = TM.TransformerConfig(**GPT_HD128, compute_dtype=torch.float32)
    cfgs["bert"] = bert_config("bert-base", compute_dtype=torch.float32, **BERT)
    cfgs["vit"] = vit_config("vit-base", compute_dtype=torch.float32, **VIT)
    cfgs["t5"] = t5_config("t5-test", compute_dtype=torch.float32, **T5)
    cfgs["swin"] = swin_config("swin-test", compute_dtype=torch.float32, **SWIN)
    batches = {(padded, seq): case_batch_np(padded, seq) for padded in (False, True)
               for seq in {S_LEN, *MODEL_SEQ.values()}}
    batch = prepare_batch(None, *batches[False, S_LEN][:3], device=dev)
    results = {}

    def on_card(kw):
        """False for a case the card cannot run: a ring layer of a model
        whose head_dim is no kernel shape (the tiny models' 16), as the ring
        has no plain path on the card (T5's cp layers take no ring)."""
        cfg = cfgs[kw.get("model", "gpt")]
        return dev.type != "cuda" or kw.get("model") == "t5" or not any(
            s.cp > 1 for s in _hp(kw, world, cfg.num_layers).layers) or \
            cfg.hidden_size // cfg.num_heads in HEAD_DIMS

    def grads_of(name):
        kw = CASES[world][name]
        m = kw.get("model", "gpt")
        cfg = cfgs[m]
        hp = _hp(kw, world, cfg.num_layers)
        model = construct_hybrid_parallel_model(cfg, hp, dev)
        params = model.shard_params(full[m])
        # the sentinel's layout-invariant fold of the logical params
        results["%s/fold" % name] = np.int64(sdc.state_fold(model, params))
        if m in ENCODERS:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in encoder_batch_np(m).items()}
            if kw.get("zigzag_batch"):
                from galvatron_tpu_torch.ops.ring_attention import zigzag_permutation

                order = torch.from_numpy(zigzag_permutation(S_LEN, hp.max_cp)).to(dev)
                batch = {k: v[:, order] for k, v in batch.items()}
                batch["positions"] = batch["dec_positions"] = order.expand(B, S_LEN)
        else:  # the strategy's batch: zigzag-permuted under zigzag cp
            batch = prepare_batch(hp, *batches[bool(kw.get("padded")), MODEL_SEQ.get(m, S_LEN)],
                                  device=dev)
        loss, grads = model.loss_and_grads(params, batch)
        return model, params, float(loss), model.gather_grads(grads)

    for name in CASES[world]:
        if not on_card(CASES[world][name]):
            continue
        _, _, loss, grads = grads_of(name)
        results["%s/loss" % name] = np.float64(loss)
        for n, g in grads.items():
            results["%s/grad/%s" % (name, n)] = g.cpu().numpy()
    serve_full = {k[len(SERVE_CKPT) + 1:]: torch.from_numpy(data[k]).to(dev)
                  for k in data.files if k.startswith(SERVE_CKPT + "/")}
    serve_ckpt_dir = os.path.join(os.path.dirname(inputs), SERVE_CKPT)
    for name, kw in SERVE_CASES.get(world, {}).items():
        results.update(_serve_engine_case(name, kw, world, dev, device_name,
                                          os.path.dirname(out), serve_full, serve_ckpt_dir))
    if world == 4 and serve_ckpt:
        results.update(_serve_load_case(os.path.join(os.path.dirname(out), "serve_load_w4"),
                                        serve_ckpt, 4, device_name))

    if world == 4:
        from galvatron_tpu_torch.config.strategy import HybridParallelConfig
        from galvatron_tpu_torch.parallel import spec as TS
        from galvatron_tpu_torch.parallel.mesh import build_mesh

        mesh = build_mesh(HybridParallelConfig.uniform(4, 1), device=dev)
        x = torch.arange(8 * 32 * 4, dtype=torch.float32, device=dev).reshape(8, 32, 4)
        for i, (a, b) in enumerate(RELAYOUTS):
            there = TS.relayout(TS.shard_tensor(x, a, mesh), mesh, a, b)
            back = TS.relayout(there, mesh, b, a)
            err = torch.stack([(there - TS.shard_tensor(x, b, mesh)).abs().max(),
                               (back - TS.shard_tensor(x, a, mesh)).abs().max()])
            torch.distributed.all_reduce(err, op=torch.distributed.ReduceOp.MAX)
            results["relayout/%d" % i] = err.cpu().numpy()

    # random init: every world size draws the same full weights as a
    # one-rank init from the same generator
    init_model = construct_hybrid_parallel_model(
        cfgs["gpt"], _hp(CASES[world][TRAJ_CASE if TRAJ_CASE in CASES[world] else "dp2"], world,
                         cfgs["gpt"].num_layers), dev)
    for n, p in init_model.gather_params(init_model.init_params(INIT_SEED)).items():
        results["init/%s" % n] = p.cpu().numpy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(INIT_SEED)
    for n, p in TM.init_model_params(cfgs["gpt"], gen, dev).named_parameters():
        results["init_ref/%s" % n] = p.detach().cpu().numpy()

    def trajectory(hp, key, sdc_check="off"):
        cfg = cfgs["gpt"]
        model = construct_hybrid_parallel_model(cfg, hp, dev)
        params = model.shard_params(full["gpt"])
        tx, _ = get_optimizer_and_scheduler(OptimizerArgs(**OPT))
        state = model.init_opt_state(tx, params)
        step = model.make_train_step(tx, sdc_check=sdc_check)
        losses = []
        hp_batch = prepare_batch(hp, *batches[False, S_LEN][:3], device=dev)
        for _ in range(TRAJ_STEPS):
            params, state, metrics = step(params, state, hp_batch)
            losses.append(float(metrics["loss"]))
        results["%s/loss" % key] = np.asarray(losses)
        if sdc_check != "off":
            results["%s/fold" % key] = np.int64(sdc.fold_value(metrics["sdc_fold"])[0])
        for n, p in model.gather_params(params).items():
            results["%s/param/%s" % (key, n)] = p.cpu().numpy()
        moments = model.gather_opt_state(state)
        assert isinstance(moments, AdamState) and moments.count == TRAJ_STEPS
        for n in moments.mu:
            results["%s/mu/%s" % (key, n)] = moments.mu[n].cpu().numpy()
            results["%s/nu/%s" % (key, n)] = moments.nu[n].cpu().numpy()
        return model, params

    if TRAJ_CASE in CASES[world]:
        trajectory(_hp(CASES[world][TRAJ_CASE], world, cfgs["gpt"].num_layers), "traj")
        # the sentinel's digest is a side output: the same trajectory bitwise
        trajectory(_hp(CASES[world][TRAJ_CASE], world, cfgs["gpt"].num_layers), "traj_digest",
                   "digest")
        if on_card(LC_TRAJ_CASE):
            trajectory(_hp(LC_TRAJ_CASE, world, cfgs["gpt"].num_layers), "lctraj")
    if world == 2:
        trajectory(_hp(PP_TRAJ_CASE, world, cfgs["gpt"].num_layers), "pptraj_digest", "digest")
        model, params = trajectory(_hp(PP_TRAJ_CASE, world, cfgs["gpt"].num_layers), "pptraj")
        # every stage's copy of the tied table (the first and the last)
        copies = [None] * world
        mine = dict(params[model.mesh.stage].named_parameters()).get("embed.wte")
        torch.distributed.all_gather_object(copies, None if mine is None else mine.detach().cpu())
        results["pptraj/wte_copies"] = np.stack([c.numpy() for c in copies if c is not None])

    if fault and FAULT_CASE in CASES[world]:
        # the first re-layout's all-gather reduce-scatters its gradient
        # instead of slicing it (the consumer is replicated, so this scales
        # the gradient by the group size)
        honest, calls = comm.gather_split_bwd, []

        def faulty(x, dim, group):
            calls.append(dim)
            return comm.gather_rs_bwd(x, dim, group) if len(calls) == 1 else honest(x, dim, group)

        comm.gather_split_bwd = faulty
        try:
            _, _, loss, grads = grads_of(FAULT_CASE)
        finally:
            comm.gather_split_bwd = honest
        results["fault/loss"] = np.float64(loss)
        for n, g in grads.items():
            results["fault/grad/%s" % n] = g.cpu().numpy()

    if world == 2:
        results.update(_checkpoint_cases(os.path.join(os.path.dirname(out), "ckpt_w2"),
                                         device_name))
        if dev.type != "cuda":  # ring layers at head_dim 16 (see on_card)
            results.update(_checkpoint_cases(os.path.join(os.path.dirname(out), "ckpt_lc_w2"),
                                             device_name, CKPT_LC_STRATEGY, "ckpt_lc"))
            results.update(_loop_case(os.path.join(os.path.dirname(inputs), LOOP_PLAN),
                                      device_name))
        results.update(_pipeline_checkpoint_cases(
            os.path.join(os.path.dirname(out), "ckpt_pp_w2"), device_name))
        results.update(_h2g_case(os.path.dirname(inputs), device_name))
        results.update(_serve_load_case(os.path.join(os.path.dirname(out), "serve_load_w2"),
                                        os.path.join(os.path.dirname(out), "ckpt_w2"), 2,
                                        device_name))
        results.update(_serve_agree_case(dev, world, serve_full))
        results.update(_serve_gls015_case(os.path.join(os.path.dirname(out), "serve_gls015"),
                                          device_name, serve_ckpt_dir))

    results.update(_hardware_cases(os.path.join(os.path.dirname(out), "hw_w%d" % world), dev))

    if world == 2:
        results.update(_sigusr1_case(os.path.join(os.path.dirname(out), "usr1_w2"),
                                     device_name))
        # last at world 2: the simulated loss moves the run off rank 1
        lost = _degraded_case(os.path.join(os.path.dirname(out), "lost_w2"), device_name)
        if lost is None:
            return
        results.update(lost)
    if world == 4:
        results.update(_probe_case(dev))
        # last: the persistent fault moves the run off rank 3, whose process
        # leaves the world here; the survivors go on as a world of 3
        vote = _vote_cases(os.path.join(os.path.dirname(out), "vote_w4"), device_name)
        if vote is None:
            return
        results.update(vote)
        # on the survivors: a serve under dp 3 (8 slots, replicated) loses a
        # rank and goes on at world 2 under tp 2; then dp 2 (the slots
        # split) loses one and goes on alone (the params' layout kept)
        for key, source, target in (("serve_mig3", _serve_json(), _serve_json("2,2,2,2")),
                                    ("serve_mig2", _serve_json(), _serve_json())):
            mig = _serve_migration_case(os.path.join(os.path.dirname(out), key), device_name,
                                        key, source, target, 8, serve_ckpt_dir)
            if mig is None:
                return
            results.update(mig)

    if torch.distributed.get_rank() == 0:
        np.savez(out, **results)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


HW_ARGS = dict(start_mb=0.25, end_mb=0.5, warmup=1, iters=2, overlap_time_multiply=1)
HW_KINDS = ("allreduce", "allgather", "reducescatter", "all2all", "sendrecv")


def _json_keys(tree):
    """A JSON table's key structure (nested dict keys; leaves dropped)."""
    if isinstance(tree, dict):
        return {str(k): _json_keys(v) for k, v in tree.items()}
    return None


def _hardware_cases(config_dir: str, dev) -> dict:
    """`profile_all` into `config_dir` (its files' key structure), then one
    call of every collective on every group size and placement held
    against the values its ranks' messages give (max error over ranks)."""
    import json

    import torch

    from galvatron_tpu_torch.profiler.hardware import HardwareProfileArgs, HardwareProfiler

    prof = HardwareProfiler(HardwareProfileArgs(config_dir=config_dir, **HW_ARGS), dev)
    prof.profile_all(write=True)
    out = {}
    if prof.rank == 0:
        tables = {}
        for name in sorted(os.listdir(config_dir)):
            with open(os.path.join(config_dir, name)) as f:
                tables[name] = _json_keys(json.load(f))
        out["hw/tables"] = np.array(json.dumps(tables, sort_keys=True))
    mb, errs = 0.25, {}
    g = 2
    while g <= prof.ndev:
        for consec in (True, False):
            groups = prof.group_ranks(g, consec)
            ranks = next(r for r in groups if prof.rank in r)
            me = ranks.index(prof.rank)
            n = prof.message(mb).numel()
            # each group rank's message, as `message` makes it on that rank
            msgs = [torch.arange(n, dtype=torch.float32, device=dev) * 1e-9 + float(r)
                    for r in ranks]
            total = sum(msgs)
            want = {
                "allreduce": total,
                "allgather": torch.cat(msgs),
                "reducescatter": total[me * (n // g):(me + 1) * (n // g)],
                "all2all": torch.cat([m[me * (n // g):(me + 1) * (n // g)] for m in msgs]),
                "sendrecv": msgs[(me - 1) % g],
            }
            for kind in HW_KINDS:
                got = prof.collective(kind, g, consec, prof.message(mb))()
                err = torch.tensor([float((got - want[kind]).abs().max())], device=dev)
                torch.distributed.all_reduce(err, op=torch.distributed.ReduceOp.MAX)
                errs["%s/%d/%d" % (kind, g, int(consec))] = float(err.item())
        g *= 2
    out["hw/errors"] = np.array(json.dumps(errs, sort_keys=True))
    return out


# the layout of the world-2 save/resume cases: tp 2, ZeRO-3, ZeRO-2, tp 2
CKPT_STRATEGY = {"pp_deg": 1, "tp_sizes_enc": "2,1,1,2", "tp_consecutive_flags": "1,1,1,1",
                 "dp_types_enc": "0,1,0,0", "default_dp_type": "zero2", "global_bsz": 4,
                 "chunks": 2}
# the long-context save/resume: Ulysses 2, cp 2 (one layer ZeRO-3),
# Megatron tp 2, vocab sp, zigzag
CKPT_LC_STRATEGY = dict(CKPT_STRATEGY, tp_sizes_enc="2,1,1,2", use_sp="1,0,0,0",
                        cp_sizes_enc="1,2,2,1", vtp=2, vsp=1, cp_mode="zigzag")
CKPT_ARGV = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
             "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "128",
             "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
             "--lr", "1e-3", "--lr_decay_style", "constant", "--log_interval", "100",
             "--world_size", "2"]


def _checkpoint_cases(ckpt_dir: str, device_name: str, strategy=None,
                      prefix: str = "ckpt") -> dict:
    """The train CLI at world 2 (inside the worker's process group) under
    `strategy` (default CKPT_STRATEGY): an uninterrupted 6-step run, a
    3-step run that saves (rank 1's first write of its file fails: both
    ranks retry together), its resume to 6, and a resume under another
    strategy (every layer plain dp)."""
    import json

    import torch

    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.runtime import checkpoint as ck

    rank = torch.distributed.get_rank()
    strategy = strategy or CKPT_STRATEGY
    strategies = {}
    for name, dp_types in (("mixed", strategy["dp_types_enc"]), ("other", "0,0,0,0")):
        path = "%s_%s.json" % (ckpt_dir, name)
        if rank == 0:
            with open(path, "w") as f:
                json.dump(dict(strategy, dp_types_enc=dp_types), f)
        strategies[name] = path
    torch.distributed.barrier()

    def train(steps, strategy="mixed", extra=()):
        argv = CKPT_ARGV + ["--device", device_name, "--train_iters", str(steps),
                            "--galvatron_config_path", strategies[strategy]] + list(extra)
        return T.train(T.initialize_galvatron(argv=argv, mode="train"))

    full = train(6)
    honest, faults = ck._write_rank_file, []

    def flaky(host, path):
        if rank == 1 and not faults:
            faults.append(path)
            raise OSError("injected write failure on rank 1")
        return honest(host, path)

    ck._write_rank_file = flaky
    try:
        first = train(3, extra=["--save", ckpt_dir, "--ckpt_retry_backoff", "0.01"])
    finally:
        ck._write_rank_file = honest
    retries = [None] * 2
    torch.distributed.all_gather_object(retries, (len(faults), first["resilience"]["retries"]))
    resumed = train(6, extra=["--load", ckpt_dir])
    try:
        train(6, strategy="other", extra=["--load", ckpt_dir])
        refused = "none"
    except DiagnosticError as e:
        refused = ",".join(d.code for d in e.diagnostics)
    out = {}
    if prefix == "ckpt":
        # elastic resumes of the mixed checkpoint (every layer plain dp, tp
        # 1 everywhere, 1F1B pp 2) against its plain resume, all in fp32
        with fp32_compute():
            ref = train(6, extra=["--load", ckpt_dir])["losses"]
            for name, target in (("other", dict(strategy, dp_types_enc="0,0,0,0")),
                                 ("tp1", dict(strategy, tp_sizes_enc="1,1,1,1")),
                                 ("pp2", CKPT_PP_STRATEGY)):
                out.update(_elastic_cases(ckpt_dir, name, target, ref, device_name))
    out.update({"full": np.asarray(full["losses"]), "first": np.asarray(first["losses"]),
           "resumed": np.asarray(resumed["losses"]),
           "start": np.int64(resumed["checkpoint_restore"]["iteration"]),
           "ranks": np.int64(len(os.listdir(os.path.join(ckpt_dir, "3"))) - 1),
           "refused": np.asarray(refused),
           "write_faults": np.asarray([f for f, _ in retries]),
           "save_retries": np.asarray([r for _, r in retries]),
           "dir": np.asarray(ckpt_dir)})
    return {"%s/%s" % (prefix, k): v for k, v in out.items()}


class fp32_compute:
    """``cli train`` and ``cli serve`` with fp32 compute (the CLI computes
    in bf16; the layout trajectory limits hold fp32 runs): the model
    config's compute dtype replaced while the context is open."""

    def __enter__(self):
        import dataclasses

        import torch

        from galvatron_tpu_torch.cli import serve as S
        from galvatron_tpu_torch.cli import train as T

        self.orig = orig = T.model_config_from_args

        def fp32(args):
            fam, cfg = orig(args)
            return fam, dataclasses.replace(cfg, compute_dtype=torch.float32)
        T.model_config_from_args = S.model_config_from_args = fp32

    def __exit__(self, *exc):
        from galvatron_tpu_torch.cli import serve as S
        from galvatron_tpu_torch.cli import train as T

        T.model_config_from_args = S.model_config_from_args = self.orig


def _elastic_cases(ckpt_dir: str, name: str, strategy: dict, ref_losses,
                   device_name: str) -> dict:
    """``cli train --elastic resume --elastic_strategy`` of the step-3
    checkpoint under `strategy` at world 2: a zero-step run that saves the
    restored state under `strategy` (rank 0 compares the full params and
    moments of both checkpoints bitwise), then the run to step 6, whose
    losses `ref_losses` holds under the saved strategy (a plain resume)."""
    import torch

    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.cli.arguments import model_config_from_args
    from galvatron_tpu_torch.runtime import checkpoint as ck

    path = "%s_elastic_%s.json" % (ckpt_dir, name)
    if torch.distributed.get_rank() == 0:
        with open(path, "w") as f:
            json.dump(strategy, f)
    torch.distributed.barrier()

    def train(steps, extra=()):
        argv = CKPT_ARGV + ["--device", device_name, "--train_iters", str(steps), "--elastic",
                            "resume", "--elastic_strategy", path, "--load", ckpt_dir]
        return T.train(T.initialize_galvatron(argv=argv + list(extra), mode="train"))

    again = "%s_elastic_%s" % (ckpt_dir, name)
    restored = train(3, ["--save", again])
    resumed = train(6)
    same = False
    if torch.distributed.get_rank() == 0:
        _, cfg = model_config_from_args(T.initialize_galvatron(argv=CKPT_ARGV, mode="train"))
        (pa, sa, _), (pb, sb, _) = (ck.load_full_state(d, 3, cfg) for d in (ckpt_dir, again))
        same = sorted(pa) == sorted(pb) and sa.count == sb.count == 3 and all(
            torch.equal(pa[n], pb[n]) and torch.equal(sa.mu[n], sb.mu[n])
            and torch.equal(sa.nu[n], sb.nu[n]) for n in pa)
    key = "elastic_%s/" % name
    return {key + "losses": np.asarray(resumed["losses"]),
            key + "ref": np.asarray(ref_losses),
            key + "cross": np.bool_(restored["checkpoint_restore"]["cross_strategy"]
                                    and resumed["checkpoint_restore"]["cross_strategy"]),
            key + "restored_steps": np.int64(len(restored["losses"])),
            key + "bitwise": np.bool_(same)}


# the plan `cli search --sp_space tp+sp --enable_cp 1` writes for a world of
# 2 (`_loop_plan`), beside the weights; the world-2 worker trains it
LOOP_PLAN = "loop_plan.json"
LOOP_MODEL_ARGV = ["--model_type", "llama", "--set_model_config_manually", "1",
                   "--hidden_size", "128", "--num_attention_heads", "2", "--ffn_hidden_size",
                   "64", "--num_layers", "4", "--vocab_size", "64", "--seq_length", "64"]
LOOP_STEPS = 3


# T5 through the same loop: its two layer types' tables, the search at
# world 2 with --sp_space tp+sp --enable_cp 1, the train CLI on the plan
T5_LOOP_PLAN = "t5_loop_plan.json"
T5_LOOP_MODEL_ARGV = ["--model_type", "t5", "--model_size", "t5-test",
                      "--set_seqlen_manually", "1", "--seq_length", "32"]


def _loop_case(plan: str, device_name: str) -> dict:
    """The train CLI at world 2 on the searched plan, in fp32."""
    from galvatron_tpu_torch.cli import train as T

    with open(plan) as f:
        bsz = json.load(f)["global_bsz"]
    summary = T.train(T.initialize_galvatron(argv=LOOP_MODEL_ARGV + [
        "--device", device_name, "--galvatron_config_path", plan, "--world_size", "2",
        "--global_train_batch_size", str(bsz), "--train_iters", str(LOOP_STEPS),
        "--lr", "1e-3", "--mixed_precision", "fp32", "--log_interval", "100"], mode="train"))
    out = {"loop/losses": np.asarray(summary["losses"])}
    t5_plan = os.path.join(os.path.dirname(plan), T5_LOOP_PLAN)
    with open(t5_plan) as f:
        bsz = json.load(f)["global_bsz"]
    summary = T.train(T.initialize_galvatron(argv=T5_LOOP_MODEL_ARGV + [
        "--device", device_name, "--galvatron_config_path", t5_plan, "--world_size", "2",
        "--global_train_batch_size", str(bsz), "--train_iters", str(LOOP_STEPS),
        "--lr", "1e-3", "--log_interval", "100"], mode="train"))
    out["t5_loop/losses"] = np.asarray(summary["losses"])
    out["t5_loop/flash"] = np.asarray(json.dumps(summary["flash_routes"]))
    return out



# a converted HF LLaMA (``tools/convert_checkpoint h2g`` of seeded port
# params exported to an HF directory: no transformers needed), loaded by
# the train CLI at world 2 into Megatron tp 2 (layers 0-1, vocab tp 2) and
# ZeRO-3 (layers 2-3), against the same load at world 1 in the pytest process
H2G_DIR = "h2g_llama"
H2G_HF = {"model_type": "llama", "hidden_size": 64, "num_attention_heads": 4,
          "num_hidden_layers": 4, "intermediate_size": 96, "vocab_size": 128,
          "max_position_embeddings": 32}
H2G_ARGV = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size", "64",
            "--num_attention_heads", "4", "--ffn_hidden_size", "96", "--num_layers", "4",
            "--vocab_size", "128", "--seq_length", "32", "--global_train_batch_size", "4",
            "--chunks", "2", "--train_iters", "2", "--lr", "1e-3", "--lr_decay_style",
            "constant", "--log_interval", "100", "--mixed_precision", "fp32"]
H2G_STRATEGY = {"pp_deg": 1, "tp_sizes_enc": "2,2,1,1", "tp_consecutive_flags": "1,1,1,1",
                "dp_types_enc": "0,0,1,1", "vtp": 2, "global_bsz": 4, "chunks": 2}


# the sentinel's vote and the migrations off a rank: pure dp over 4 ranks, a
# global batch that 4 and 3 ranks split
VOTE_STRATEGY = {"pp_deg": 1, "tp_sizes_enc": "1,1,1,1", "tp_consecutive_flags": "1,1,1,1",
                 "dp_types_enc": "0,0,0,0", "default_dp_type": "ddp", "global_bsz": 12,
                 "chunks": 1}
VOTE_ARGV = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
             "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "128",
             "--seq_length", "32", "--global_train_batch_size", "12", "--chunks", "1",
             "--lr", "1e-3", "--lr_decay_style", "constant", "--log_interval", "100",
             "--train_iters", "6", "--sdc_check", "vote"]


def _shared_json(path: str, content: dict) -> str:
    import torch

    if torch.distributed.get_rank() == 0:
        with open(path, "w") as f:
            json.dump(content, f)
    torch.distributed.barrier()
    return path


def _vote_cases(tmp_dir: str, device_name: str):
    """The vote sentinel at world 4 through ``cli train`` (pure dp, fp32
    compute): a clean run saving at step 3; a bit flipped in rank 2's
    replica before step call 2 (localized, repaired from a healthy replica,
    the step re-executed); a flip stuck on rank 3 from call 3 on (two
    strikes quarantine it; the run migrates to the 3 survivors in memory
    and rank 3's process leaves); then, on the survivors, the clean run's
    step-3 checkpoint resumed under the same world-3 strategy
    (``--elastic resume``). Returns None on the rank that left."""
    from galvatron_tpu_torch.cli import train as T
    from tests import torch_fault_injection as FI

    strategy = _shared_json(tmp_dir + ".json", VOTE_STRATEGY)
    clean_dir = tmp_dir + "_clean"

    def train(extra=(), hooks=None):
        argv = VOTE_ARGV + ["--device", device_name, "--galvatron_config_path", strategy]
        args = T.initialize_galvatron(argv=argv + list(extra), mode="train")
        args.fault_hooks = hooks
        return T.train(args)

    out = {}
    with fp32_compute():
        clean = train(["--save", clean_dir, "--save_interval", "3"])
        once = train(hooks=FI.bitflip_hooks(2, rank=2))
        stuck = train(["--migrate_on_degrade", "1", "--elastic_strategy", strategy],
                      hooks=FI.bitflip_hooks(3, rank=3, persistent=True))
        if stuck.get("departed"):
            return None
        resumed = train(["--load", clean_dir, "--load_iteration", "3", "--elastic", "resume",
                         "--elastic_strategy", strategy])
    for key, run in (("clean", clean), ("once", once), ("stuck", stuck), ("resumed", resumed)):
        out["vote/%s/losses" % key] = np.asarray(run["losses"])
        out["vote/%s/counters" % key] = np.asarray(
            [run["resilience"][k] for k in ("sdc_mismatches", "sdc_reexecutions",
                                            "sdc_quarantines", "sdc_checks")])
        out["vote/%s/world" % key] = np.int64(run["world_size"])
    out["vote/stuck/migration"] = np.asarray(json.dumps(stuck["migrations"]))
    out["vote/resumed/start"] = np.int64(resumed["checkpoint_restore"]["iteration"])
    out["vote/sdc_mode"] = np.asarray(resumed["sdc_mode"])
    return out


def _degraded_case(tmp_dir: str, device_name: str):
    """The mesh probe (every step boundary) sees rank 1 gone from step 3 on
    (``device_loss_hooks``: the rank is alive, the probe's live list lacks
    it): ``--migrate_on_degrade`` moves the run to rank 0 alone in memory
    (rank 1's process leaves); against it, a clean world-2 run saving at
    step 3 and, on rank 0, its ``--elastic resume`` at world 1 under the
    same strategy. Returns None on the rank that left."""
    from galvatron_tpu_torch.cli import train as T
    from tests import torch_fault_injection as FI

    strategy = _shared_json(tmp_dir + ".json", dict(VOTE_STRATEGY, global_bsz=4))
    clean_dir = tmp_dir + "_clean"

    def train(extra=(), hooks=None):
        argv = VOTE_ARGV[:VOTE_ARGV.index("--sdc_check")] + [
            "--device", device_name, "--galvatron_config_path", strategy,
            "--global_train_batch_size", "4"]
        args = T.initialize_galvatron(argv=argv + list(extra), mode="train")
        args.fault_hooks = hooks
        return T.train(args)

    with fp32_compute():
        clean = train(["--save", clean_dir, "--save_interval", "3"])
        lost = train(["--mesh_probe_interval", "0.000001", "--migrate_on_degrade", "1",
                      "--elastic_strategy", strategy], FI.device_loss_hooks(3, live=1))
        if lost.get("departed"):
            return None
        resumed = train(["--load", clean_dir, "--load_iteration", "3", "--elastic", "resume",
                         "--elastic_strategy", strategy])
    return {"lost/clean": np.asarray(clean["losses"]), "lost/losses": np.asarray(lost["losses"]),
            "lost/resumed": np.asarray(resumed["losses"]),
            "lost/world": np.int64(lost["world_size"]),
            "lost/migrations": np.asarray(json.dumps(lost["migrations"]))}


def _probe_case(dev) -> dict:
    """The mesh probe over the world (every rank): 5 probes of the timed
    all-reduce, each healthy, and their seconds (on GPUs: the probe over
    NVLink)."""
    from galvatron_tpu_torch.runtime.health import MeshHealthMonitor

    mon = MeshHealthMonitor(interval_s=0.0, timeout_s=60.0, device=dev)
    verdicts = [mon.probe() for _ in range(5)]
    return {"probe/healthy": np.bool_(all(v["status"] == "healthy" and v["collective_ok"]
                                          for v in verdicts)),
            "probe/seconds": np.asarray([v["collective_elapsed_s"] for v in verdicts])}


def _sigusr1_case(tmp_dir: str, device_name: str) -> dict:
    """SIGUSR1 at step 3 of a world-2 run under CKPT_STRATEGY (tp 2 and
    ZeRO-3 layers, ZeRO-2 default) that saves at 3: the driver migrates in
    memory to every layer plain dp with tp 1 (``--elastic_strategy``);
    against it, the step-3 checkpoint resumed under the same target
    (``--elastic resume``)."""
    from galvatron_tpu_torch.cli import train as T
    from tests import torch_fault_injection as FI

    source = _shared_json(tmp_dir + "_from.json", CKPT_STRATEGY)
    target = _shared_json(tmp_dir + "_to.json", dict(CKPT_STRATEGY, tp_sizes_enc="1,1,1,1",
                                                      dp_types_enc="0,0,0,0"))

    def train(extra, hooks=None):
        argv = CKPT_ARGV + ["--device", device_name, "--train_iters", "6",
                            "--galvatron_config_path", source, "--elastic_strategy", target]
        args = T.initialize_galvatron(argv=argv + list(extra), mode="train")
        args.fault_hooks = hooks
        return T.train(args)

    migrated = train(["--save", tmp_dir, "--save_interval", "3", "--sdc_check", "digest"],
                     FI.sigusr1_hooks(3))
    resumed = train(["--load", tmp_dir, "--load_iteration", "3", "--elastic", "resume"])
    return {"usr1/migrated": np.asarray(migrated["losses"]),
            "usr1/resumed": np.asarray(resumed["losses"]),
            "usr1/migrations": np.asarray(json.dumps(migrated["migrations"])),
            "usr1/strategy": np.asarray(json.dumps(migrated["strategy"])),
            "usr1/resumed_strategy": np.asarray(json.dumps(resumed["strategy"]))}


def _h2g_checkpoint(tmp_dir: str) -> str:
    """The h2g step of a seeded LLaMA beside the weights; returns its dir."""
    import torch

    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.hf_utils import read_hf_config, write_safetensors
    from galvatron_tpu_torch.models.llama import export_hf_llama, llama_config_from_hf
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.tools import convert_checkpoint as C

    hf_dir = os.path.join(tmp_dir, "h2g_hf")
    os.makedirs(hf_dir, exist_ok=True)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(H2G_HF, f)
    cfg = llama_config_from_hf(read_hf_config(hf_dir, "llama"))
    model = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, 4), "cpu")
    params = model.init_params(9)[0]
    write_safetensors(os.path.join(hf_dir, "model.safetensors"),
                      {k: torch.from_numpy(v) for k, v in export_hf_llama(params, cfg).items()})
    out = os.path.join(tmp_dir, H2G_DIR)
    C.main(["h2g", "--model_type", "llama", "--hf_path", hf_dir, "--output_dir", out])
    with open(os.path.join(tmp_dir, "h2g_strategy.json"), "w") as f:
        json.dump(H2G_STRATEGY, f)
    return out


def _h2g_case(tmp_dir: str, device_name: str) -> dict:
    """The train CLI at world 2 from the converted step under H2G_STRATEGY
    (fp32 compute): a fresh optimizer from iteration 0."""
    from galvatron_tpu_torch.cli import train as T

    with fp32_compute():
        summary = T.train(T.initialize_galvatron(argv=H2G_ARGV + [
            "--device", device_name, "--world_size", "2", "--load",
            os.path.join(tmp_dir, H2G_DIR), "--galvatron_config_path",
            os.path.join(tmp_dir, "h2g_strategy.json")], mode="train"))
    return {"h2g/losses": np.asarray(summary["losses"]),
            "h2g/params_only": np.bool_(summary["checkpoint_restore"]["params_only"])}


# the world-2 pipeline save/resume: a tied GPT, 1F1B over stages of 3 and 1
CKPT_PP_STRATEGY = {"pp_deg": 2, "pp_division": "3,1", "pipeline_type": "pipedream_flush",
                    "tp_sizes_enc": "1,1,1,1", "tp_consecutive_flags": "1,1,1,1",
                    "dp_types_enc": "0,0,0,0", "default_dp_type": "zero2", "global_bsz": 4,
                    "chunks": 2}


def _pipeline_checkpoint_cases(ckpt_dir: str, device_name: str) -> dict:
    """The train CLI at world 2 under CKPT_PP_STRATEGY (one stage per rank):
    an uninterrupted 6-step run, a 3-step run that saves (its final
    parameters captured through the step seam), its resume to 6,
    ``load_full_params`` of the checkpoint, and a resume under pp 1."""
    import json

    import torch

    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.cli.arguments import hp_config_from_args, model_config_from_args
    from galvatron_tpu_torch.runtime import checkpoint as ck
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    rank = torch.distributed.get_rank()
    strategies = {}
    for name, strategy in (("pp2", CKPT_PP_STRATEGY), ("pp1", CKPT_STRATEGY)):
        path = "%s_%s.json" % (ckpt_dir, name)
        if rank == 0:
            with open(path, "w") as f:
                json.dump(strategy, f)
        strategies[name] = path
    torch.distributed.barrier()
    captured = []

    def capture(step):
        def wrapped(params, opt_state, batch, *rest):
            out = step(params, opt_state, batch, *rest)
            captured[:] = [out[0]]
            return out
        return wrapped

    def args_of(steps, strategy="pp2", extra=()):
        return T.initialize_galvatron(
            argv=CKPT_ARGV + ["--device", device_name, "--train_iters", str(steps),
                              "--galvatron_config_path", strategies[strategy]] + list(extra),
            mode="train")

    full = T.train(args_of(6))
    args = args_of(3, extra=["--save", ckpt_dir])
    args.fault_hooks = FaultHooks(wrap_step_fn=capture)
    first = T.train(args)
    resumed = T.train(args_of(6, extra=["--load", ckpt_dir]))
    try:
        T.train(args_of(6, strategy="pp1", extra=["--load", ckpt_dir]))
        refused = "none"
    except DiagnosticError as e:
        refused = ",".join(d.code for d in e.diagnostics)
    with fp32_compute():
        ref = T.train(args_of(6, extra=["--load", ckpt_dir]))["losses"]
        elastic = _elastic_cases(ckpt_dir, "pp1", CKPT_STRATEGY, ref, device_name)
    # the trained parameters, gathered from both stages, against the
    # checkpoint reassembled in one process
    _, cfg = model_config_from_args(args)
    model = construct_hybrid_parallel_model(cfg, hp_config_from_args(args, cfg.num_layers, 2),
                                            distributed.local_device(device_name))
    trained = model.gather_params(captured[0])
    loaded, _ = ck.load_full_params(ckpt_dir, 3, cfg)
    same = sorted(trained) == sorted(loaded) and all(
        torch.equal(trained[n].cpu(), loaded[n]) for n in loaded)
    files = [sorted(ck._read_rank(ckpt_dir, 3, r)["params"]) for r in range(2)]
    return {**{"ckpt_pp/" + k: v for k, v in elastic.items()},
            "ckpt_pp/full": np.asarray(full["losses"]),
            "ckpt_pp/first": np.asarray(first["losses"]),
            "ckpt_pp/resumed": np.asarray(resumed["losses"]),
            "ckpt_pp/start": np.int64(resumed["checkpoint_restore"]["iteration"]),
            "ckpt_pp/refused": np.asarray(refused),
            "ckpt_pp/full_params_equal": np.bool_(same),
            "ckpt_pp/wte_files": np.asarray(["embed.wte" in f for f in files])}


# ==================================================================== reference

# ------------------------------------------------------------------ serving
# a GQA llama with two kv heads: tp 2 splits them, tp 4 replicates the kv
# projection (each rank keeps the kv head its query heads share); its
# weights are drawn on the CPU from SERVE_SEED (a CUDA generator draws
# others) and reach the workers in the weights file and, for ``cli serve``,
# as a params-only checkpoint (SERVE_CKPT)
SERVE_SEED = 4
SERVE_CKPT = "serve_llama"  # its params-only step 0 beside the weights (``cli serve --load``)
SERVE_LLAMA = dict(hidden_size=64, num_heads=4, num_kv_heads=2, num_layers=4, ffn_hidden=96,
                   vocab_size=V, max_seq_len=32)
SERVE_PROMPTS = [[5, 9, 2], [17, 3, 44, 8, 1], [60, 7], [11, 3, 29, 6, 50, 2, 9]]
SERVE_NEW = 4  # tokens per prompt: the prefill's and three decode steps'
SERVE_PAGE, SERVE_PAGES = 8, 4
SERVE_ATOL = 2e-5  # the reference's decode-vs-recompute slack (fp32)
# per world: the layouts the engine runs (uniform kwargs or per-layer
# lists; "slots" the cache's, default one per prompt)
SERVE_CASES = {
    4: {"serve_tp4_kv_replicated": dict(tp=4),
        "serve_dp4": dict(),
        "serve_tp2_zero3": dict(tp=2, sdp=1, vocab_tp=4),
        "serve_mixed": dict(layers=[_L(tp=4), _L(fsdp=1), _L(tp=2, tp_consec=0),
                                    _L(tp=2, fsdp=1)], vocab_tp=2)},
    2: {"serve_tp2": dict(tp=2, vocab_tp=2),
        "serve_dp2": dict(),
        "serve_zero3": dict(sdp=1, embed_sdp=1),
        "serve_mixed": dict(layers=[_L(tp=2), _L(fsdp=1), _L(tp=2, fsdp=1), _L()]),
        "serve_offgrid_slots": dict(sdp=1, slots=3)},
}
SERVE_CASE_IDS = [(w, n) for w in sorted(SERVE_CASES, reverse=True) for n in SERVE_CASES[w]]
# ``cli serve`` of SERVE_LLAMA in fp32 (`fp32_compute`; with ``--load`` of
# SERVE_CKPT): 8 requests, up to 12 prompt and 4 new tokens in a
# 32-token context
SERVE_ARGV = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size", "64",
              "--num_attention_heads", "4", "--num_kv_heads", "2", "--ffn_hidden_size", "96",
              "--num_layers", "4", "--vocab_size", str(V), "--seq_length", "32",
              "--serve_page_size", str(SERVE_PAGE), "--num_requests", "8",
              "--prompt_len_min", "3", "--prompt_len_max", "12", "--max_new_tokens", "4",
              "--seed", str(SERVE_SEED), "--mixed_precision", "fp32",
              "--global_train_batch_size", "12"]
SERVE_LOAD = dict(n=8, seed=SERVE_SEED, prompt_len_range=(3, 12), max_new_tokens=4)
# the serve layouts of the world-2 train checkpoint (CKPT_STRATEGY's GPT)
CKPT_MODEL_ARGV = CKPT_ARGV[:CKPT_ARGV.index("--global_train_batch_size")]
SERVE_CKPT_STRATEGY = {
    2: {"pp_deg": 1, "tp_sizes_enc": "2,1,2,1", "tp_consecutive_flags": "1,1,0,1",
        "dp_types_enc": "0,1,1,0", "vtp": 2, "global_bsz": 4},
    4: {"pp_deg": 1, "tp_sizes_enc": "2,4,1,2", "tp_consecutive_flags": "1,1,1,0",
        "dp_types_enc": "1,0,1,0", "vtp": 4, "global_bsz": 4},
}


def _serve_json(tp="1,1,1,1", dp_types="0,0,0,0"):
    return {"pp_deg": 1, "tp_sizes_enc": tp, "tp_consecutive_flags": "1,1,1,1",
            "dp_types_enc": dp_types, "global_bsz": 12}


def _case_json(kw: dict) -> dict:
    """A SERVE_CASES layout as the strategy JSON ``cli serve`` reads."""
    layers = kw.get("layers") or [dict(tp=kw.get("tp", 1), fsdp=kw.get("sdp", 0))] * 4
    enc = lambda key, default: ",".join(str(l.get(key, default)) for l in layers)  # noqa: E731
    return {"pp_deg": 1, "tp_sizes_enc": enc("tp", 1), "tp_consecutive_flags": enc("tp_consec", 1),
            "dp_types_enc": enc("fsdp", 0), "vtp": kw.get("vocab_tp", 1),
            "embed_sdp": kw.get("embed_sdp", 0), "global_bsz": 12}


def _serve_model(dev, kw, world, full):
    """(cfg, hp, model, params) of a SERVE_CASES layout: SERVE_LLAMA in fp32,
    this rank's shards of the `full` weights."""
    import torch

    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    cfg = llama_config("llama-0.3b", compute_dtype=torch.float32, **SERVE_LLAMA)
    kw = {k: v for k, v in kw.items() if k != "slots"}
    hp = _hp(kw, world, cfg.num_layers)
    model = construct_hybrid_parallel_model(cfg, hp, dev, mode="serve")
    return cfg, hp, model, model.shard_params(full)[0]


def _serve_engine_case(name: str, kw: dict, world: int, dev, device_name: str,
                       tmp_dir: str, full, ckpt: str) -> dict:
    """The engine under a serve layout: each prompt of SERVE_PROMPTS
    prefilled into its slot, then SERVE_NEW - 1 decode steps of every slot;
    the logits of each step (prefill rows, then decode rows) and the greedy
    tokens; then ``cli serve``'s completed tokens under the layout."""
    from galvatron_tpu_torch.serve.engine import ServeEngine
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, bucket_pages

    cfg, hp, model, params = _serve_model(dev, kw, world, full)
    slots = kw.get("slots", len(SERVE_PROMPTS))
    prompts = SERVE_PROMPTS[:slots]
    kv = KVCacheConfig(max_slots=slots, page_size=SERVE_PAGE, max_pages=SERVE_PAGES)
    eng = ServeEngine(cfg, params, kv, device=dev, hp=hp, mesh=model.mesh)
    cur, lens = np.zeros(slots, np.int32), np.zeros(slots, np.int64)
    rows, toks = [], []
    for slot, prompt in enumerate(prompts):
        tok, row = eng.prefill(prompt, slot)
        cur[slot], lens[slot] = tok, len(prompt)
        rows.append(row)
    logits, tokens = [np.stack(rows)], [cur.copy()]
    for _ in range(SERVE_NEW - 1):
        pages = bucket_pages(int(lens.max()), SERVE_PAGE, SERVE_PAGES)
        nxt, lg = eng.decode_step(cur, np.ones(slots, bool), pages)
        logits.append(lg)
        tokens.append(nxt)
        cur, lens = nxt.astype(np.int32), lens + 1
    del eng, params, model
    # ``cli serve`` under the same layout (as its strategy JSON), its load
    # of SERVE_LOAD
    strategy = _shared_json(os.path.join(tmp_dir, "%s_w%d.json" % (name, world)), _case_json(kw))
    summary = _serve_cli(SERVE_ARGV + ["--device", device_name, "--load", ckpt,
                                       "--galvatron_config_path", strategy,
                                       "--serve_max_concurrency", str(slots)])
    return {"%s/logits" % name: np.stack(logits), "%s/tokens" % name: np.stack(tokens),
            "%s/cli" % name: _serve_outputs(summary)}


def _serve_cli(argv, hooks=None, telemetry=None):
    """``cli serve`` in this process's group, fp32 compute; returns the
    summary, or the exit code `main` ends with."""
    from galvatron_tpu_torch.cli import serve as S

    args = S.initialize_galvatron(argv=list(argv) + (["--telemetry", telemetry]
                                                     if telemetry else []))
    args.fault_hooks = hooks
    orig = S.initialize_galvatron
    S.initialize_galvatron = lambda argv=None: args
    try:
        with fp32_compute():
            return S.main()
    except SystemExit as e:
        return int(e.code)
    finally:
        S.initialize_galvatron = orig


def _serve_outputs(summary) -> np.ndarray:
    """A summary's completed requests' tokens, as rows [rid, tokens...]
    (-1 padded)."""
    out = summary["outputs"]
    width = 1 + max(len(t) for t in out.values())
    rows = np.full((len(out), width), -1, np.int64)
    for i, rid in enumerate(sorted(out)):
        rows[i, 0], rows[i, 1:1 + len(out[rid])] = rid, out[rid]
    return rows


def _outputs(rows):
    """`_serve_outputs`' rows back as rid -> tokens."""
    return {int(r[0]): [int(t) for t in r[1:] if t >= 0] for r in rows}


def _serve_load_case(tmp_dir: str, ckpt_dir: str, world: int, device_name: str) -> dict:
    """``cli serve --load`` of the world-2 train checkpoint (step 3) under
    this world's SERVE_CKPT_STRATEGY: each rank restores only its slices."""
    strategy = _shared_json(tmp_dir + ".json", SERVE_CKPT_STRATEGY[world])
    summary = _serve_cli(CKPT_MODEL_ARGV + [
        "--device", device_name, "--world_size", str(world), "--load", ckpt_dir,
        "--load_iteration", "3", "--galvatron_config_path", strategy,
        "--serve_page_size", str(SERVE_PAGE), "--serve_max_concurrency", "4",
        "--num_requests", "6", "--prompt_len_min", "3", "--prompt_len_max", "12",
        "--max_new_tokens", str(SERVE_LOAD["max_new_tokens"]), "--seed", str(SERVE_SEED),
        "--mixed_precision", "fp32", "--global_train_batch_size", "4"])
    return {"serve_load/outputs": _serve_outputs(summary),
            "serve_load/cross": np.bool_(summary["checkpoint_restore"].get("cross_strategy")),
            "serve_load/world": np.int64(summary["world_size"])}


def _serve_agree_case(dev, world: int, full) -> dict:
    """The batcher on every rank over SERVE_CASES' tp 2 engine, each rank
    reading its own skewed clock (offset and rate), with arrivals,
    deadlines, the predicted-TTFT shed and the pending bound: through the
    agreement every rank admits, sheds and decodes alike (any difference
    would hang the collectives). Every rank's outcome is gathered."""
    import torch

    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.serve import engine as E
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig

    cfg, hp, model, params = _serve_model(dev, SERVE_CASES[2]["serve_tp2"], world, full)
    kv = KVCacheConfig(max_slots=2, page_size=SERVE_PAGE, max_pages=SERVE_PAGES)
    rank = distributed.rank()
    clock = {"t": 50.0 * rank}

    def skewed():
        clock["t"] += 0.002 * (1 + 3 * rank)
        return clock["t"]

    # ``cli serve``'s load (the reference's prompts), arriving 50 ms apart
    reqs = E.synthetic_requests(SERVE_LOAD["n"], vocab_size=V, seed=SERVE_LOAD["seed"],
                                prompt_len_range=SERVE_LOAD["prompt_len_range"],
                                max_new_tokens=SERVE_LOAD["max_new_tokens"])
    for r in reqs:
        r.arrival_s = 0.05 * r.rid
    for r in reqs[::4]:
        r.deadline_s = r.arrival_s + 0.03
    b = E.ContinuousBatcher(E.ServeEngine(cfg, params, kv, device=dev, hp=hp, mesh=model.mesh),
                            kv, clock=skewed, p99_ttft_ms=300.0, max_pending=4,
                            min_shed_samples=2,
                            agree=lambda v: distributed.agree_max(v, dev))
    done = b.run(reqs)
    mine = (sorted((r.rid, tuple(r.output)) for r in done),
            sorted((r.rid, r.finish_reason) for r in b.shed), b.decode_steps)
    every = [None] * world
    torch.distributed.all_gather_object(every, mine)
    return {"serve_agree/same": np.bool_(all(x == every[0] for x in every)),
            "serve_agree/outputs": _serve_outputs({"outputs": dict(every[0][0])}),
            "serve_agree/shed": np.asarray(json.dumps(every[0][1]))}


def _serve_gls015_case(tmp_dir: str, device_name: str, ckpt: str) -> dict:
    """At world 2 the probe loses rank 1 at decode step 2; the re-search for
    the one survivor under an impossible budget refuses (GLS015): the
    batcher drains and ``cli serve`` exits 2 on both ranks."""
    from galvatron_tpu_torch.runtime import distributed
    from tests import torch_fault_injection as FI

    strategy = _shared_json(tmp_dir + ".json", _serve_json("2,2,2,2"))
    tele = tmp_dir + ".jsonl"
    code = _serve_cli(SERVE_ARGV + [
        "--device", device_name, "--load", ckpt, "--galvatron_config_path", strategy,
        "--serve_max_concurrency", "4", "--mesh_probe_interval", "0.000001",
        "--migrate_on_degrade", "1", "--elastic_memory_gb", "1e-9"],
        FI.device_loss_hooks(2, live=1), telemetry=tele)
    drains = []
    if distributed.rank() == 0:
        with open(tele) as f:
            drains = [e for e in map(json.loads, f) if e.get("type") == "serve_drain"]
    return {"serve_gls015/exit": np.int64(code),
            "serve_gls015/drains": np.asarray(json.dumps(drains))}


def _serve_migration_case(tmp_dir: str, device_name: str, key: str, source: dict,
                          target: dict, slots: int, ckpt: str):
    """``cli serve`` under `source` whose mesh probe loses the last rank at
    decode step 2: ``--migrate_on_degrade`` moves the params onto `target`
    for the survivors (``--elastic_strategy``), rebuilds the cache and
    journal-replays the in-flight requests; the last rank leaves. Returns
    None on the rank that left."""
    from galvatron_tpu_torch.runtime import distributed
    from tests import torch_fault_injection as FI

    world = distributed.world_size()
    src = _shared_json(tmp_dir + "_from.json", source)
    dst = _shared_json(tmp_dir + "_to.json", target)
    summary = _serve_cli(SERVE_ARGV + [
        "--device", device_name, "--load", ckpt, "--galvatron_config_path", src,
        "--serve_max_concurrency", str(slots), "--mesh_probe_interval", "0.000001",
        "--migrate_on_degrade", "1", "--elastic_strategy", dst],
        FI.device_loss_hooks(2, live=world - 1))
    if summary.get("departed"):
        return None
    mig = summary["migrations"]
    return {"%s/outputs" % key: _serve_outputs(summary),
            "%s/shed" % key: np.int64(summary["shed"]),
            "%s/migration" % key: np.asarray(json.dumps(mig)),
            "%s/worlds" % key: np.asarray([world, summary["world_size"]])}


def _jax_tree(flat):
    """A JAX parameter tree from state-dict names (``layers.<i>.`` a list)."""
    tree = {}
    for name, v in flat.items():
        node, parts = tree, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(v, np.float32)
    if "layers" in tree:
        tree["layers"] = [tree["layers"][k] for k in sorted(tree["layers"], key=int)]
    return tree


def _serve_reference(tmp_dir):
    """The JAX package's engines on SERVE_LLAMA (SERVE_SEED's weights, drawn
    on the CPU): SERVE_PROMPTS through the unsharded engine and through the
    engine under tp 2 on its 8-device CPU mesh, the full-forward greedy
    recompute of each step, and the continuous batcher over ``cli serve``'s
    load; and the weights for the workers' file (also written as SERVE_CKPT
    beside it)."""
    import jax
    import jax.numpy as jnp
    import torch

    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.models import base as JM
    from galvatron_tpu.models.llama import llama_config as jax_llama
    from galvatron_tpu.runtime import model_api as JAPI
    from galvatron_tpu.serve import engine as JE
    from galvatron_tpu.serve.kv_cache import KVCacheConfig, bucket_pages
    from galvatron_tpu_torch.models import base as TM
    from galvatron_tpu_torch.models.llama import llama_config

    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.runtime.checkpoint import save_checkpoint
    from galvatron_tpu_torch.runtime.provenance import build_provenance

    gen = torch.Generator()
    gen.manual_seed(SERVE_SEED)
    tcfg = llama_config("llama-0.3b", compute_dtype=torch.float32, **SERVE_LLAMA)
    params = TM.init_model_params(tcfg, gen, "cpu")
    hp = HybridParallelConfig.uniform(1, tcfg.num_layers, global_bsz=1)
    save_checkpoint(os.path.join(tmp_dir, SERVE_CKPT), 0, params, hp=hp,
                    train_meta={"iteration": 0}, provenance=build_provenance(hp, tcfg))
    flat = {n: p.detach().numpy() for n, p in params.named_parameters()}
    tree = _jax_tree(flat)
    cfg = jax_llama("llama-0.3b", compute_dtype=jnp.float32, **SERVE_LLAMA)
    kv = KVCacheConfig(max_slots=len(SERVE_PROMPTS), page_size=SERVE_PAGE,
                       max_pages=SERVE_PAGES)

    def engine_steps(eng):
        cur, lens = np.zeros(kv.max_slots, np.int32), np.zeros(kv.max_slots, np.int64)
        rows = []
        for slot, prompt in enumerate(SERVE_PROMPTS):
            tok, row = eng.prefill(prompt, slot)
            cur[slot], lens[slot] = tok, len(prompt)
            rows.append(np.asarray(row))
        logits, tokens = [np.stack(rows)], [cur.copy()]
        for _ in range(SERVE_NEW - 1):
            nxt, lg = eng.decode_step(cur, np.ones(kv.max_slots, bool),
                                      bucket_pages(int(lens.max()), SERVE_PAGE, SERVE_PAGES))
            logits.append(np.asarray(lg))
            tokens.append(np.asarray(nxt))
            cur, lens = np.asarray(nxt, np.int32), lens + 1
        return np.stack(logits), np.stack(tokens)

    # the training forward over each sequence so far, padded to one length
    # (one compile): causal, so the last real row sees no padding
    width = max(len(p) for p in SERVE_PROMPTS) + SERVE_NEW
    fwd = jax.jit(lambda p, x: JM.lm_logits(p, JM.run_layers(p, JM.embed_tokens(
        p["embed"], x, jnp.arange(width)[None], cfg), jnp.arange(width)[None], cfg), cfg))
    recompute = np.zeros((SERVE_NEW, len(SERVE_PROMPTS), V), np.float32)
    for i, prompt in enumerate(SERVE_PROMPTS):
        toks = list(prompt)
        for step in range(SERVE_NEW):
            row = np.asarray(fwd(tree, jnp.asarray([toks + [0] * (width - len(toks))],
                                                   jnp.int32)))[0, len(toks) - 1]
            recompute[step, i] = row
            toks.append(int(np.argmax(row)))
    out = {"recompute": recompute}
    out["logits"], out["tokens"] = engine_steps(JE.ServeEngine(cfg, tree, kv))
    hp = JHP.uniform(8, cfg.num_layers, tp=2, global_bsz=8)
    model = JAPI.construct_hybrid_parallel_model(cfg, hp, jax.devices()[:8])
    out["logits8"], out["tokens8"] = engine_steps(JE.ServeEngine(
        cfg, jax.device_put(tree, model.shardings()), kv, hp=hp, mesh=model.mesh))
    # the engine's cache geometry: its compiled steps are reused
    out["load"] = _jax_batcher_outputs(cfg, tree, slots=kv.max_slots)
    return out, {"%s/%s" % (SERVE_CKPT, n): v for n, v in flat.items()}


def _jax_batcher_outputs(cfg, tree, slots, n=SERVE_LOAD["n"], max_seq=32):
    """rid -> tokens of the JAX package's batcher over ``cli serve``'s
    synthetic load (the CLI's cache geometry and prompt-length cap)."""
    from galvatron_tpu.serve import engine as JE
    from galvatron_tpu.serve.kv_cache import KVCacheConfig

    kv = KVCacheConfig(max_slots=slots, page_size=SERVE_PAGE, max_pages=-(-max_seq // SERVE_PAGE))
    lo, hi = SERVE_LOAD["prompt_len_range"]
    new = SERVE_LOAD["max_new_tokens"]
    reqs = JE.synthetic_requests(n, vocab_size=cfg.vocab_size, seed=SERVE_LOAD["seed"],
                                 prompt_len_range=(lo, max(lo, min(hi, kv.max_ctx - new))),
                                 max_new_tokens=new)
    done = JE.ContinuousBatcher(JE.ServeEngine(cfg, tree, kv), kv).run(reqs)
    return {r.rid: [int(t) for t in r.output] for r in done}


def _reference(tmp_dir):
    """The JAX package's unsharded loss, gradients and trajectory, and the
    weights file the workers load."""
    import jax
    import jax.numpy as jnp
    import optax

    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.config.strategy import LayerStrategy as JLS
    from galvatron_tpu.models import base as JM
    from galvatron_tpu.runtime import dataloader as JD
    from galvatron_tpu.runtime import model_api as JAPI
    from galvatron_tpu.runtime import optimizer as JO
    from galvatron_tpu_torch.tools.from_jax import _flatten

    from galvatron_tpu.models import swin as JSW
    from galvatron_tpu.models import t5 as JT5
    from galvatron_tpu.models.bert import bert_config
    from galvatron_tpu.models.llama import llama_config
    from galvatron_tpu.models.vit import vit_config

    cfgs = {"gpt": JM.TransformerConfig(**GPT, compute_dtype=jnp.float32),
            "llama": llama_config("llama-0.3b", compute_dtype=jnp.float32, **LLAMA),
            "llama6": llama_config("llama-0.3b", compute_dtype=jnp.float32, **LLAMA6),
            "gpt_hd128": JM.TransformerConfig(**GPT_HD128, compute_dtype=jnp.float32)}
    tokens, labels, loss_mask = batch_np()
    jb = JD.prepare_batch(None, tokens, labels, loss_mask)
    weights, out = {}, {}

    def unsharded(key, c, tree, batch):
        loss, grads = jax.value_and_grad(lambda p: JM.lm_loss_fn(p, batch, c))(tree)
        flat_g = {}
        _flatten(jax.device_get(grads), "", flat_g)
        out[key] = dict(loss=float(loss), grads={n: np.asarray(v) for n, v in flat_g.items()},
                        tree=tree)

    for m, c in cfgs.items():
        tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(0), c))
        unsharded(m, c, tree, JD.prepare_batch(None, *batch_np(MODEL_SEQ[m])) if m in MODEL_SEQ
                  else jb)
    # the GPT with sharpened attention (query and key kernels x SHARP)
    sharp = jax.tree.map(np.array, out["gpt"]["tree"])
    for lp in sharp["layers"]:
        lp["wqkv"]["kernel"][:, :2] *= SHARP
    unsharded("gpt_sharp", cfgs["gpt"], sharp, jb)
    # the key-padded batch (attn_mask), natural order
    unsharded("gpt_padded", cfgs["gpt"], out["gpt"]["tree"],
              JD.prepare_batch(None, *case_batch_np(True)))
    unsharded("gpt_hd128_padded", cfgs["gpt_hd128"], out["gpt_hd128"]["tree"],
              JD.prepare_batch(None, *case_batch_np(True, MODEL_SEQ["gpt_hd128"])))
    # the encoder families (bert: MLM loss; vit: classification loss)
    t5 = JT5.t5_config("t5-test", compute_dtype=jnp.float32, **T5)
    swin = JSW.swin_config("swin-test", compute_dtype=jnp.float32, **SWIN)
    for m, c, fn, init in (
            ("bert", bert_config("bert-base", compute_dtype=jnp.float32, **BERT),
             JM.lm_loss_fn, JM.init_model_params),
            ("vit", vit_config("vit-base", compute_dtype=jnp.float32, **VIT),
             JM.classification_loss_fn, JM.init_model_params),
            ("t5", t5, JT5.t5_loss_fn, JT5.init_t5_params),
            ("swin", swin, JSW.swin_loss_fn, JSW.init_swin_params)):
        tree = jax.device_get(init(jax.random.PRNGKey(1), c))
        batch = {k: jnp.asarray(v) for k, v in encoder_batch_np(m).items()}
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b, c=c, fn=fn: fn(p, b, c)))(
            tree, batch)
        flat_g = {}
        _flatten(jax.device_get(grads), "", flat_g)
        out[m] = dict(loss=float(loss), grads={n: np.asarray(v) for n, v in flat_g.items()},
                      tree=tree)
    for m in MODELS:
        flat_p = {}
        _flatten(out[m]["tree"], "", flat_p)
        weights.update({"%s/%s" % (m, n): np.asarray(v, np.float32) for n, v in flat_p.items()})
    # the JAX package's own sharded run of the divergence case (two CPU
    # devices; its batch zigzag-permuted by its prepare_batch)
    kw = CASES[2][DIVERGENCE_CASE]
    hp = JHP(world_size=2, pp=1, layers=[JLS(**s) for s in kw["layers"]], global_bsz=B)
    model = JAPI.construct_hybrid_parallel_model(cfgs["gpt"], hp, jax.devices()[:2])
    sharded_loss = jax.jit(model.loss_fn)(
        jax.device_put(out["gpt_sharp"]["tree"], model.shardings()),
        model.shard_batch(JD.prepare_batch(hp, tokens, labels, loss_mask)))
    divergence = dict(jax_sharded_loss=float(sharded_loss))
    cfg, tree = cfgs["gpt"], out["gpt"]["tree"]

    layers = CASES[4][TRAJ_CASE]["layers"]
    hp = JHP(world_size=1, pp=1, layers=[JLS(checkpoint=s.get("checkpoint", 0)) for s in layers],
             global_bsz=B, chunks=CASES[4][TRAJ_CASE]["chunks"])
    model = JAPI.construct_hybrid_parallel_model(cfg, hp)
    tx, _ = JO.get_optimizer_and_scheduler(JO.OptimizerArgs(**OPT))
    params = jax.device_put(tree, model.shardings())
    state = model.init_opt_state(tx, params)
    step = model.make_train_step(tx, donate=False)
    losses = []
    for _ in range(TRAJ_STEPS):
        params, state, metrics = step(params, state, jb)
        losses.append(float(metrics["loss"]))
    adam = next(s for s in state if isinstance(s, optax.ScaleByAdamState))
    traj = {"loss": np.asarray(losses)}
    for kind, t in (("param", params), ("mu", adam.mu), ("nu", adam.nu)):
        flat = {}
        _flatten(jax.device_get(t), "", flat)
        traj.update({"%s/%s" % (kind, n): np.asarray(v) for n, v in flat.items()})
    serve, serve_weights = _serve_reference(tmp_dir)
    weights.update(serve_weights)
    inputs = os.path.join(tmp_dir, "weights.npz")
    np.savez(inputs, **weights)
    _loop_plan(tmp_dir)
    _h2g_checkpoint(tmp_dir)
    return dict(models=out, traj=traj, inputs=inputs, divergence=divergence, serve=serve)


# a world-2 profile: the tiny llama's tables of tests/test_torch_profile.py
# and two-rank collective tables
LOOP_TIME = {"layertype_0": 4.7, "other_time": 0.4}
LOOP_MEMORY = {
    "layertype_0": {"parameter_size": 1.377, "tp_activation_per_bsz_dict": {
        1: 4.0, 2: 2.0, 4: 1.0, 8: 0.5, "checkpoint": 0.25}},
    "other_memory_pp_off": {"model_states": {1: 2.0, 2: 1.0, 4: 0.5, 8: 0.25},
                            "activation": {1: 0.9, 2: 0.45, 4: 0.225, 8: 0.112}},
    "other_memory_pp_on": {
        "first_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                        "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}},
        "last_stage": {"model_states": {1: 1.0, 2: 0.5, 4: 0.25, 8: 0.125},
                       "activation": {1: 0.45, 2: 0.225, 4: 0.112, 8: 0.056}}},
}
LOOP_HARDWARE = {
    "allreduce_bandwidth_2chips.json": {"allreduce_size_2_consec_1": 130.0},
    "p2p_bandwidth_2chips.json": {"pp_size_2": 160.0},
    "sp_time_2chips.json": {"allreduce": {"2": {"popt": [0.02, 0.01]}},
                            "all2all": {"2": {"popt": [0.01, 0.01]}}},
    "overlap_coefficient.json": {"overlap_coe": 1.12},
}


def _loop_plan(tmp_dir: str) -> str:
    """``cli search --sp_space tp+sp --enable_cp 1`` for a world of 2 over
    the profile above; writes LOOP_PLAN beside the weights."""
    from galvatron_tpu_torch.cli import search as TCLI

    config_dir = os.path.join(tmp_dir, "loop_profile")
    os.makedirs(config_dir, exist_ok=True)
    tag = "bf16_hidden128_head2_seqlen64_llama"
    for name, data in (("computation_profiling_%s.json" % tag, LOOP_TIME),
                       ("memory_profiling_%s.json" % tag, LOOP_MEMORY),
                       *LOOP_HARDWARE.items()):
        with open(os.path.join(config_dir, name), "w") as f:
            json.dump(data, f)
    # T5's two layer types, each with the llama's layer tables
    t5_dir = os.path.join(tmp_dir, "t5_loop_profile")
    os.makedirs(t5_dir, exist_ok=True)
    tag = "bf16_hidden64_head4_seqlen32_t5"
    t5_memory = dict(LOOP_MEMORY, layertype_1=LOOP_MEMORY["layertype_0"])
    for name, data in (("computation_profiling_%s.json" % tag,
                        dict(LOOP_TIME, layertype_1=LOOP_TIME["layertype_0"] * 1.3)),
                       ("memory_profiling_%s.json" % tag, t5_memory),
                       *LOOP_HARDWARE.items()):
        with open(os.path.join(t5_dir, name), "w") as f:
            json.dump(data, f)
    plan = os.path.join(tmp_dir, LOOP_PLAN)
    old = os.environ.get("GALVATRON_WORLD_SIZE")
    os.environ["GALVATRON_WORLD_SIZE"] = "2"
    search = ["--memory_constraint", "0.6", "--settle_bsz", "8", "--settle_chunk", "2",
              "--sp_space", "tp+sp", "--enable_cp", "1"]
    try:
        TCLI.main(LOOP_MODEL_ARGV + ["--config_dir", config_dir, "--output_config_path", plan,
                                     "--log_dir", os.path.join(tmp_dir, "loop_logs")] + search)
        TCLI.main(T5_LOOP_MODEL_ARGV + [
            "--config_dir", t5_dir, "--output_config_path", os.path.join(tmp_dir, T5_LOOP_PLAN),
            "--log_dir", os.path.join(tmp_dir, "t5_loop_logs")] + search)
    finally:
        if old is None:
            del os.environ["GALVATRON_WORLD_SIZE"]
        else:
            os.environ["GALVATRON_WORLD_SIZE"] = old
    return plan


def _launch(world, inputs, out, fault=True, timeout=240, extra=()):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                     "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), os.path.abspath(__file__), "--worker", str(world),
           inputs, out] + (["--fault"] if fault else []) + list(extra)
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-8000:]
    return dict(np.load(out))


def grad_errors(got, want):
    """Per gradient, max |got - want| over its limit 1e-4 * max|want| + 1e-6
    (> 1 fails)."""
    return {n: float(np.abs(got[n] - w).max() / (GRAD_REL * np.abs(w).max() + GRAD_ABS))
            for n, w in want.items()}


def saved_reference(tmp_dir):
    """The reference of ``--weights DIR`` (its losses, gradients,
    trajectory and divergence, without the trees), read with numpy alone,
    or None when DIR holds none."""
    import pickle

    path = os.path.join(tmp_dir, "reference.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def save_reference(tmp_dir, ref):
    import pickle

    kept = dict(ref, models={k: {n: v for n, v in m.items() if n != "tree"}
                             for k, m in ref["models"].items()})
    with open(os.path.join(tmp_dir, "reference.pkl"), "wb") as f:
        pickle.dump(kept, f)


def report(tmp_dir, given=None):
    """The tolerances the parity reached: per case the loss error and the
    worst gradient's error as a share of its limit; the trajectory's loss
    and tree-relative param/moment errors, and their worst per-tensor
    relative error. `given` maps a world size to a worker's results file
    (e.g. a run on GPUs, written with the weights of
    ``--weights DIR``) instead of launching gloo ranks here."""
    ref = (saved_reference(tmp_dir) if given else None) or _reference(tmp_dir)
    loads = {}
    for world in sorted(given or CASES):
        res = dict(np.load(given[world])) if given else \
            _launch(world, ref["inputs"], os.path.join(tmp_dir, "out%d.npz" % world))
        for name, kw in CASES[world].items():
            if "%s/loss" % name not in res:
                print("world %d %-28s not run (on the card: a ring layer at no kernel "
                      "head_dim)" % (world, name))
                continue
            want = ref["models"][_ref_key(kw)]
            errs = grad_errors({n: res["%s/grad/%s" % (name, n)] for n in want["grads"]},
                               want["grads"])
            worst = max(errs, key=errs.get)
            print("world %d %-28s loss err %.3g  worst gradient %s at %.3f of its limit"
                  % (world, name, abs(float(res["%s/loss" % name]) - want["loss"]), worst,
                     errs[worst]))
        if world == 4:
            traj = ref["traj"]
            print("trajectory losses: max err %.3g" % np.abs(res["traj/loss"] - traj["loss"]).max())
            for kind in ("param", "mu", "nu"):
                keys = [k for k in traj if k.startswith(kind + "/")]
                scale = max(float(np.abs(traj[k]).max()) for k in keys)
                err = max(float(np.abs(res["traj/" + k] - traj[k]).max()) for k in keys)
                rel = max(float(np.abs(res["traj/" + k] - traj[k]).max()
                                / max(np.abs(traj[k]).max(), 1e-30)) for k in keys)
                print("trajectory %-5s max err %.3g = %.3g of the tree max; worst per tensor "
                      "%.3g of its own max" % (kind, err, err / scale, rel))
            want = ref["models"]["gpt"]
            errs = grad_errors({n: res["fault/grad/%s" % n] for n in want["grads"]},
                               want["grads"])
            print("planted fault: worst gradient at %.3f of its limit" % max(errs.values()))
            if "lctraj/loss" in res:
                print("long-context trajectory: losses max err %.3g; params max err %.3g of the "
                      "tree max" % (
                          np.abs(res["lctraj/loss"] - traj["loss"]).max(),
                          max(float(np.abs(res["lctraj/" + k] - traj[k]).max()) for k in traj
                              if k.startswith("param/"))
                          / max(float(np.abs(traj[k]).max()) for k in traj
                                if k.startswith("param/"))))
        if world == 2 and "pptraj/loss" in res:
            traj = ref["traj"]
            print("pipeline trajectory (tied GPT, 1F1B 3,1): losses max err %.3g; params max "
                  "err %.3g of the tree max; tied copies bitwise equal: %s" % (
                      np.abs(res["pptraj/loss"] - traj["loss"]).max(),
                      max(float(np.abs(res["pptraj/" + k] - traj[k]).max()) for k in traj
                          if k.startswith("param/"))
                      / max(float(np.abs(traj[k]).max()) for k in traj if k.startswith("param/")),
                      bool((res["pptraj/wte_copies"] == res["pptraj/wte_copies"][0]).all())))
        for name in sorted({k.rsplit("/", 1)[0] for k in res if "/elastic_" in k}):
            got, ref_losses = res[name + "/losses"], res[name + "/ref"]
            print("world %d %s resume: restored state bitwise %s, across strategies %s, "
                  "losses max err %.3g against the plain resume's" % (
                      world, name, bool(res[name + "/bitwise"]), bool(res[name + "/cross"]),
                      float(np.abs(got - ref_losses).max())))
        if "h2g/losses" in res:
            print("world %d train --load of an h2g step under tp 2 + vocab tp 2 and ZeRO-3: "
                  "losses %s (params only: %s)" % (world, res["h2g/losses"].tolist(),
                                                   bool(res["h2g/params_only"])))
        if world == 2 and "%s/loss" % DIVERGENCE_CASE in res:
            want = ref["models"]["gpt_sharp"]["loss"]
            print("zigzag divergence ([cp2, cp1] x 2, weights x %g): JAX sharded loss off the "
                  "unsharded by %.3g, the port's by %.3g" % (
                      SHARP, abs(ref["divergence"]["jax_sharded_loss"] - want),
                      abs(float(res["%s/loss" % DIVERGENCE_CASE]) - want)))
        for name in SERVE_CASES.get(world, {}):
            if "%s/logits" % name not in res:
                continue
            got, sref = res["%s/logits" % name], ref["serve"]
            n = got.shape[1]
            print("world %d %-28s logits err %.3g (unsharded engine), %.3g (tp 2 on 8 devices), "
                  "%.3g (recompute); greedy tokens equal: %s" % (
                      world, name, *(float(np.abs(got - sref[k][:, :n]).max())
                                     for k in ("logits", "logits8", "recompute")),
                      bool((res["%s/tokens" % name] == sref["tokens"][:, :n]).all())))
        want = ref["serve"]["load"]
        for key in ("serve_agree", "serve_mig3", "serve_mig2"):
            if "%s/outputs" % key in res:
                done = _outputs(res["%s/outputs" % key])
                print("world %d %s: %d requests completed, tokens equal to the reference "
                      "batcher's: %s%s" % (world, key, len(done),
                                           all(done[r] == want[r] for r in done),
                                           "; migration %s" % str(res["%s/migration" % key])
                                           if "%s/migration" % key in res else ""))
        if "serve_load/outputs" in res:
            loads[world] = _outputs(res["serve_load/outputs"])
            print("world %d serve --load of world 2's train checkpoint: %d requests, tokens "
                  "equal to world 2's: %s" % (world, len(loads[world]),
                                               loads[world] == loads.get(2, loads[world])))
        if "serve_gls015/exit" in res:
            print("world 2 serve GLS015 drill: exit %d" % int(res["serve_gls015/exit"]))
        print("world %d relayout round trips exact: %s; init equals a one-rank init: %s" % (
            world, all(not res[k].any() for k in res if k.startswith("relayout/")),
            all(np.array_equal(res["init/" + k[9:]], res[k]) for k in res
                if k.startswith("init_ref/"))))


USAGE = """usage:
  test_torch_parallel.py --worker WORLD WEIGHTS OUT [--fault] [--device cuda] [--serve_ckpt DIR]
      one rank of a world (launch with torchrun --nproc_per_node WORLD); the
      world-4 worker serves DIR, the world-2 worker's train checkpoint
      (OUT's directory/ckpt_w2), when given
  test_torch_parallel.py --weights DIR
      write the weights the workers load (DIR/weights.npz; needs jax) and
      the JAX package's reference (DIR/reference.pkl)
  test_torch_parallel.py --report DIR [WORLD=RESULTS.npz ...]
      print the tolerances reached: gloo ranks launched here, or given
      results of workers run elsewhere (e.g. on GPUs with --device cuda),
      against DIR/reference.pkl where --weights wrote one (numpy alone:
      the report then runs beside the workers, without jax)"""


if __name__ == "__main__":
    sys.path.insert(0, REPO)  # run as a script, the package is beside tests/
    if len(sys.argv) > 2 and sys.argv[1] in ("--report", "--weights"):
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        # the JAX package's sharded divergence run takes two CPU devices
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
        os.makedirs(sys.argv[2], exist_ok=True)
        if sys.argv[1] == "--weights":
            ref = _reference(sys.argv[2])
            save_reference(sys.argv[2], ref)
            print(ref["inputs"])
        else:
            report(sys.argv[2], {int(a.split("=")[0]): a.split("=", 1)[1]
                                 for a in sys.argv[3:]} or None)
        raise SystemExit(0)
    if len(sys.argv) < 5 or sys.argv[1] != "--worker":
        raise SystemExit(USAGE)
    device = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cpu"
    serve_ckpt = (sys.argv[sys.argv.index("--serve_ckpt") + 1] if "--serve_ckpt" in sys.argv
                  else None)
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], "--fault" in sys.argv[5:], device,
            serve_ckpt)
    raise SystemExit(0)


# ======================================================================== tests
import pytest  # noqa: E402


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _reference(str(tmp_path_factory.mktemp("torch_parallel")))


@pytest.fixture(scope="module")
def world_results(reference, tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            extra = ()
            if world == 4:  # it serves the world-2 worker's train checkpoint
                extra = ("--serve_ckpt", str(get(2)["ckpt/dir"]))
            out = str(tmp_path_factory.mktemp("world%d" % world) / "out.npz")
            cache[world] = _launch(world, reference["inputs"], out, extra=extra)
        return cache[world]

    return get


CASE_IDS = [(w, n) for w in sorted(CASES, reverse=True) for n in CASES[w]]


@pytest.mark.parametrize("world,name", CASE_IDS, ids=["w%d-%s" % c for c in CASE_IDS])
def test_layout_loss_and_every_gradient_match_unsharded_reference(world, name, reference,
                                                                  world_results):
    res = world_results(world)
    ref = reference["models"][_ref_key(CASES[world][name])]
    loss = float(res["%s/loss" % name])
    assert abs(loss - ref["loss"]) <= LOSS_TOL, (loss, ref["loss"])
    got = {n: res["%s/grad/%s" % (name, n)] for n in ref["grads"]}
    errs = grad_errors(got, ref["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1.0, "%s: %s at %.3g of its limit" % (name, worst, errs[worst])


@pytest.mark.parametrize("world", sorted(CASES))
def test_random_init_gives_every_world_size_the_same_weights(world, world_results):
    """Each rank draws every full parameter from the seeded generator and
    keeps its shard: the gathered weights equal a one-rank init
    (``init_model_params``) from the same generator."""
    res = world_results(world)
    refs = [k for k in res if k.startswith("init_ref/")]
    assert len(refs) > 10
    for k in refs:
        np.testing.assert_array_equal(res["init/" + k[len("init_ref/"):]], res[k], err_msg=k)


@pytest.mark.parametrize("i", range(len(RELAYOUTS)))
def test_relayout_round_trip_gives_each_rank_its_shard(i, world_results):
    """Re-laying a tensor's shards from one placement to another and back
    gives every rank exactly its shard under each (through the meet)."""
    assert world_results(4)["relayout/%d" % i].tolist() == [0.0, 0.0], RELAYOUTS[i]


def test_hetero_trajectory_matches_unsharded_optax(reference, world_results):
    """Losses within 5e-5; params, mu and nu each within 5e-5 * the max of
    their gathered tree. (Per tensor, a zero-initialized bias a few Adam
    steps old differs by up to ~6e-4 of its own max, at world size 1 as
    much as at 4: Adam's update divides near-cancelling moment sums, which
    amplifies the gradients' fp32 reassociation noise. A layout fault —
    a moment on the wrong shard, an update not gathered back — moves a
    parameter by a whole update, ~lr = 1e-3.)"""
    res, want = world_results(4), reference["traj"]
    np.testing.assert_allclose(res["traj/loss"], want["loss"], rtol=0, atol=TRAJ_TOL)
    for kind in ("param", "mu", "nu"):
        keys = [k for k in want if k.startswith(kind + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        errs = {k: float(np.abs(res["traj/" + k] - want[k]).max()) for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TRAJ_TOL * scale, (worst, errs[worst], scale)


def test_long_context_hetero_trajectory_matches_unsharded_optax(reference, world_results):
    """The reference's heterogeneous strategy ([tp2, Ulysses 4, cp2 +
    ZeRO-3, remat], chunks 2, ZeRO-2), its batch zigzag-permuted by
    prepare_batch: three steps within the limits of the trajectory above."""
    res, want = world_results(4), reference["traj"]
    np.testing.assert_allclose(res["lctraj/loss"], want["loss"], rtol=0, atol=TRAJ_TOL)
    for kind in ("param", "mu", "nu"):
        keys = [k for k in want if k.startswith(kind + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        errs = {k: float(np.abs(res["lctraj/" + k] - want[k]).max()) for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TRAJ_TOL * scale, (worst, errs[worst], scale)


def test_zigzag_divergence_of_the_reference_and_the_ports_fix(reference, world_results):
    """[cp2, cp1] x 2 under zigzag with sharpened attention: the JAX
    package's sharded loss is off its unsharded loss by at least 100 times
    the port's error (its cp=1 layers mask the permuted sequence by
    index), and the port's is within the layout limit (its attention
    outside the ring puts the sequence in its true order first)."""
    want = reference["models"]["gpt_sharp"]["loss"]
    port_err = abs(float(world_results(2)["%s/loss" % DIVERGENCE_CASE]) - want)
    jax_err = abs(reference["divergence"]["jax_sharded_loss"] - want)
    assert port_err <= LOSS_TOL, port_err
    assert jax_err >= 100 * port_err and jax_err > 10 * LOSS_TOL, (jax_err, port_err)


def test_world2_long_context_save_and_resume_is_bitwise(world_results):
    """Ulysses 2, cp 2 (a ZeRO-3 layer among them), Megatron tp 2 and
    vocab sp under zigzag at world 2 through the train CLI: two rank files,
    the resumed losses equal the uninterrupted run's bit for bit, and a
    resume under every-layer dp is refused."""
    res = world_results(2)
    assert int(res["ckpt_lc/ranks"]) == 2 and int(res["ckpt_lc/start"]) == 3
    assert len(res["ckpt_lc/full"]) == 6 and np.isfinite(res["ckpt_lc/full"]).all()
    np.testing.assert_array_equal(res["ckpt_lc/first"], res["ckpt_lc/full"][:3])
    np.testing.assert_array_equal(res["ckpt_lc/resumed"], res["ckpt_lc/full"][3:])
    assert str(res["ckpt_lc/refused"]) == "GLS206"


def test_world2_train_cli_runs_the_long_context_plan_the_search_writes(reference,
                                                                       world_results):
    """``cli search --sp_space tp+sp --enable_cp 1`` at world 2 writes a
    plan with cp or sp layers (or vocab sp/cp); ``cli train`` runs it."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    hp = HybridParallelConfig.from_json(
        os.path.join(os.path.dirname(reference["inputs"]), LOOP_PLAN), world_size=2)
    assert (any(s.cp > 1 or (s.sp and s.tp > 1) for s in hp.layers)
            or hp.vocab_cp > 1 or (hp.vocab_sp and hp.vocab_tp > 1)), hp
    losses = world_results(2)["loop/losses"]
    assert len(losses) == LOOP_STEPS and np.isfinite(losses).all(), losses


def test_world2_train_loads_a_conversion_into_another_layout(reference, world_results):
    """``cli train --load`` of an h2g step (params only, written at world
    1) at world 2 under tp 2 + vocab tp 2 and ZeRO-3, without --elastic:
    its losses within the trajectory limit of the same load at world 1 in
    the pytest process (both fp32, a fresh optimizer)."""
    import torch

    from galvatron_tpu_torch.cli import train as T

    res = world_results(2)
    assert bool(res["h2g/params_only"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside JAX's CPU backend in this process
    try:
        with fp32_compute():
            world1 = T.main(H2G_ARGV + ["--device", "cpu", "--load", os.path.join(
                os.path.dirname(reference["inputs"]), H2G_DIR)])
    finally:
        torch.set_num_threads(threads)
    assert world1["checkpoint_restore"]["params_only"]
    np.testing.assert_allclose(res["h2g/losses"], world1["losses"], rtol=0, atol=TRAJ_TOL)


def test_world2_train_cli_runs_the_t5_plan_the_search_writes(reference, world_results):
    """``cli search`` of T5 at world 2 with ``--sp_space tp+sp --enable_cp
    1`` writes a plan that shards T5's sequence (cp or Ulysses layers, or
    vocab sp / cp); ``cli train`` runs it, on the plain attention."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig

    hp = HybridParallelConfig.from_json(
        os.path.join(os.path.dirname(reference["inputs"]), T5_LOOP_PLAN), world_size=2)
    assert (any(s.cp > 1 or (s.sp and s.tp > 1) for s in hp.layers)
            or hp.vocab_cp > 1 or (hp.vocab_sp and hp.vocab_tp > 1)), hp
    res = world_results(2)
    losses = res["t5_loop/losses"]
    assert len(losses) == LOOP_STEPS and np.isfinite(losses).all(), losses
    assert json.loads(str(res["t5_loop/flash"])) == [{"fwd": {}, "bwd": {}}] * 2


def test_planted_relayout_fault_fails_the_gradient_check(reference, world_results):
    """A reduce-scatter in place of the slice in one re-layout's backward
    leaves the loss as it was and scales gradients: the check must see it."""
    res, ref = world_results(4), reference["models"]["gpt"]
    assert abs(float(res["fault/loss"]) - ref["loss"]) <= LOSS_TOL
    got = {n: res["fault/grad/%s" % n] for n in ref["grads"]}
    errs = grad_errors(got, ref["grads"])
    assert max(errs.values()) > 1.0, "the planted fault passed the gradient check"


def test_world2_layout_save_and_resume_is_bitwise(world_results):
    """tp 2 + ZeRO-3 + ZeRO-2 at world 2 through the train CLI: each rank
    writes its shards (two rank files), the resumed losses equal the
    uninterrupted run's bit for bit."""
    res = world_results(2)
    assert int(res["ckpt/ranks"]) == 2 and int(res["ckpt/start"]) == 3
    assert len(res["ckpt/full"]) == 6 and np.isfinite(res["ckpt/full"]).all()
    np.testing.assert_array_equal(res["ckpt/first"], res["ckpt/full"][:3])
    np.testing.assert_array_equal(res["ckpt/resumed"], res["ckpt/full"][3:])


def test_world2_save_retries_one_ranks_failed_write_together(world_results):
    """Rank 1's first write fails: both ranks count the retry (they retried
    the write round together, no collective left unmatched), and the
    checkpoint the retry committed resumes bitwise (above)."""
    res = world_results(2)
    assert res["ckpt/write_faults"].tolist() == [0, 1]
    assert res["ckpt/save_retries"].tolist() == [1, 1]


def test_world2_resume_under_another_strategy_is_refused(world_results):
    assert str(world_results(2)["ckpt/refused"]) == "GLS206"


def test_pipeline_trajectory_matches_unsharded_optax_with_tied_copies_bitwise_equal(
        reference, world_results):
    """A tied GPT under 1F1B at world 2 (stages of 3 and 1 layers, one per
    rank): three steps within the limits of the hetero trajectory, and the
    first and last stage's copies of the table bitwise equal after them
    (both get the summed gradient, the same moments and the same update)."""
    res, want = world_results(2), reference["traj"]
    np.testing.assert_allclose(res["pptraj/loss"], want["loss"], rtol=0, atol=TRAJ_TOL)
    for kind in ("param", "mu", "nu"):
        keys = [k for k in want if k.startswith(kind + "/")]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        errs = {k: float(np.abs(res["pptraj/" + k] - want[k]).max()) for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TRAJ_TOL * scale, (worst, errs[worst], scale)
    copies = res["pptraj/wte_copies"]
    assert copies.shape[0] == 2
    np.testing.assert_array_equal(copies[0], copies[1])


def test_world2_pipeline_save_and_resume_is_bitwise(world_results):
    """1F1B pp 2 through the train CLI at world 2: the run that saved at 3
    and its resume give the uninterrupted run's losses bit for bit."""
    res = world_results(2)
    assert int(res["ckpt_pp/start"]) == 3
    assert len(res["ckpt_pp/full"]) == 6 and np.isfinite(res["ckpt_pp/full"]).all()
    np.testing.assert_array_equal(res["ckpt_pp/first"], res["ckpt_pp/full"][:3])
    np.testing.assert_array_equal(res["ckpt_pp/resumed"], res["ckpt_pp/full"][3:])


def test_world2_pipeline_checkpoint_reassembles_and_holds_the_tied_table_once(world_results):
    """``load_full_params`` of the pp 2 checkpoint is exactly the trained
    model gathered from both stages; only the first stage's file holds the
    tied table."""
    res = world_results(2)
    assert bool(res["ckpt_pp/full_params_equal"])
    assert res["ckpt_pp/wte_files"].tolist() == [True, False]


@pytest.mark.parametrize("world", [2, 4])
def test_hardware_profile_writes_the_jax_packages_files_and_keys(world, world_results, tmp_path):
    """The port's `profile_all` at world N writes the files and keys the
    JAX package's HardwareProfiler writes on an N-device CPU mesh, less the
    quantization toll (the port leaves ``quant_overhead_coe`` to the
    parser's default until the quantized collectives are ported)."""
    import json

    import jax

    from galvatron_tpu.profiler.hardware import HardwareProfileArgs, HardwareProfiler

    got = json.loads(str(world_results(world)["hw/tables"]))
    HardwareProfiler(HardwareProfileArgs(config_dir=str(tmp_path), **HW_ARGS),
                     devices=jax.devices()[:world]).profile_all(write=True)
    want = {}
    for name in sorted(os.listdir(tmp_path)):
        with open(tmp_path / name) as f:
            want[name] = _json_keys(json.load(f))
    assert want["overlap_coefficient.json"].pop("quant_overhead_coe", "absent") is None
    assert got == want
    assert "allreduce_size_%d_consec_1" % world in got["allreduce_bandwidth_%dchips.json" % world]


@pytest.mark.parametrize("world", [2, 4])
def test_hardware_profile_collectives_compute_the_right_result(world, world_results):
    import json

    errs = json.loads(str(world_results(world)["hw/errors"]))
    n_groups = {2: 2, 4: 4}[world]  # group sizes x placements
    assert len(errs) == len(HW_KINDS) * n_groups
    assert max(errs.values()) <= 1e-5, errs  # fp32 sums of values up to 6


def test_world2_pipeline_resume_under_pp1_is_refused(world_results):
    assert str(world_results(2)["ckpt_pp/refused"]) == "GLS206"


ELASTIC_CASES = ["ckpt/elastic_other", "ckpt/elastic_tp1", "ckpt/elastic_pp2",
                 "ckpt_pp/elastic_pp1"]


@pytest.mark.parametrize("case", ELASTIC_CASES)
def test_world2_elastic_resume_restores_bitwise_and_continues(case, world_results):
    """The step-3 checkpoint under another strategy at world 2 through
    ``cli train --elastic resume``: a zero-step run's save holds the saved
    params and moments bit for bit, and the run to step 6 stays within
    the trajectory limit of the saved strategy's own resume (both fp32)."""
    res = world_results(2)
    assert bool(res[case + "/cross"]) and int(res[case + "/restored_steps"]) == 0
    assert bool(res[case + "/bitwise"])
    assert len(res[case + "/ref"]) == 3
    np.testing.assert_allclose(res[case + "/losses"], res[case + "/ref"], rtol=0,
                               atol=TRAJ_TOL)


def test_world2_checkpoint_resumes_at_world1_in_the_pytest_process(world_results, tmp_path):
    """The world-2 tp 2 + ZeRO-3 + ZeRO-2 checkpoint at world 1 (one gloo
    rank here) under tp 1 with the same dp types: bitwise restore, then
    the run to step 6 within the trajectory limit of the world-2 plain
    resume (both fp32)."""
    import torch

    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.cli.arguments import model_config_from_args
    from galvatron_tpu_torch.runtime import checkpoint as ck

    res = world_results(2)
    ckpt_dir = str(res["ckpt/dir"])
    path = str(tmp_path / "world1.json")
    with open(path, "w") as f:
        json.dump(dict(CKPT_STRATEGY, tp_sizes_enc="1,1,1,1"), f)
    w = CKPT_ARGV.index("--world_size")
    argv = CKPT_ARGV[:w] + CKPT_ARGV[w + 2:] + [
        "--device", "cpu", "--elastic", "resume", "--elastic_strategy", path, "--load", ckpt_dir]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside JAX's CPU backend in this process
    try:
        restored = T.train(T.initialize_galvatron(
            argv=argv + ["--train_iters", "3", "--save", str(tmp_path / "w1")], mode="train"))
        with fp32_compute():
            resumed = T.train(T.initialize_galvatron(argv=argv + ["--train_iters", "6"],
                                                     mode="train"))
    finally:
        torch.set_num_threads(threads)
    assert restored["losses"] == [] and restored["checkpoint_restore"]["cross_strategy"]
    assert restored["checkpoint_restore"]["saved_world_size"] == 2
    _, cfg = model_config_from_args(T.initialize_galvatron(argv=argv, mode="train"))
    (pa, sa, _), (pb, sb, _) = (ck.load_full_state(d, 3, cfg) for d in (ckpt_dir,
                                                                         str(tmp_path / "w1")))
    assert sorted(pa) == sorted(pb) and sa.count == sb.count == 3
    for n in pa:
        assert torch.equal(pa[n], pb[n]) and torch.equal(sa.mu[n], sb.mu[n]) and \
            torch.equal(sa.nu[n], sb.nu[n]), n
    np.testing.assert_allclose(resumed["losses"], res["ckpt/elastic_other/ref"], rtol=0,
                               atol=TRAJ_TOL)


# --------------------------------------------------- the resilience slice
def _weights(reference, model):
    data = np.load(reference["inputs"])
    return {k[len(model) + 1:]: data[k] for k in data.files if k.startswith(model + "/")}


@pytest.mark.parametrize("world,name", CASE_IDS, ids=["w%d-%s" % c for c in CASE_IDS])
def test_layout_fold_equals_the_references_host_fold(world, name, reference, world_results):
    """The silent-corruption sentinel's fold of the logical params under
    every layout (owned shards only, summed mod 2^32 over the world: dp
    replicas, ZeRO-3 and TP shards, a tied table on two stages, each
    element once) equals the JAX package's ``host_tree_fold`` of the
    weights the ranks sharded."""
    from galvatron_tpu.runtime import sdc as JS

    want = JS.host_tree_fold(_weights(reference, CASES[world][name].get("model", "gpt")))
    assert int(world_results(world)["%s/fold" % name]) == want


@pytest.mark.parametrize("world,key", [(4, "traj"), (2, "pptraj")])
def test_digest_trajectory_is_bitwise_the_plain_one(world, key, world_results):
    """``sdc_check="digest"`` only adds a side output: losses, params and
    both moments after the steps are bitwise the plain run's (world 4
    hetero layout; world 2 tied pp 2), and the last step's fold is the fold
    of the params it handed back."""
    from galvatron_tpu.runtime import sdc as JS

    res = world_results(world)
    got = {k[len(key) + 8:]: v for k, v in res.items() if k.startswith(key + "_digest/")}
    want = {k[len(key) + 1:]: v for k, v in res.items() if k.startswith(key + "/")}
    if key == "pptraj":  # the digest run kept no tied-copy record
        want.pop("wte_copies")
    assert sorted(got) == sorted(list(want) + ["fold"])
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    params = {k[len("param/"):]: v for k, v in want.items() if k.startswith("param/")}
    assert int(got["fold"]) == JS.host_tree_fold(params)


def test_world2_lost_rank_migrates_to_the_survivor_as_save_and_resume(world_results):
    """A probe that finds rank 1 missing from step 3 (simulated: alive, not
    in the live list) under --migrate_on_degrade: the run moves to rank 0
    alone in memory, rank 1 leaves, and the steps from 3 on are bit for
    bit those of the clean run's step-3 save resumed at world 1."""
    res = world_results(2)
    migrations = json.loads(str(res["lost/migrations"]))
    assert [(m["reason"], m["iteration"], m["from_world"], m["to_world"])
            for m in migrations] == [("degraded_mesh", 3, 2, 1)]
    assert int(res["lost/world"]) == 1
    assert np.array_equal(res["lost/losses"][:3], res["lost/clean"][:3])
    assert np.array_equal(res["lost/losses"][3:], res["lost/resumed"])


def test_world4_mesh_probe_is_healthy_and_timed(world_results):
    res = world_results(4)
    assert bool(res["probe/healthy"]) and len(res["probe/seconds"]) == 5
    assert (res["probe/seconds"] > 0).all()


def test_world2_sigusr1_migration_continues_as_save_and_resume(world_results):
    """SIGUSR1 at step 3 moves the live state from tp 2 + ZeRO-3 + ZeRO-2
    to plain dp in memory (the digest's continuity held across it); the
    steps after it are bit for bit those of the step-3 checkpoint resumed
    under the same target."""
    res = world_results(2)
    migrations = json.loads(str(res["usr1/migrations"]))
    assert [(m["reason"], m["iteration"], m["from_world"], m["to_world"])
            for m in migrations] == [("sigusr1", 3, 2, 2)]
    assert json.loads(str(res["usr1/strategy"])) == json.loads(str(res["usr1/resumed_strategy"]))
    assert len(res["usr1/migrated"]) == 6
    assert np.array_equal(res["usr1/migrated"][3:], res["usr1/resumed"])


def test_world4_one_shot_bitflip_is_localized_repaired_and_bitwise_clean(world_results):
    """A bit flipped in rank 2's replica before step 2: the vote localizes
    it, the step applies nothing, the replica is repaired from a healthy
    one and the step runs again; every loss is the clean run's bit for bit
    and no rank is quarantined."""
    res = world_results(4)
    assert np.array_equal(res["vote/once/losses"], res["vote/clean/losses"])
    mismatches, reexecutions, quarantines, checks = res["vote/once/counters"]
    assert mismatches == reexecutions == 1 and quarantines == 0
    assert res["vote/clean/counters"][:3].tolist() == [0, 0, 0]
    assert res["vote/clean/counters"][3] == 6


def test_world4_persistent_bitflip_quarantines_the_rank_and_migrates(world_results):
    """A flip stuck on rank 3 from step 3: two strikes quarantine it, the
    run migrates in memory to the 3 survivors (rank 3's process leaves) and
    goes on voting; its steps from 3 on are bit for bit those of the clean
    step-3 checkpoint resumed at world 3 under the same strategy."""
    res = world_results(4)
    migration = json.loads(str(res["vote/stuck/migration"]))
    assert [(m["reason"], m["iteration"], m["from_world"], m["to_world"])
            for m in migration] == [("sdc_quarantine", 3, 4, 3)]
    mismatches, reexecutions, quarantines, _ = res["vote/stuck/counters"]
    assert quarantines == 1 and mismatches == reexecutions == 2
    assert int(res["vote/stuck/world"]) == int(res["vote/resumed/world"]) == 3
    assert int(res["vote/resumed/start"]) == 3 and str(res["vote/sdc_mode"]) == "vote"
    assert np.array_equal(res["vote/stuck/losses"][:3], res["vote/clean/losses"][:3])
    assert np.array_equal(res["vote/stuck/losses"][3:], res["vote/resumed/losses"])


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("world,name", SERVE_CASE_IDS, ids=["w%d-%s" % c for c in SERVE_CASE_IDS])
def test_serve_layout_decode_matches_the_jax_engines_and_recompute(world, name, reference,
                                                                   world_results):
    """The engine under a serve layout (kv heads over tp, slots over dp,
    ZeRO-3 gathered per layer, vocab tp, a mixed per-layer plan, an
    off-grid slot count): the prefill's and every decode step's logits
    within 2e-5 of the JAX package's engine unsharded and under tp 2 on its
    8-device mesh, and of the full-forward recompute; greedy tokens equal;
    and ``cli serve`` under the layout serves every request with the JAX
    package's batcher's tokens."""
    res, ref = world_results(world), reference["serve"]
    logits, tokens = res["%s/logits" % name], res["%s/tokens" % name]
    n = logits.shape[1]
    for key in ("logits", "logits8", "recompute"):
        err = float(np.abs(logits - ref[key][:, :n]).max())
        assert err <= SERVE_ATOL, (name, key, err)
    np.testing.assert_array_equal(tokens, ref["tokens"][:, :n])
    np.testing.assert_array_equal(tokens, ref["tokens8"][:, :n])
    # ``cli serve`` under the layout: every request's tokens the JAX batcher's
    assert _outputs(res["%s/cli" % name]) == ref["load"]


_CKPT_REFS = {}


def _ckpt_reference(world_results):
    """(the JAX package's batcher, ``cli serve --load`` at world 1 in this
    process) over the served load on the world-2 train checkpoint (step 3):
    rid -> tokens of each."""
    import dataclasses

    import jax.numpy as jnp

    from galvatron_tpu.cli import arguments as JA
    from galvatron_tpu_torch.cli.arguments import initialize_galvatron, model_config_from_args
    from galvatron_tpu_torch.runtime import checkpoint as ck

    ckpt_dir = str(world_results(2)["ckpt/dir"])
    if ckpt_dir not in _CKPT_REFS:
        _, tcfg = model_config_from_args(initialize_galvatron(argv=CKPT_MODEL_ARGV))
        full, _ = ck.load_full_params(ckpt_dir, 3, tcfg)
        _, jcfg = JA.model_config_from_args(JA.initialize_galvatron(mode="serve",
                                                                    argv=CKPT_MODEL_ARGV))
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        jax_out = _jax_batcher_outputs(jcfg, _jax_tree({n: t.numpy() for n, t in full.items()}),
                                       slots=4, n=6)
        port = _serve_cli(CKPT_MODEL_ARGV + [
            "--device", "cpu", "--load", ckpt_dir, "--load_iteration", "3",
            "--serve_page_size", str(SERVE_PAGE), "--serve_max_concurrency", "4",
            "--num_requests", "6", "--prompt_len_min", "3", "--prompt_len_max", "12",
            "--max_new_tokens", str(SERVE_LOAD["max_new_tokens"]), "--seed", str(SERVE_SEED),
            "--mixed_precision", "fp32"])
        _CKPT_REFS[ckpt_dir] = jax_out, _outputs(_serve_outputs(port))
    return _CKPT_REFS[ckpt_dir]


@pytest.mark.parametrize("world", [2, 4])
def test_train_checkpoint_restores_into_serve_layout(world, world_results):
    """``cli serve --load`` of the world-2 train checkpoint (tp 2, ZeRO-3,
    ZeRO-2) into a world-2 and a world-4 serve layout, each rank reading
    only its slices across strategies: the served tokens equal the same
    load at world 1 (in this process) and the JAX package's batcher on the
    checkpoint's parameters."""
    res = world_results(world)
    assert bool(res["serve_load/cross"]) and int(res["serve_load/world"]) == world
    jax_out, world1 = _ckpt_reference(world_results)
    assert world1 == jax_out
    assert _outputs(res["serve_load/outputs"]) == world1


def test_world2_batcher_agrees_across_ranks_with_skewed_clocks(reference, world_results):
    """Each rank's batcher reads its own clock (offset and rate) and sheds
    by deadline, predicted TTFT and queue bound over real collectives: the
    ranks decide alike (or the run would hang), and every completed
    request's tokens are the reference batcher's."""
    res = world_results(2)
    assert bool(res["serve_agree/same"])
    done = _outputs(res["serve_agree/outputs"])
    want = reference["serve"]["load"]
    assert done and all(done[rid] == want[rid] for rid in done)


def test_world2_infeasible_surviving_world_drains_and_exits_2(world_results):
    """A lost rank whose surviving world cannot serve (the re-search under
    an impossible budget refuses with GLS015): the batcher drains and
    ``cli serve`` exits 2."""
    res = world_results(2)
    assert int(res["serve_gls015/exit"]) == 2
    drains = json.loads(str(res["serve_gls015/drains"]))
    assert [d["reason"] for d in drains] == ["migrate_infeasible", "migrate_infeasible"]
    assert drains[-1]["exit_code"] == 2


@pytest.mark.parametrize("key,worlds", [("serve_mig3", [3, 2]), ("serve_mig2", [2, 1])])
def test_serve_migration_off_a_lost_rank_replays_journals(key, worlds, reference,
                                                          world_results):
    """A serve whose mesh probe loses a rank mid-decode migrates in memory
    onto the survivors (dp 3 with replicated slots -> tp 2; dp 2 -> dp 1)
    and journal-replays its in-flight requests: every request completes
    with the uninterrupted run's tokens (the JAX package's batcher)."""
    res = world_results(4)
    assert res["%s/worlds" % key].tolist() == worlds
    assert int(res["%s/shed" % key]) == 0
    assert _outputs(res["%s/outputs" % key]) == reference["serve"]["load"]
    mig = json.loads(str(res["%s/migration" % key]))
    assert len(mig) == 1 and mig[0]["replayed"] > 0 and mig[0]["to_world"] == worlds[1]
