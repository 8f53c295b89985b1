#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (galvatron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA GPU + nvcc

Phases, in order; any failure exits non-zero and prints no result line:

1. Identify the card (nvidia-smi name and power limit); TF32 off.
2. Build the flash-attention forward and backward kernels and the tree
   fold from csrc/ with nvcc (sm_90a), one nvcc per source, and the
   dataset index helper
   (data/csrc/index_helpers.cpp) and the search's DP core (csrc/dp_core.cpp)
   with g++, all started together; fail if
   ptxas reports a spill in any wgmma kernel or ignores a `setmaxnreg`
   (warning C7508).
3. Hold the forward kernel against its plain PyTorch version on the card, in
   bf16, at B=1, nh=32, hd=128, S in {128, 512, 576, 1536, 2048}, causal,
   with and without a key-padding tail, and at B=4, B=2 and B=8, S=2048
   (the micro-batches of phases 8-9 and of phase 11, and phase 12's
   profile batch), on ALL rows (plus one fp32 and one head_dim-256 case),
   each element within a limit scaled by its own row (TOL_FWD_BF16); two
   planted faults (a zeroed first or last tile) must
   fail the same check. Every bf16 head_dim-128 case must have run the
   "wgmma" route. Times the kernel (``ms``: 20 calls back to back between
   two CUDA events, over 20, median of 5 runs, the kernel's time once the
   host's launch overhead runs ahead; ``ms_single``: the median of 25 single
   calls, each between its own events, as earlier versions of this script
   timed, host overhead included), the plain version and, as a yardstick the
   port never calls, torch's scaled_dot_product_attention, both ways (on a
   padded case with the boolean attn_mask of the segment ids and the
   causal mask, `sdpa_mask`).
4. The same for the backward kernel: bf16, B=1, nh=32, hd=128, S in
   {512, 576, 2048}, causal, with and without a key-padding tail, and B=4,
   B=2 and B=8 at S=2048, every row and key of dq, dk and dv (plus one fp32
   and one head_dim-256 case), with the same row-scaled check, planted faults and
   route check; the yardstick is the backward of
   scaled_dot_product_attention (autograd of SDPA, its forward excluded).
5. Gradients in place: LLaMA-7B width at depth 2, bf16, one micro-batch of
   2048 tokens; the loss and every parameter's gradient through the kernels
   against the plain attention path (``attn_impl="xla"``).
6. Decode against recompute: LLaMA-7B width at depth 4, bf16, through
   ServeEngine (prefill, then 4 decode steps); each step's logits against a
   full-sequence recompute through the plain attention path.
7. Serve: ``galvatron_tpu_torch.cli.serve.main`` in-process, LLaMA-7B at
   full depth (32 layers), 16 requests; asserts every request completes,
   the logits stay finite, and the flash forward kernel launched exactly
   32 x prefills times. Also times the fp32 -> bf16 weight casts one decode
   tick performs.
8. Train: ``galvatron_tpu_torch.cli.train.main`` in-process on the
   configuration of ``galvatron_tpu_torch/tools/train_cell.py``: LLaMA-7B
   width at depth 8 (cut from 32: fp32 params, grads and Adam moments of 32
   layers take 108 GB), seq 2048, global batch 8 in 2 micro-batches, a
   strategy JSON mixing per-layer remat (layers 0-3 full, 4-5
   dots_saveable, 6-7 none), 6 steps, with the default anomaly guard,
   prefetch thread and drain window; asserts finite losses and the launch
   counts of both kernels.
9. Train through the per-layer layout path: ``cli.train.main`` on the GPT
   configuration of ``tools/train_cell.py``: GPT-6.7B width (h 4096, 32
   heads, ffn 16384, vocab 50257, tied head) at depth 8 (cut from 32 for
   memory: 6.7 B parameters are ~107 GB of fp32 state, depth 8 ~29 GB), the
   same batch, steps and remat mix, layers 0-3 ZeRO-3 and the rest ZeRO-2,
   at world size 1 through one-rank NCCL groups; then again with every
   ``fsdp`` 0 (all ZeRO-2). Every step's loss of the two runs must agree
   within 1e-3 relative; both kernels' launch counts are checked on the
   ZeRO-3 run and the route of their last calls must be "wgmma".
10. Corpus, eval, checkpoint, resume: writes a corpus of 4,000 seeded
   documents (lengths uniform in 256-4096, vocab 32000, ~35 MB) with
   ``write_indexed_dataset``, and trains LLaMA-7B width at depth 2 (cut
   from 32 so that a checkpoint of fp32 params and both Adam moments stays
   ~8 GB; layer 0 full remat, layer 1 dots_saveable) through
   ``cli.train.train``: 6 steps from ``--data_path`` with a valid-split
   eval every 3 steps (2 batches) and a final test eval, saving at 3 and
   6; then resumes from 3 to 6 under ``torch.use_deterministic_algorithms``
   (both runs). It checks that every batch the prefetch thread copied to
   the card equals the one the stream yielded, that the restored state's
   digests (of the file's bytes and of the state on the card) equal the
   saved ones, that the batches after the resume equal the first run's and
   that the resumed losses equal the first run's bit for bit
   (TOL_RESUME_LOSS); that a NaN planted in one step's loss (a resumed run
   from step 6, through ``FaultHooks``) is skipped with every parameter,
   moment and the Adam count bitwise unchanged; and that ``cli serve
   --load`` serves 4 requests from the checkpoint, its first prefill's
   logits within TOL_DECODE of the trained model's forward. The launch
   counts are exact: each train step 2 x (2 + 2) forward and 2 x 2
   backward; each eval pass 2 batches x 2 layers of the forward and no
   backward; serve 2 layers x prefills; every launch ``wgmma``. Prints the
   bytes and seconds of save and load; the step data and the corpus stay
   for phase 15, which deletes them (the manifests stay under
   chiprun_out/phase10; the script deletes the rest on any failure too).
11. Pipelines on the card: the LLaMA configuration of phase 8 with the
   global batch in 4 micro-batches and its remat counts laid out alike on
   both stages (per stage full, full, dots_saveable, none: GPipe needs
   stage-uniform strategies), at pp 2 divided 4,4, as a world of 2
   whose two stages this one process hosts
   (``parallel.pipeline.LocalTransport``), through the model API as ``cli
   train`` steps it (guard on, the same synthetic batches): 6 steps under
   GPipe and 6 under 1F1B, each step's loss within TOL_PP_LOSS and its
   gradient norm (before the clip) within TOL_PP_GRAD_NORM, relative, of
   the same configuration unpipelined (pp 1, the same weights, batches and
   micro-batches); then the GPT configuration of phase 9 divided 5,3 under
   1F1B (its tied table on both stages, summed through the transport), 3
   steps against its unpipelined run. Every run's launch counts are exact
   (steps x micro-batches x (layers + remat layers) forward, x layers
   backward: the pipeline keeps each micro-batch's graph under the
   per-layer remat, as the unpipelined run does) and every launch is
   ``wgmma``; each run's peak memory is printed. A planted fault, the
   1F1B run again with stage 1's weights put back after every step, must
   fail the same comparison. The host runs the stages one after another,
   so these step times say nothing of the bubble.
12. Galvatron's loop on the card, through the CLI entry points, on phase
   8's model (LLaMA-7B width, depth 8, seq 2048, bf16): ``cli profile``
   (static mode, batch 8, layers 1 and 3, the remat fractions; the
   allocator's and autograd's activation counts side by side; its flash
   launches must equal what the differencing programs call for, all
   ``wgmma``), ``cli profile-hardware`` at world 1 (the overlap file, no
   all-reduce file), ``cli search`` at world 1 for global batch 8 in 2
   micro-batches under LOOP_MEMORY_GB (the search must return a strategy
   that checkpoints some layers and not all), ``cli train`` under the
   emitted JSON for 6 steps (the train CLI's strategy must be the searched
   one, the loss must fall, the launches must be exact and ``wgmma``, the
   peak must stay under the budget), then ``profiler.validate``'s
   predicted against measured step ms and peak GB, with their ratios.

13. Long context on the card: ``ops/ring_attention.py`` through
   ``LocalRing`` (the one card hosts every cp rank's shards; a hop is a
   copy on the card), LLaMA-7B's 32 heads of 128, bf16, B=1, causal, cp 2
   and 4, zigzag and ring, with and without a key-padding tail (the
   cotangent zero on padded queries: the model uses no padded output),
   one ring forward and one ring backward per case. At S=32768 (LC_SEQ)
   the output, the merged logsumexp and dq/dk/dv are held against the
   unsharded flash kernels on the same sequence (the backward kernel fed
   the unsharded forward's own output and logsumexp); at S=8192
   (LC_PLAIN_SEQ) against the plain ring version (its forward, and its
   hand-written backward with the backward kernel's roundings, fed the
   ring's merged output and logsumexp as phase 4 feeds the kernel's to
   both backwards; those are held against the plain forward's); the
   output on every row,
   the logsumexp and gradients on the valid rows, with the row-scaled
   limits, TOL_LSE and planted faults of phases 3-4. Each ring pass
   launches each kernel exactly once per step and rank under zigzag (16
   at cp 4) and
   r + 1 times on rank r under ring, all on the ``wgmma`` route; those
   launches form the ``long_context`` path. At S=32768 the ring's forward
   and backward (every rank's blocks, the merges and the hops, summed) are
   timed beside the unsharded kernels': the zigzag blocks cover the same
   causal work, so the ratio is the decomposition's overhead. Phases 3-4
   also check and time the blocks a cp 4 zigzag step gives the kernels
   (RING_BLOCK_ROWS): causal 8192 and 4096, non-causal 8192x4096 and
   4096x8192, and key segment ids that differ from the query ones.

14. The encoder families at published size and full depth
   (``tools/train_cell.py``), through ``cli.train.main``: BERT-large (24
   layers, sequence 512, post-norm, tied MLM head) 6 steps at global batch
   32 in 2 micro-batches, every layer plain dp, then again with layers
   0-11 ZeRO-3 and the rest ZeRO-2 (each step's loss within
   TOL_LAYOUT_LOSS relative of the first run's); ViT-huge (32 layers, 197
   positions, 1000 classes) 6 steps at global batch 64 in 2 micro-batches
   from a vision shard of 512 seeded uint8 images that
   ``write_vision_dataset`` writes (~77 MB, deleted afterwards). Neither
   takes a flash kernel (head_dim 64 and 80; 197 positions): each run must
   launch none. Gradients: BERT-large and ViT-huge width at depth 2, one
   micro-batch (BERT 2 x 512 with a key-padding tail and token types; ViT
   2 images), the loss and every parameter's gradient on the card (bf16)
   against the port on the CPU (fp32) from the same weights, per parameter
   ||g - g_cpu|| / ||g_cpu|| <= TOL_ENCODER_GRAD_REL, the loss within
   TOL_ENCODER_LOSS. Then ``tools/profile_train.py --cell bert`` traces
   two steady BERT steps: the plain attention's device share of a step.
15. Elastic resume on one card, from phase 10's step-3 checkpoint
   (LLaMA-7B width, depth 2, world 1, pp 1, ~8 GB): the same configuration
   resumed plainly through the model API (the reference: 6 steps, 3-8);
   then a pp 2 1F1B strategy, one layer a stage, both stages hosted by
   this process, restores it across strategies (``load_checkpoint(...,
   target=, allow_cross=True)``: the restored params, both moments and the
   count, gathered one leaf at a time and cut again under the saved
   strategy, reproduce the manifest's sha256 records; the restore's device
   memory beyond the live state stays under four of the largest leaf) and
   trains steps
   3-5, each step's loss and gradient norm within TOL_PP_LOSS /
   TOL_PP_GRAD_NORM of the reference's, and saves at step 6 (one file per
   stage rank); ``cli train --elastic resume --elastic_strategy`` restores
   that pp 2 checkpoint under pp 1 (world 2 -> 1) and trains steps 6-8
   within TOL_PP_LOSS of the reference; ``cli train --elastic search`` at
   world 1 under ELASTIC_BUDGET_GB (a budget under which the search must
   remat) restores it under the searched plan, whose estimated memory must
   fit, and trains 2 steps. Launch counts are exact on every run; restore
   seconds and the host's peak resident memory during each restore are
   printed.
16. The encoder-decoder and hierarchical families at published size and
   full depth (``tools/train_cell.py``), through ``cli.train.main``:
   T5-large (24 + 24 layers, d_model 1024, vocab 32128, tied) 6 steps at
   global batch 32 in 4 micro-batches, encoder and decoder 512 tokens,
   from span-corrupted windows of a seeded corpus (deleted afterwards; the
   encoder streams end in key padding), every layer plain dp, then with
   the encoder ZeRO-3 and the decoder ZeRO-2 (each step's loss within
   TOL_LAYOUT_LOSS relative of the first run's), then pp 2 1F1B (an
   encoder stage and a decoder stage, both hosted by this process) within
   TOL_PP_LOSS of the pp 1 run; Swin-large (224, window 7, depths
   2/2/18/2) 6 steps at global batch 64 in 2 micro-batches from the
   512-image shard, then pp 2 1F1B divided 12/12 (the boundary inside Swin
   stage 2) within TOL_PP_LOSS of it. Neither takes a flash kernel (T5's
   attention always has a relative bias; Swin's window attention is
   inline): every run must launch none. Gradients at full width cut in
   depth (T5 one encoder and one decoder layer, 2 x 512 tokens with a
   key-padding tail; Swin depths 2/1/1/1, a shifted block and every merge,
   2 images): card (bf16) against the CPU (fp32), per parameter within
   TOL_ENCODER_GRAD_REL, the loss within TOL_ENCODER_LOSS. Then
   ``tools/profile_train.py --cell t5`` traces one steady T5-large step
   (one micro-batch of 8).
17. A fine-tuning user's path from a published checkpoint, at full width
   (nothing downloaded: the config.json is written from the published
   numbers, the weights are seeded port parameters rounded to bf16 and
   exported with ``export_hf_llama`` to a bf16 model.safetensors through
   the port's own writer): LLaMA-7B (num_hidden_layers cut from 32 to 2) ->
   ``tools.convert_checkpoint h2g`` (its params-only step 0 equal to the
   seeded params bit for bit) -> a seeded text corpus through
   ``tools.tokenize_corpus --tokenizer bytes --append-eod`` -> ``cli train
   --load`` 3 steps at phase 8's batch (its losses, under deterministic
   algorithms, bit for bit those of the same run started from the
   in-memory params: a fresh optimizer), saving -> ``cli serve --load`` 4
   requests -> g2h of
   step 0 (the HF file's tensors back bit for bit) and of the trained step;
   T5-large (24 + 24 layers) export -> h2g -> ``cli train --load`` 2 steps
   on span-corrupted windows of the same corpus -> g2h (bitwise), with no
   flash launch; then T5-large width, one encoder and one decoder layer on
   T5_SEQ tokens with a key-padding tail: cp 2 and cp 4 (zigzag order) and
   Ulysses 2 and 4 with every rank played by this process
   (``models.t5.LocalSeq``), forward and backward against the unsharded
   layers, per tensor within TOL_T5_SEQ_REL, times beside the unsharded
   time, no flash launch. The seconds of each step and the host's peak RSS
   are printed. Files go to build/phase17 (~25 GB at most), deleted after.
   The LLaMA part runs at depth 2 (phase 10's strategy; depth 8 until the
   resilience slice, cut to keep the script within its time).
18. Resilience (``runtime/health.py``, ``runtime/sdc.py``,
   ``runtime/elastic.migrate``, ``runtime/autotune.py``): (a) the
   silent-corruption sentinel's fold kernel (``csrc/tree_fold.cu``)
   against its plain version on the card, bitwise, on leaves of fp32,
   bf16, fp16, fp64, int32, int64, uint8 and bool at odd lengths, an empty
   leaf, all of them as one tree, and the LLaMA-7B-width depth-8 parameter
   tree (a planted bit flip must change the fold), timed there beside its
   bound (bytes / 3.35 TB/s), its plain version and two library
   reductions over the same bytes; (b) phase 8's configuration for 4 steps
   through ``cli.train.main`` with and without ``--sdc_check digest``
   (deterministic algorithms): losses bitwise equal, one fold launch per
   step, the step time of each; (c) a subprocess
   (``tests/torch_fault_injection.py --scenario hang``, one full-width
   LLaMA-7B layer, vocab 32000) whose step call 4 sleeps 4 s under
   ``--watchdog``: it must fire, escalate, save and exit 3, and ``cli train
   --elastic resume`` here continues from that save; (d) LLaMA-7B width at
   depth 2, layer 0 ZeRO-3 and layer 1 ZeRO-2: SIGUSR1 at step 2 migrates in
   memory to all ZeRO-2 (``--elastic_strategy``), the steps after it bit for
   bit those of the step-2 save resumed under the target (the migration's
   seconds and device memory beyond the live state printed); (e) LLaMA-7B
   width at depth 4, every layer under full remat, ``--autotune apply``:
   one swap to the searched winner and no swap back (predicted and measured
   step printed); (f) ``cli serve`` with ``--watchdog`` on one LLaMA-7B
   layer: a stalled decode tick drains and exits 3, SIGTERM drains and
   exits 0. Each of (b)-(f) is a main path (counts reset before it). Phase
   16's T5 trace records one micro-batch of 8 (the runs' 32 in 4) and phase
   14's BERT trace one step after one warm-up, both cut for time.
19. Serving under a layout and live serve migration (``serve/``,
   ``cli/serve.py``, ``runtime/elastic.py``'s serve half; world > 1 needs
   NCCL between cards: ``tools/serve_cell.py`` on four): (i) phase 7's load
   (LLaMA-7B, 32 layers, bf16) through the engine under its world-1
   layout, uninterrupted, then interrupted after 3 decode ticks by
   ``migrate_to`` onto a freshly built engine whose cache holds 8 pages
   (1024 tokens): the journals that fit are re-prefilled (the forward
   kernel's launches for them exact), the rest shed retryable (at least
   one each); every replayed request's logits held to the uninterrupted
   run's within TOL_REPLAY while its tokens agree, and a replay without its
   journal's last token must fail that; (ii) ``cli search --objective
   serve`` at world 1 (analytic tables) and ``cli serve`` under its plan
   with the mesh probe and ``--migrate_on_degrade 1``: healthy, no
   migration. Each of (i)'s runs and (ii)'s serve is a main path.
20. Observability and lint (``obs/report.py``, ``cli/lint.py``,
   ``analysis/ckpt_lint.py``, the train driver's trace window): (a)
   ``cli train`` at LLaMA-7B width, depth 4 (phase 8's batch, its remat mix
   cut to full, full, dots_saveable, none), 8 steps with ``--telemetry``,
   ``--xla_trace`` over steps 5-6, ``--train_log_dir`` and ``--profile``:
   trace start and stop events and no error, the Chrome trace's flash
   kernel events (forward, dkv, dq) equal to the launch counters' moves
   over steps 5-6 (read before steps 5 and 7 dispatch), one log line per
   iteration, and ``cli report --json`` on the stream exits 0 with a
   steady step within TOL_REPORT_STEP of the driver's summary median, an
   MFU in (0, 1) and one divergence row per layer run (and the head); the
   trace is deleted after it is read; (b) ``cli serve --telemetry`` at
   depth 4, 8 requests: the report's TTFT and TPOT p50 / p99 equal the
   serve summary's, the forward launches layers x prefills; (c) ``cli lint
   --ckpt --deep`` on phase 10's checkpoint, run before phase 15 deletes
   it: exit 0, two fold launches per step (its params, and its params with
   the Adam state); then a depth-1 checkpoint of this phase (under
   build/phase20, deleted after): one byte flipped in its rank file gives
   GLS214 and exit 1 under ``--deep``, its manifest removed GLS210; (d)
   ``cli lint`` on phase 12's searched strategy: clean at 80 GB, GLS101 at
   1 GB (exit 0, 1 under ``--strict``). (a), (b) and each ``--deep`` audit
   are main paths.

Each main path (serve, train, the GPT layout runs, phase 10's train,
resumed, guarded and serve-from-checkpoint runs, phase 11's runs,
phase 12's profile and train, phase 13's ring runs, phase 14's encoder
runs, phase 15's resumed runs, phase 16's T5 and Swin runs, phase 17's
runs from the converted checkpoints, phase 18's and phase 19's runs,
phase 20's traced train and serve runs and ``lint --deep`` audits) runs
with the kernels' launch counts (the flash kernels' and the fold's) set to 0 just
before it and read just after. The last lines
of standard output are the serve and train summaries, the ``kernels`` JSON
line, the card line, and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import math
import os
import random
import signal
import statistics
import subprocess
import sys
import time

SEED = 1234
# kernel vs plain version, elementwise on BSNH tensors:
#   |out - ref| <= row * rowmax|ref| + rel * |ref| + floor * max|ref|
# where rowmax is the largest |ref| in the element's row of head_dim values
# (one query's output or dq, one key's dk or dv). Under the causal mask the
# values fall off along the sequence (a late query's output and dq, a late
# key's dv, are ~1/sqrt(keys or queries seen), down to ~0.004 at S=2048), so
# a bound on the tensor's max would let a late tile be wrong; the row's own
# scale does not, and a planted fault (a zeroed last tile) must fail it.
# bf16: both round p (and ds in the backward) to bf16 before the second
# products, in different summation orders, so a term may round one ulp
# apart (2^-8 relative), ~1e-3 of a row's max after summing; the result
# itself rounds to bf16, up to 2^-7 relative (rel). The floor covers rows
# whose exact value is ~0 (query 0 under the causal mask sees one key, so
# its dq is the fp32 rounding of dp - di, ~1e-7) and sits far below the
# smallest late-tile value. fp32: summation order only.
TOL_FWD_BF16 = dict(row=2e-2, rel=1e-2, floor=1e-4)
TOL_FWD_FP32 = dict(row=1e-4, rel=0.0, floor=1e-5)
TOL_LSE = 1e-3   # fp32 logsumexp, both fp32 math
TOL_BWD_BF16 = dict(row=2e-2, rel=1e-2, floor=1e-4)
TOL_BWD_FP32 = dict(row=1e-4, rel=1e-4, floor=1e-5)
# gradients in place (bf16, LLaMA-7B width, 2 layers): the kernels and the
# plain path round to bf16 at different places (p before P.V and dS before
# dQ/dK in the kernels; the probabilities and every einsum output on the
# plain path), each ~2^-9 relative, and those differences pass through two
# layers' backward and the head: per parameter, ||g - g_plain|| /
# ||g_plain|| <= 5e-2, and the losses (~ln 32000) within 1e-2.
TOL_GRAD_REL = 5e-2
TOL_GRAD_LOSS = 1e-2
# decode vs recompute in bf16 at LLaMA-7B width: every matmul output rounds
# to bf16 (relative 2^-9) and the two paths round in different places; the
# logits have a std of ~1.3 at this init, so 0.15 allows some tens of such
# roundings of drift and still catches a wrong cache column or position.
TOL_DECODE = 0.15
H100_BF16_FLOPS = 989e12   # dense, NVIDIA data sheet (SXM)
H100_FP32_FLOPS = 67e12    # non-tensor fp32
H100_BYTES_PER_S = 3.35e12
REPLACES = "galvatron_tpu/ops/attention.py:82"
SOURCE = "galvatron_tpu_torch/csrc/flash_attn_fwd.cu"
BWD_SOURCE = "galvatron_tpu_torch/csrc/flash_attn_bwd.cu"
TILE = 64  # the kernels' query and key tile rows
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "dkv_wgmma_kernel", "dq_wgmma_kernel")


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


def judge(torch, got, ref, tol):
    """Hold `got` against `ref` (BSNH) at `tol` (see TOL_FWD_BF16):
    (elements over their limit, the largest |got - ref| / limit, the largest
    |got - ref|, the median |ref|)."""
    a = ref.float().abs()
    limit = tol["row"] * a.amax(dim=-1, keepdim=True) + tol["rel"] * a + tol["floor"] * a.max()
    diff = (got.float() - ref.float()).abs()
    return (int((diff > limit).sum().item()), (diff / limit).max().item(), diff.max().item(),
            a.median().item())


def planted_faults(ref):
    """Wrong copies of a BSNH kernel result that the check must refuse: the
    last tile of rows zeroed (the last query tile of an output or dq, the
    last key tile of dk or dv), and the first."""
    late, early = ref.clone(), ref.clone()
    late[:, -TILE:] = 0
    early[:, :TILE] = 0
    return {"last tile zeroed": late, "first tile zeroed": early}


def check_against_plain(torch, name, got, ref, tol, case):
    """Fail unless `got` passes the check and every planted fault fails it;
    returns (max abs err, share of the limit used, median |ref|)."""
    n_bad, used, err, med = judge(torch, got, ref, tol)
    check(n_bad == 0, "%s kernel vs plain: %d elements over %s (max abs err %.3g, %.3g of the "
          "limit, median |ref| %.3g) at %s" % (name, n_bad, tol, err, used, med, case))
    for fault, wrong in planted_faults(ref).items():
        check(judge(torch, wrong, ref, tol)[0] > 0,
              "%s check passes a planted fault (%s) at %s" % (name, fault, case))
    return err, used, med


# ------------------------------------------------------------------ phase 1
def identify_card():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, "nvidia-smi failed: %s" % proc.stderr.strip())
    line = proc.stdout.strip().splitlines()[0].strip()
    return line


# ------------------------------------------------------------------ phase 2
def build_kernels(TF):
    """One nvcc per kernel source (the flash forward and backward, the
    sentinel's tree fold) and the g++ builds of the dataset index
    helper and the search's DP core, all started together; returns {source:
    (library path, seconds)} of the kernels, the ptxas lines of each build
    and the two host libraries' ((path, seconds), (path, seconds))."""
    from concurrent.futures import ThreadPoolExecutor

    from galvatron_tpu_torch.data import dataset as DS
    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.search import dynamic_programming as DP

    def one(build, *src):
        t0 = time.perf_counter()
        so = build(*src)
        return so, time.perf_counter() - t0

    sources = tuple(TF.SOURCES) + (TFold.SOURCE,)
    with ThreadPoolExecutor(len(sources) + 2) as ex:
        helper = ex.submit(one, DS.build)
        dp_core = ex.submit(one, DP.build)
        built = dict(zip(sources, ex.map(lambda src: one(TF.build, src), sources)))
        helper = (helper.result(), dp_core.result())
    ptxas, kernels = {}, {}
    for src, (so, _) in built.items():
        with open(so + ".log") as f:
            lines = [ln.strip() for ln in f]
        # "Compiling entry function X" precedes its register / spill lines
        ptxas[os.path.basename(src)] = [ln for ln in lines if "registers" in ln or "spill" in ln
                                        or "entry function" in ln or "C7508" in ln]
        kernels.update(ptxas_by_kernel(lines))
    return built, ptxas, kernels, helper


def ptxas_by_kernel(lines):
    """{entry function (mangled): {"registers", "spill_stores", "spill_loads",
    "c7508"}} from the lines of an ``nvcc -Xptxas -v`` log."""
    import re

    out, name = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": None, "spill_loads": None,
                         "c7508": False}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
        if "C7508" in ln or "setmaxnreg ignored" in ln:
            out[name]["c7508"] = True
    return out


def gate_wgmma_ptxas(kernels, logs):
    """Fail unless each wgmma kernel compiled with no spill and every
    `setmaxnreg` was honoured (no C7508 anywhere in the logs)."""
    found = {k: v for k, v in kernels.items() if any(w in k for w in WGMMA_KERNELS)}
    check(all(any(w in k for k in found) for w in WGMMA_KERNELS),
          "ptxas lines for the wgmma kernels %s not found (got %s)" % (WGMMA_KERNELS, list(found)))
    for name, info in found.items():
        check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
              "ptxas: %s spills (%s)" % (name, info))
    bad = [ln for lines in logs.values() for ln in lines if "C7508" in ln]
    check(not bad, "ptxas ignored setmaxnreg: %s" % bad)
    return found


# ------------------------------------------------------------------ phase 3
def time_ms(torch, fn, reps=25, warmup=3):
    """Median of `reps` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_stream_ms(torch, fn, calls=20, runs=5):
    """Median over `runs` of `calls` calls back to back between two CUDA
    events, per call: the time once the host's launch overhead runs ahead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def check_route(torch, got, dtype, hd, case):
    """Every bf16 head_dim-128 case runs the wgmma kernels."""
    if dtype == torch.bfloat16 and hd == 128:
        check(got == "wgmma", "route %r, not wgmma, at %s" % (got, case))


def segment_ids(torch, b, s, valid, dev):
    """(B, S) int32 ids: 1 on the first `valid` tokens, 0 on the tail."""
    return (torch.arange(s, device=dev) < valid).to(torch.int32)[None].repeat(b, 1).contiguous()


def sdpa_mask(torch, seg, causal):
    """SDPA's boolean attn_mask (B, 1, Sq, Sk) for the kernels' segment ids
    and causal mask (None without segment ids: SDPA takes is_causal)."""
    if seg is None:
        return None
    mask = seg.q[:, None, :, None] == seg.kv[:, None, None, :]
    if causal:
        sq, sk = mask.shape[-2:]
        mask &= torch.ones((sq, sk), dtype=torch.bool, device=mask.device).tril()
    return mask


def admitted_pairs(torch, sq, sk, q_valid, kv_valid, causal):
    """(query, key) pairs the masks admit, per (batch, head): the work a
    flash kernel must do on these inputs (segment ids 1 on the valid
    prefix of each side, 0 on its tail; causal by index)."""
    qi, ki = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
    ok = (qi < q_valid) == (ki < kv_valid)
    if causal:
        ok &= ki <= qi
    return int(ok.sum().item())


def bound_ms(torch, b, sq, sk, nh, hd, q_valid, kv_valid, causal, dtype, flops_per_dim=4.0,
             per_side=2):
    """Least time on the card: the larger of the operations (flops_per_dim
    * hd per admitted pair and head: 4 for the forward's two products, 10
    for the backward's five) at the dtype's peak, and the bytes of
    per_side BSNH tensors of the query length and as many of the key
    length (each read or written once: q, out / k, v for the forward; q,
    out, dout, dq / k, v, dk, dv for the backward) + lse at the memory
    rate."""
    elem = 2 if dtype == torch.bfloat16 else 4
    flops = (flops_per_dim * hd * admitted_pairs(torch, sq, sk, q_valid, kv_valid, causal)
             * nh * b)
    nbytes = per_side * b * (sq + sk) * nh * hd * elem + 4.0 * b * nh * sq
    if q_valid < sq or kv_valid < sk:
        nbytes += 4.0 * b * (sq + sk)  # q and kv segment ids
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def ring_block_cases(torch):
    """The blocks one ring step hands the kernels at phase 13's sizes
    (RING_BLOCK_ROWS): causal diagonals, non-causal 2c x c and c x 2c
    blocks, and blocks whose key segment ids differ from the query ones
    (the visiting keys of another rank's padded shard)."""
    two, one = RING_BLOCK_ROWS
    cases = [dict(b=1, s=n, nh=32, hd=128, padded=False, causal=True, dtype=torch.bfloat16)
             for n in (two, one)]
    cases += [dict(b=1, s=two, sk=one, nh=32, hd=128, padded=False, causal=False,
                   dtype=torch.bfloat16),
              dict(b=1, s=one, sk=two, nh=32, hd=128, padded=False, causal=False,
                   dtype=torch.bfloat16),
              dict(b=1, s=one, sk=one, nh=32, hd=128, padded=True, kv_valid=one - one // 4,
                   causal=True, dtype=torch.bfloat16),
              dict(b=1, s=one, sk=two, nh=32, hd=128, padded=True, kv_valid=two - two // 4,
                   causal=False, dtype=torch.bfloat16)]
    return cases


def case_inputs(torch, c, gen, dev, n_q):
    """A phase-3/4 case's BSNH tensors (n_q of the query length, then k and
    v), its lengths, valid prefixes and segment ids (None unpadded)."""
    b, s, nh, hd, dtype = c["b"], c["s"], c["nh"], c["hd"], c["dtype"]
    sk = c.get("sk", s)
    q_side = [torch.randn((b, s, nh, hd), generator=gen, device=dev).to(dtype)
              for _ in range(n_q)]
    k, v = (torch.randn((b, sk, nh, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    q_valid = c.get("q_valid", s - s // 8 - 3) if c["padded"] else s
    kv_valid = c.get("kv_valid", q_valid if sk == s else sk - sk // 8 - 3) if c["padded"] else sk
    seg = None
    if c["padded"]:
        from galvatron_tpu_torch.ops.flash_attention import SegmentIds

        seg = SegmentIds(q=segment_ids(torch, b, s, q_valid, dev),
                         kv=segment_ids(torch, b, sk, kv_valid, dev))
    return q_side, k, v, sk, q_valid, kv_valid, seg


def check_kernel(torch, TF, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = []
    for s in (128, 512, 576, 1536, 2048):
        for padded in (False, True):
            cases.append(dict(b=1, s=s, nh=32, hd=128, padded=padded, causal=True,
                              dtype=torch.bfloat16))
    for b in (4, 2, 8):
        cases.append(dict(b=b, s=2048, nh=32, hd=128, padded=False, causal=True,
                          dtype=torch.bfloat16))
    cases.append(dict(b=1, s=576, nh=32, hd=128, padded=True, causal=False, dtype=torch.bfloat16))
    cases.append(dict(b=1, s=512, nh=32, hd=128, padded=True, causal=False, dtype=torch.bfloat16))
    cases.append(dict(b=1, s=512, nh=32, hd=128, padded=True, causal=True, dtype=torch.float32))
    cases.append(dict(b=1, s=512, nh=8, hd=256, padded=True, causal=True, dtype=torch.bfloat16))
    cases += ring_block_cases(torch)
    results = []
    for c in cases:
        b, s, nh, hd, dtype, causal = c["b"], c["s"], c["nh"], c["hd"], c["dtype"], c["causal"]
        (q,), k, v, sk, valid, kv_valid, seg = case_inputs(torch, c, gen, dev, 1)
        scale = hd ** -0.5
        out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=scale, segment_ids=seg)
        torch.cuda.synchronize()
        route = TF.flash_attention_fwd.last_route
        check_route(torch, route, dtype, hd, c)
        ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=scale,
                                                        segment_ids=seg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), "kernel output not finite at %s" % c)
        tol = TOL_FWD_BF16 if dtype == torch.bfloat16 else TOL_FWD_FP32
        err, used, med = check_against_plain(torch, "forward", out, ref, tol, c)
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= TOL_LSE, "kernel lse err %.3g > %.3g at %s" % (lse_err, TOL_LSE, c))
        call = lambda: TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=scale,  # noqa: E731
                                              segment_ids=seg)
        single, kernel = time_ms(torch, call), time_stream_ms(torch, call)
        plain = time_ms(torch, lambda: TF.flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=scale, segment_ids=seg),
            reps=21 if b == 1 and s * sk <= 2048 * 2048 else 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(torch, seg, causal)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale)
        library_single, library = time_ms(torch, sdpa), time_stream_ms(torch, sdpa)
        bms, by, flops = bound_ms(torch, b, s, sk, nh, hd, valid, kv_valid, causal, dtype)
        r = dict(shape=[b, s, nh, hd], kv_len=sk, dtype=str(dtype).replace("torch.", ""),
                 causal=causal, valid_len=valid, kv_valid_len=kv_valid, route=route,
                 max_abs_err=err, limit_used=used,
                 median_abs_ref=med, lse_err=lse_err, tolerance=tol, ms=kernel, ms_single=single,
                 plain_ms=plain, library_ms=library, library_ms_single=library_single,
                 bound_ms=bms, bound_by=by, gflop=flops / 1e9, tflops=flops / kernel / 1e9)
        results.append(r)
        log("flash B=%d S=%d%s nh=%d hd=%d %s %s%s [%s]: err %.3g (%.2f of the limit, median "
            "|ref| %.3g) lse %.3g | kernel %.4f ms (single calls %.4f), plain %.3f ms, sdpa "
            "%.4f/%.4f ms, bound %.4f ms (%s), %.1f TFLOP/s" % (
                b, s, "" if sk == s else "x%d" % sk, nh, hd, r["dtype"],
                "padded" if c["padded"] else "full",
                "" if causal else " non-causal", route, err, used, med, lse_err,
                kernel, single, plain,
                library, library_single, bms, by,
                r["tflops"]))
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 4
def check_bwd_kernel(torch, TF, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    cases = [dict(b=1, s=s, nh=32, hd=128, padded=padded, dtype=torch.bfloat16)
             for s in (512, 576, 2048) for padded in (False, True)]
    for b in (4, 2, 8):
        cases.append(dict(b=b, s=2048, nh=32, hd=128, padded=False, dtype=torch.bfloat16))
    cases.append(dict(b=1, s=512, nh=32, hd=128, padded=True, dtype=torch.float32))
    cases.append(dict(b=1, s=512, nh=8, hd=256, padded=True, dtype=torch.bfloat16))
    cases += ring_block_cases(torch)
    results = []
    for c in cases:
        b, s, nh, hd, dtype, causal = (c["b"], c["s"], c["nh"], c["hd"], c["dtype"],
                                       c.get("causal", True))
        (q, do), k, v, sk, valid, kv_valid, seg = case_inputs(torch, c, gen, dev, 2)
        scale = hd ** -0.5
        out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=scale, segment_ids=seg)
        got = TF.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, sm_scale=scale,
                                     segment_ids=seg)
        torch.cuda.synchronize()
        route = TF.flash_attention_bwd.last_route
        check_route(torch, route, dtype, hd, c)
        want = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                                sm_scale=scale, segment_ids=seg)
        torch.cuda.synchronize()
        tol = TOL_BWD_BF16 if dtype == torch.bfloat16 else TOL_BWD_FP32
        errs, used, med = {}, {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(bool(torch.isfinite(g.float()).all()), "backward %s not finite at %s" % (name, c))
            errs[name], used[name], med[name] = check_against_plain(
                torch, "backward " + name, g, w, tol, c)
        args = (q, k, v, out, lse, do)
        kw = dict(causal=causal, sm_scale=scale, segment_ids=seg)
        call = lambda: TF.flash_attention_bwd(*args, **kw)  # noqa: E731
        single, kernel = time_ms(torch, call), time_stream_ms(torch, call)
        plain = time_ms(torch, lambda: TF.flash_attention_bwd_reference(*args, **kw),
                        reps=11 if b == 1 and s * sk <= 2048 * 2048 else 3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        mask = sdpa_mask(torch, seg, causal)
        lo = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale)
        dot = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,  # noqa: E731
                                               retain_graph=True)
        library_single, library = time_ms(torch, sdpa_bwd), time_stream_ms(torch, sdpa_bwd)
        del qt, kt, vt, lo, mask
        bms, by, flops = bound_ms(torch, b, s, sk, nh, hd, valid, kv_valid, causal, dtype, 10.0,
                                  4)
        r = dict(shape=[b, s, nh, hd], kv_len=sk, dtype=str(dtype).replace("torch.", ""),
                 causal=causal, valid_len=valid, kv_valid_len=kv_valid, route=route,
                 max_abs_err=max(errs.values()),
                 max_abs_err_by_grad=errs, limit_used_by_grad=used, median_abs_ref_by_grad=med,
                 tolerance=tol, ms=kernel, ms_single=single, plain_ms=plain,
                 library_ms=library, library_ms_single=library_single, bound_ms=bms, bound_by=by,
                 gflop=flops / 1e9, tflops=flops / kernel / 1e9)
        results.append(r)
        log("flash bwd B=%d S=%d%s nh=%d hd=%d %s %s%s [%s]: err dq/dk/dv %.3g/%.3g/%.3g (of "
            "the limit: %.2f/%.2f/%.2f; median |ref| %.3g/%.3g/%.3g) | kernel %.4f ms (single "
            "calls %.4f), plain %.3f ms, sdpa bwd %.4f/%.4f ms, bound %.4f ms (%s), "
            "%.1f TFLOP/s" % (
                b, s, "" if sk == s else "x%d" % sk, nh, hd, r["dtype"],
                "padded" if c["padded"] else "full", "" if causal else " non-causal", route,
                errs["dq"],
                errs["dk"], errs["dv"], used["dq"], used["dk"], used["dv"], med["dq"],
                med["dk"], med["dv"], kernel, single, plain,
                library, library_single, bms, by,
                r["tflops"]))
        del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 5
def grads_in_place(torch, TF, dev):
    """One lm_loss_fn + backward at LLaMA-7B width, depth 2, through the
    kernels, against the plain attention path on the same weights and
    tokens."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import base as M
    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.runtime.dataloader import RandomTextDataset, prepare_batch
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    cfg = llama_config("llama-7b", num_layers=2, compute_dtype=torch.bfloat16)
    params = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, 2),
                                             dev).init_params(SEED)[0]
    tokens = RandomTextDataset(cfg.vocab_size, cfg.max_seq_len, seed=SEED).batch(0, 1)
    batch = prepare_batch(None, tokens, device=dev)

    def loss_and_grads(c):
        for p in params.parameters():
            p.grad = None
        loss = M.lm_loss_fn(params, batch, c)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad for n, p in params.named_parameters()}

    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    loss_k, grads_k = loss_and_grads(cfg)
    launched = (TF.flash_attention_fwd.launches - n_fwd, TF.flash_attention_bwd.launches - n_bwd)
    check(launched == (2, 2), "gradients in place: kernels launched %s times, expected (2, 2)"
          % (launched,))
    for p in params.parameters():
        p.grad = None
    grads_k = {n: g.clone() for n, g in grads_k.items()}
    loss_p, grads_p = loss_and_grads(dataclasses.replace(cfg, attn_impl="xla"))
    rel = {n: ((grads_k[n].float() - grads_p[n].float()).norm()
               / grads_p[n].float().norm().clamp(min=1e-30)).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    log("gradients in place (llama-7b width, 2 layers, bf16, 2048 tokens): loss %.5f kernels vs "
        "%.5f plain; per-parameter relative gradient error max %.3g (%s), median %.3g (tol %.2g)"
        % (loss_k, loss_p, rel[worst], worst, sorted(rel.values())[len(rel) // 2], TOL_GRAD_REL))
    check(math.isfinite(loss_k) and abs(loss_k - loss_p) <= TOL_GRAD_LOSS,
          "gradients in place: loss %.5f vs plain %.5f" % (loss_k, loss_p))
    check(all(math.isfinite(v) for v in rel.values()) and rel[worst] <= TOL_GRAD_REL,
          "gradients in place: %s relative error %.3g > %.2g" % (worst, rel[worst], TOL_GRAD_REL))
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    return dict(loss_kernels=loss_k, loss_plain=loss_p, rel_err=rel, max_rel_err=rel[worst],
                worst=worst, tolerance=TOL_GRAD_REL, loss_tolerance=TOL_GRAD_LOSS)


# ------------------------------------------------------------------ phase 6
def decode_vs_recompute(torch, dev):
    import numpy as np

    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import base as M
    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.serve.engine import ServeEngine
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, bucket_pages

    cfg = llama_config("llama-7b", num_layers=4, compute_dtype=torch.bfloat16)
    model = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, 4), dev)
    params = model.init_params(SEED)[0]
    kv = KVCacheConfig(max_slots=2, page_size=128, max_pages=4)
    engine = ServeEngine(cfg, params, kv, device=dev)
    plain_cfg = dataclasses.replace(cfg, attn_impl="xla")
    rnd = random.Random(SEED)
    prompt = [rnd.randrange(cfg.vocab_size) for _ in range(300)]

    def recompute(tokens):
        with torch.inference_mode():
            x = torch.tensor([tokens], device=dev)
            return M.model_forward(params, x, None, plain_cfg)[0, -1].float().cpu().numpy()

    tok, logits = engine.prefill(prompt, 0)
    ref = recompute(prompt)
    errs = [float(np.abs(logits - ref).max())]
    agree = [int(np.argmax(logits)) == int(np.argmax(ref))]
    seq = prompt + [tok]
    cur = np.array([tok, 0], np.int32)
    active = np.array([True, False])
    for _ in range(4):
        pages = bucket_pages(len(seq) - 1, kv.page_size, kv.max_pages)
        nxt, lg = engine.decode_step(cur, active, pages)
        ref = recompute(seq)
        check(bool(np.isfinite(lg[0]).all()), "decode logits not finite")
        errs.append(float(np.abs(lg[0] - ref).max()))
        agree.append(int(np.argmax(lg[0])) == int(np.argmax(ref)))
        seq.append(int(nxt[0]))
        cur[0] = nxt[0]
    log("decode vs recompute (llama-7b width, 4 layers, bf16): max abs logit err per step %s "
        "(tol %.2f), greedy agreement %d/%d, logit std %.3f"
        % (["%.4f" % e for e in errs], TOL_DECODE, sum(agree), len(agree), float(ref.std())))
    check(max(errs) <= TOL_DECODE, "decode vs recompute err %.4f > %.2f" % (max(errs), TOL_DECODE))
    del engine, params, model
    torch.cuda.empty_cache()
    return dict(max_abs_err_per_step=errs, tolerance=TOL_DECODE, greedy_agree=sum(agree),
                steps=len(agree), logit_std=float(ref.std()))


# ------------------------------------------------------------------ phase 7
SERVE_ARGV = [
    "--model_type", "llama", "--model_size", "llama-7b", "--mixed_precision", "bf16",
    "--device", "cuda", "--serve_max_concurrency", "8", "--serve_page_size", "128",
    "--num_requests", "16", "--prompt_len_min", "100", "--prompt_len_max", "1500",
    "--max_new_tokens", "32", "--rate_rps", "0", "--seed", str(SEED),
]


def serve(torch, TF):
    import numpy as np

    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.serve import engine as E

    seen = {"prefills": 0, "prefill_ms": [], "decode_ms": [], "nonfinite": 0, "engine": None}

    class CheckedEngine(E.ServeEngine):
        """The engine cli.serve builds, recording finiteness and timings."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["engine"] = self

        def prefill(self, prompt, slot):
            t0 = time.perf_counter()
            tok, logits = super().prefill(prompt, slot)
            seen["prefill_ms"].append(((time.perf_counter() - t0) * 1e3, len(prompt)))
            seen["prefills"] += 1
            seen["nonfinite"] += int(not np.isfinite(logits).all())
            return tok, logits

        def decode_step(self, tokens, active, pages):
            t0 = time.perf_counter()
            nxt, logits = super().decode_step(tokens, active, pages)
            seen["decode_ms"].append(((time.perf_counter() - t0) * 1e3, int(pages)))
            seen["nonfinite"] += int(not np.isfinite(logits[np.asarray(active)]).all())
            return nxt, logits

    orig = E.ServeEngine
    E.ServeEngine = CheckedEngine
    try:
        torch.cuda.reset_peak_memory_stats()
        TF.flash_attention_fwd.launches = 0
        summary = cli_serve.main(SERVE_ARGV)
        launches = TF.flash_attention_fwd.launches
    finally:
        E.ServeEngine = orig
    shed = summary["shed"]
    check(summary["requests"] == 16 and shed == 0,
          "served %d of 16 requests, shed %d (%s)" % (summary["requests"], shed,
                                                      summary["shed_by_reason"]))
    check(seen["nonfinite"] == 0, "%d steps returned non-finite logits" % seen["nonfinite"])
    n_layers = len(seen["engine"].params.layers)
    check(n_layers == 32, "served %d layers, expected 32" % n_layers)
    check(launches == n_layers * seen["prefills"],
          "flash kernel launched %d times, expected %d layers x %d prefills"
          % (launches, n_layers, seen["prefills"]))

    # the fp32 -> bf16 weight casts one decode tick performs (every layer
    # kernel and the lm head; the embedding is gathered before its cast)
    params = seen["engine"].params
    weights = [p for n, p in params.named_parameters()
               if n.endswith("kernel")]
    n_elem = sum(p.numel() for p in weights)
    with torch.inference_mode():
        cast_ms = time_ms(torch, lambda: [p.to(torch.bfloat16) for p in weights], reps=5, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode = [ms for ms, _ in seen["decode_ms"][1:]]
    out = dict(summary=summary, flash_launches=launches, prefills=seen["prefills"],
               layers=n_layers, weight_cast_ms_per_tick=cast_ms,
               weight_cast_gb_per_tick=n_elem * 6 / 1e9,
               decode_tick_ms_median=statistics.median(decode) if decode else None,
               prefill_ms=seen["prefill_ms"], decode_ms=seen["decode_ms"],
               peak_memory_gb=peak_gb)
    del params, weights
    seen.clear()
    return out


# ------------------------------------------------------------------ phase 8
def train(torch, TF):
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.tools import train_cell as C

    argv = C.argv(C.write_strategy("chiprun_out"))
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    summary = cli_train.main(argv)
    fwd, bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    losses = summary["losses"]
    check(len(losses) == C.STEPS and all(math.isfinite(x) for x in losses),
          "train losses %s" % losses)
    remat = sum(C.CHECKPOINT)  # every remat layer's forward runs again in the backward
    want_fwd = C.STEPS * C.CHUNKS * (C.LAYERS + remat)
    want_bwd = C.STEPS * C.CHUNKS * C.LAYERS
    check((fwd, bwd) == (want_fwd, want_bwd),
          "train launched the forward kernel %d times (expected %d = %d steps x %d chunks x "
          "(%d layers + %d recomputed)) and the backward %d times (expected %d)"
          % (fwd, want_fwd, C.STEPS, C.CHUNKS, C.LAYERS, remat, bwd, want_bwd))
    check(summary["flash_routes"] == [{"fwd": {"wgmma": fwd}, "bwd": {"wgmma": bwd}}],
          "train launches by route: %s (every one must be wgmma)" % summary["flash_routes"])
    torch.cuda.empty_cache()
    return dict(summary=summary, fwd_launches=fwd, bwd_launches=bwd, layers=C.LAYERS,
                steps=C.STEPS, chunks=C.CHUNKS, global_bsz=C.GLOBAL_BSZ,
                checkpoint=C.CHECKPOINT, remat_policy=C.REMAT_POLICY,
                remat=",".join(p if c else "none" for c, p in zip(C.CHECKPOINT, C.REMAT_POLICY)))


# ------------------------------------------------------------------ phase 9
# At world 1 every group has one rank, so a collective that scales by the
# group size (a reduce-scatter in place of a split, a sum over the wrong
# axes) scales by 1 here: the two runs agreeing shows that the ZeRO-3 and
# ZeRO-2 code runs on the card through NCCL, not that its gradients are
# right. Layout correctness is held by tests/test_torch_parallel.py
# (world 2 and 4 against the JAX package, on gloo or on GPUs over NCCL).
TOL_LAYOUT_LOSS = 1e-3  # relative, ZeRO-3 vs ZeRO-2 runs of one model (bf16)


def train_gpt_layouts(torch, TF):
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.tools import train_cell as C

    runs = {}
    for fsdp in (True, False):
        argv = C.gpt_argv(C.write_gpt_strategy("chiprun_out", fsdp=fsdp))
        torch.cuda.empty_cache()
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        summary = cli_train.main(argv)
        runs["zero3" if fsdp else "zero2"] = dict(
            summary=summary, fwd_launches=TF.flash_attention_fwd.launches,
            bwd_launches=TF.flash_attention_bwd.launches, routes=summary["flash_routes"])
        check(len(summary["losses"]) == C.STEPS
              and all(math.isfinite(x) for x in summary["losses"]),
              "gpt layout run (fsdp=%d) losses %s" % (fsdp, summary["losses"]))
    on, off = runs["zero3"], runs["zero2"]
    rel = [abs(a - b) / abs(b) for a, b in zip(on["summary"]["losses"], off["summary"]["losses"])]
    check(max(rel) <= TOL_LAYOUT_LOSS,
          "gpt ZeRO-3 vs ZeRO-2 losses differ by %.3g relative (tol %.0e): %s vs %s"
          % (max(rel), TOL_LAYOUT_LOSS, on["summary"]["losses"], off["summary"]["losses"]))
    remat = sum(C.CHECKPOINT)
    want_fwd = C.STEPS * C.CHUNKS * (C.LAYERS + remat)
    want_bwd = C.STEPS * C.CHUNKS * C.LAYERS
    for name, r in runs.items():
        check((r["fwd_launches"], r["bwd_launches"]) == (want_fwd, want_bwd),
              "gpt %s run launched the forward kernel %d times (expected %d) and the backward "
              "%d times (expected %d)" % (name, r["fwd_launches"], want_fwd, r["bwd_launches"],
                                          want_bwd))
        check(r["routes"] == [{"fwd": {"wgmma": want_fwd}, "bwd": {"wgmma": want_bwd}}],
              "gpt %s run's launches by route: %s (every one must be wgmma)" % (name, r["routes"]))
    torch.cuda.empty_cache()
    return dict(runs=runs, loss_rel_err=rel, tolerance=TOL_LAYOUT_LOSS, layers=C.LAYERS,
                steps=C.STEPS, chunks=C.CHUNKS, global_bsz=C.GLOBAL_BSZ, fsdp=C.GPT_FSDP,
                remat=",".join(p if c else "none" for c, p in zip(C.CHECKPOINT, C.REMAT_POLICY)),
                fwd_launches=on["fwd_launches"], bwd_launches=on["bwd_launches"])


# ----------------------------------------------------------------- phase 10
# LLaMA-7B width at depth 2 (cut from 32 so that a checkpoint of fp32
# params and both Adam moments stays ~8 GB), the train cell's batch and
# sequence, layer 0 under full remat and layer 1 under dots_saveable
CORPUS_DOCS = 4000
CORPUS_LEN = (256, 4096)  # document lengths, uniform
CKPT_LAYERS = 2
CKPT_CHECKPOINT = [1, 1]
CKPT_REMAT = ["full", "dots_saveable"]
CKPT_STEPS = 6
CKPT_INTERVAL = 3
EVAL_ITERS = 2
NAN_STEP = CKPT_STEPS  # the planted NaN: the first step after a resume from the end
SERVE_LOAD_REQUESTS = 4
# the losses of the resumed steps against the uninterrupted run's: under
# torch.use_deterministic_algorithms every op of the step has a
# deterministic path on this card, and the kernels have no atomics, so the
# losses must agree bit for bit (0.0); the check allows no difference
TOL_RESUME_LOSS = 0.0


def _phase10_argv(strategy, corpus, extra):
    return [
        "--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
        "--num_layers", str(CKPT_LAYERS), "--mixed_precision", "bf16", "--device", "cuda",
        "--global_train_batch_size", "8", "--chunks", "2", "--galvatron_config_path", strategy,
        "--lr", "1e-4", "--lr_warmup_iters", "2", "--seed", str(SEED), "--data_path", corpus,
    ] + list(extra)


def corpus_checkpoint_resume(torch, TF):
    """Train from a corpus with eval and checkpoints, resume, plant a NaN
    step, serve from the checkpoint (see the module note, phase 10)."""
    import hashlib
    import shutil
    import warnings

    import numpy as np

    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.data import dataset as DS
    from galvatron_tpu_torch.models import base as M
    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.runtime import checkpoint as CK
    from galvatron_tpu_torch.runtime.resilience import FaultHooks
    from galvatron_tpu_torch.serve import engine as E

    out = os.path.join("chiprun_out", "phase10")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    helper = DS.build()  # built in phase 2
    rng = np.random.RandomState(SEED)
    docs = [rng.randint(0, 32000, n).astype(np.int32)
            for n in rng.randint(CORPUS_LEN[0], CORPUS_LEN[1] + 1, CORPUS_DOCS)]
    corpus = os.path.join(out, "corpus")
    DS.write_indexed_dataset(corpus, docs)
    indexed = DS.IndexedDataset(corpus)
    split_tokens = {k: int(indexed.doc_lens[v].sum())
                    for k, v in DS.split_doc_ids(indexed.n_docs, "969,30,1").items()}
    check(split_tokens["test"] > 2049, "test split holds %d tokens" % split_tokens["test"])
    corpus_mb = os.path.getsize(corpus + ".bin") / 1e6
    corpus_s = time.perf_counter() - t0
    strategy = os.path.join(out, "strategy.json")
    with open(strategy, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": "1,1", "tp_consecutive_flags": "1,1",
                   "dp_types_enc": "0,0", "checkpoint": ",".join(map(str, CKPT_CHECKPOINT)),
                   "remat_policy": ",".join(CKPT_REMAT), "global_bsz": 8, "chunks": 2}, f)
    ck = os.path.join(out, "ckpt")

    def run(extra, hooks=None):
        args = cli_train.initialize_galvatron(argv=_phase10_argv(strategy, corpus, extra),
                                              mode="train")
        args.fault_hooks = hooks
        torch.cuda.empty_cache()
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        summary = cli_train.train(args)
        return summary, (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)

    def batch_hooks(record, first_step=None):
        """Record each global batch the stream yields (a digest per step and
        a CPU copy), and hold the batch each step receives on the card —
        copied there by the prefetch thread on its own stream — against the
        CPU copy of the same step. `first_step(params, opt_state)` runs
        before the first step."""
        pending = []

        def wrap_data(it, start):
            step = start
            for b in it:
                record[step] = hashlib.sha256(b"".join(
                    b[k].numpy().tobytes() for k in sorted(b))).hexdigest()
                pending.append({k: v.clone() for k, v in b.items()})
                yield b
                step += 1

        def wrap_step(fn):
            def step(params, opt_state, batch, *rest):
                want = pending.pop(0)
                same = all(torch.equal(batch[k].cpu(), want[k]) for k in want)
                check(same and set(batch) == set(want),
                      "a prefetched batch differs from the one the stream yielded")
                record["prefetch_checked"] = record.get("prefetch_checked", 0) + 1
                if first_step is not None and record.get("first") is None:
                    record["first"] = first_step(params, opt_state)
                return fn(params, opt_state, batch, *rest)
            return step

        return FaultHooks(wrap_data_iter=wrap_data, wrap_step_fn=wrap_step)

    prev = torch.are_deterministic_algorithms_enabled()
    import torch.utils.deterministic as det
    prev_fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            batches1, batches2 = {}, {}
            s1, l1 = run(["--train_iters", str(CKPT_STEPS), "--eval_interval",
                          str(CKPT_INTERVAL), "--eval_iters", str(EVAL_ITERS), "--save", ck,
                          "--save_interval", str(CKPT_INTERVAL)], batch_hooks(batches1))
            saved = {c["iteration"]: c for c in s1["checkpoint_saves"]}
            check(sorted(saved) == [CKPT_INTERVAL, CKPT_STEPS]
                  and CK.intact_iterations(ck) == [CKPT_INTERVAL, CKPT_STEPS],
                  "saves %s, intact %s" % (sorted(saved), CK.intact_iterations(ck)))
            manifest = CK.read_manifest(ck, CKPT_INTERVAL)
            check(manifest is not None and manifest["items"]["params"]["ranks"][0]["digest"]
                  == saved[CKPT_INTERVAL]["digests"]["params"]["digest"],
                  "manifest of step %d does not hold the saved digests" % CKPT_INTERVAL)
            s2, l2 = run(["--train_iters", str(CKPT_STEPS), "--eval_interval",
                          str(CKPT_INTERVAL), "--eval_iters", str(EVAL_ITERS), "--load", ck,
                          "--load_iteration", str(CKPT_INTERVAL)],
                         batch_hooks(batches2, lambda p, o: CK.state_digests(p[0], o[0])))
        nondet = sorted({str(w.message).split("\n")[0][:160] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(prev)
        det.fill_uninitialized_memory = prev_fill
    restored = s2["checkpoint_restore"]
    on_card = batches2["first"]
    check(restored["iteration"] == CKPT_INTERVAL, "resumed at %s" % restored["iteration"])
    for item in ("params", "opt_state"):
        want = saved[CKPT_INTERVAL]["digests"][item]["digest"]
        check(restored["digests"][item]["digest"] == want and on_card[item]["digest"] == want,
              "%s: restored digest (file %s, on the card %s) != saved %s"
              % (item, restored["digests"][item]["digest"][:12], on_card[item]["digest"][:12],
                 want[:12]))
    resumed_steps = list(range(CKPT_INTERVAL, CKPT_STEPS))
    check(all(batches2[s] == batches1[s] for s in resumed_steps),
          "batches after the resume differ from the first run's")
    check(batches1["prefetch_checked"] == CKPT_STEPS
          and batches2["prefetch_checked"] == len(resumed_steps),
          "prefetched batches checked %s / %s times" % (batches1["prefetch_checked"],
                                                       batches2["prefetch_checked"]))
    loss_diff = [abs(a - b) for a, b in zip(s2["losses"], s1["losses"][CKPT_INTERVAL:])]
    check(len(s1["losses"]) == CKPT_STEPS and len(s2["losses"]) == len(resumed_steps)
          and all(math.isfinite(x) for x in s1["losses"] + s2["losses"]),
          "losses %s / %s" % (s1["losses"], s2["losses"]))
    check(max(loss_diff) <= TOL_RESUME_LOSS,
          "resumed losses %s differ from the first run's %s by %.3g (tol %g)"
          % (s2["losses"], s1["losses"][CKPT_INTERVAL:], max(loss_diff), TOL_RESUME_LOSS))
    check(s2["valid_losses"][-1] == s1["valid_losses"][-1] and s2["test_loss"] == s1["test_loss"],
          "eval after the resume: valid %s / %s, test %s / %s" % (
              s2["valid_losses"], s1["valid_losses"], s2["test_loss"], s1["test_loss"]))

    # launches: train steps, eval passes (forward alone), per run
    per_step = (2 * (CKPT_LAYERS + sum(CKPT_CHECKPOINT)), 2 * CKPT_LAYERS)
    eval_pass = EVAL_ITERS * CKPT_LAYERS
    passes = (CKPT_STEPS // CKPT_INTERVAL + 1, (CKPT_STEPS - CKPT_INTERVAL) // CKPT_INTERVAL + 1)
    train_data = [l1[0] - s1["eval_flash_launches"]["fwd"],
                  l2[0] - s2["eval_flash_launches"]["fwd"]]
    for i, (s, l, n_steps) in enumerate(((s1, l1, CKPT_STEPS), (s2, l2, len(resumed_steps)))):
        check(s["eval_flash_launches"] == {"fwd": passes[i] * eval_pass, "bwd": 0},
              "run %d: eval launched %s, expected fwd %d (%d passes x %d batches x %d layers) "
              "and no bwd" % (i + 1, s["eval_flash_launches"], passes[i] * eval_pass,
                              passes[i], EVAL_ITERS, CKPT_LAYERS))
        check((train_data[i], l[1]) == (n_steps * per_step[0], n_steps * per_step[1]),
              "run %d: train steps launched fwd %d / bwd %d, expected %d / %d" % (
                  i + 1, train_data[i], l[1], n_steps * per_step[0], n_steps * per_step[1]))
        check(s["flash_routes"] == [{"fwd": {"wgmma": l[0]}, "bwd": {"wgmma": l[1]}}],
              "run %d launches by route: %s (every one must be wgmma)" % (i + 1, s["flash_routes"]))

    # the planted NaN: resume from the end, one step whose loss is NaN
    def poison(it, start):
        for i, b in enumerate(it):
            if start + i == NAN_STEP:
                b = dict(b, loss_mask=torch.full(b["tokens"].shape, float("nan")))
            yield b

    snap = {}

    def guarded(fn):
        def step(params, opt_state, batch, *rest):
            # one stage (pp 1): its module and Adam state
            before = {n: p.detach().clone() for n, p in params[0].named_parameters()}
            before.update({"mu/" + n: t.clone() for n, t in opt_state[0].mu.items()})
            before.update({"nu/" + n: t.clone() for n, t in opt_state[0].nu.items()})
            count = opt_state[0].count
            params, opt_state, metrics = fn(params, opt_state, batch, *rest)
            after = dict(params[0].named_parameters())
            after.update({"mu/" + n: t for n, t in opt_state[0].mu.items()})
            after.update({"nu/" + n: t for n, t in opt_state[0].nu.items()})
            snap.update(anomalous=metrics["anomalous"], count=(count, opt_state[0].count),
                        unchanged=all(torch.equal(before[n], after[n]) for n in before),
                        leaves=len(before))
            del before
            return params, opt_state, metrics
        return step

    s3, l3 = run(["--train_iters", str(NAN_STEP + 1), "--load", ck],
                 FaultHooks(wrap_data_iter=poison, wrap_step_fn=guarded))
    check(snap.get("anomalous") is True and snap["unchanged"]
          and snap["count"][0] == snap["count"][1] == CKPT_STEPS,
          "planted NaN step: %s" % {k: v for k, v in snap.items()})
    check(s3["resilience"]["anomalies_skipped"] == 1 and s3["losses"] == [],
          "planted NaN step: summary %s, losses %s" % (s3["resilience"], s3["losses"]))

    # serve the checkpoint: every request completes, the first prefill's
    # logits match the trained model's forward
    seen = {"prefills": 0, "first": None}

    class Recording(E.ServeEngine):
        def prefill(self, prompt, slot):
            tok, logits = super().prefill(prompt, slot)
            seen["prefills"] += 1
            if seen["first"] is None:
                seen["first"] = (list(prompt), np.array(logits))
            return tok, logits

    orig = E.ServeEngine
    E.ServeEngine = Recording
    routes0 = dict(TF.flash_attention_fwd.routes)
    TF.flash_attention_fwd.launches = 0
    try:
        torch.cuda.empty_cache()
        t_serve = time.perf_counter()
        served = cli_serve.main([
            "--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
            "--num_layers", str(CKPT_LAYERS), "--mixed_precision", "bf16", "--device", "cuda",
            "--serve_max_concurrency", "4", "--serve_page_size", "128",
            "--num_requests", str(SERVE_LOAD_REQUESTS), "--prompt_len_min", "100",
            "--prompt_len_max", "1500", "--max_new_tokens", "8", "--seed", str(SEED),
            "--load", ck])
        serve_s = time.perf_counter() - t_serve
    finally:
        E.ServeEngine = orig
    serve_launches = TF.flash_attention_fwd.launches
    serve_routes = {r: n - routes0.get(r, 0) for r, n in TF.flash_attention_fwd.routes.items()
                    if n != routes0.get(r, 0)}
    check(served["requests"] == SERVE_LOAD_REQUESTS and served["shed"] == 0,
          "serve --load completed %d of %d requests" % (served["requests"], SERVE_LOAD_REQUESTS))
    check(serve_launches == CKPT_LAYERS * seen["prefills"]
          and serve_routes == {"wgmma": serve_launches},
          "serve --load launched the forward %d times (%s), expected %d layers x %d prefills"
          % (serve_launches, serve_routes, CKPT_LAYERS, seen["prefills"]))
    cfg = llama_config("llama-7b", num_layers=CKPT_LAYERS, compute_dtype=torch.bfloat16)
    full, meta = CK.load_full_params(ck, None, cfg)
    trained = M.TransformerLM(cfg, "meta")
    for n, _ in list(trained.named_parameters()):
        owner, _, leaf = n.rpartition(".")
        trained.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            full[n].to("cuda"), requires_grad=False)
    del full
    prompt, logits = seen["first"]
    with torch.inference_mode():
        ref = M.model_forward(trained, torch.tensor([prompt], device="cuda"), None,
                              dataclasses.replace(cfg, attn_impl="xla"))
        ref = ref[0, -1].float().cpu().numpy()
    serve_err = float(np.abs(logits - ref).max())
    check(serve_err <= TOL_DECODE, "serve --load first prefill logits differ from the trained "
          "model's forward by %.4f (tol %.2f)" % (serve_err, TOL_DECODE))
    del trained
    first_save, restore = saved[CKPT_INTERVAL], restored
    sizes = {int(d): sum(os.path.getsize(os.path.join(ck, d, f)) for f in os.listdir(
        os.path.join(ck, d))) for d in os.listdir(ck) if d.isdigit()}
    # the step data and the corpus (~8 GB, ~35 MB) stay for phase 15
    torch.cuda.empty_cache()
    return dict(
        ckpt=ck, corpus=corpus, strategy=strategy,
        helper_library=os.path.relpath(helper), corpus_docs=CORPUS_DOCS,
        corpus_mb=corpus_mb, corpus_s=corpus_s, split_tokens=split_tokens,
        runs={"train": s1, "resume": s2, "nan": s3}, losses=s1["losses"],
        resumed_losses=s2["losses"], resume_loss_diff=loss_diff,
        resume_bitwise=max(loss_diff) == 0.0, tolerance=TOL_RESUME_LOSS,
        nondeterministic_warnings=nondet,
        valid_losses=s1["valid_losses"], test_loss=s1["test_loss"],
        save={"bytes": first_save["bytes"], "seconds": first_save["seconds"],
              "copy_s": first_save["copy_s"], "digest_s": first_save["digest_s"],
              "write_s": first_save["write_s"], "file_bytes": sizes},
        load={"bytes": restore["bytes"], "seconds": restore["seconds"],
              "digest_s": restore["digest_s"]},
        nan_step=dict(snap, summary=s3["resilience"]),
        launches={"train_data": {"fwd": sum(train_data), "bwd": l1[1] + l2[1]},
                  "eval": {"fwd": s1["eval_flash_launches"]["fwd"]
                           + s2["eval_flash_launches"]["fwd"], "bwd": 0},
                  "nan_run": {"fwd": l3[0], "bwd": l3[1]},
                  "serve_load": {"fwd": serve_launches, "bwd": 0}},
        serve=dict(summary=served, prefills=seen["prefills"], first_prefill_err=serve_err,
                   tolerance=TOL_DECODE, seconds=serve_s, restored_iteration=meta["iteration"]),
        wall_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- phase 11
# One process hosts both stages (each stage one device): it runs them one
# after another, so a step takes the unpipelined step's time plus the
# hand-offs; the bubble shows only with a GPU per stage.
# Relative, each step against the unpipelined run (bf16). The schedules
# run the same kernels on the same rows: only the gradient norm's sum
# over stages, and through the clip the weights, differ by rounding. A
# stage whose gradient is lost, or a tied table's two halves not summed,
# moves the first step's norm; a stage that skips its update (the first
# step's learning rate is 0), the third step's loss and norm. A planted
# fault, a stage that never applies its update, must fail the check.
TOL_PP_LOSS = 1e-4
TOL_PP_GRAD_NORM = 2e-4


def _hosted_run(torch, TF, argv, world, frozen_stage=None):
    """Train the configuration of `argv` at `world` (= pp; every stage in
    this process) through the model API, stepped as ``cli train`` steps it
    (guard on); returns losses, gradient norms, launches, routes, step
    times and peak memory. `frozen_stage` plants a fault: that stage's
    weights are put back after every step, as if it never applied its
    update."""
    import gc

    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.cli.arguments import (
        hp_config_from_args,
        initialize_galvatron,
        model_config_from_args,
    )
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.dataloader import build_data_iterator
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import get_optimizer_and_scheduler

    args = initialize_galvatron(argv=argv, mode="train")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with distributed.process_group("cuda") as dev:
        fam, cfg = model_config_from_args(args)
        hp = hp_config_from_args(args, cfg.num_layers, world)
        model = construct_hybrid_parallel_model(cfg, hp, dev,
                                                transport="local" if hp.pp > 1 else "p2p")
        tx, _ = get_optimizer_and_scheduler(cli_train.optimizer_args_from(args))
        params = model.init_params(args.seed)
        state = model.init_opt_state(tx, params)
        step = model.make_train_step(tx, guard_anomalies=True)
        batches = build_data_iterator(args, fam, cfg, hp, device=dev)
        before = {k: dict(getattr(TF, "flash_attention_" + k).routes) for k in ("fwd", "bwd")}
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        losses, norms, step_ms = [], [], []
        for _ in range(args.train_iters):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if frozen_stage is not None:
                kept = [p.detach().clone() for p in params[frozen_stage].parameters()]
            params, state, metrics = step(params, state, batch)
            if frozen_stage is not None:
                with torch.no_grad():
                    for p, k in zip(params[frozen_stage].parameters(), kept):
                        p.copy_(k)
                del kept
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(not metrics["anomalous"], "pipeline run %s: step flagged anomalous (loss %r)"
                  % (os.path.basename(args.galvatron_config_path), losses[-1]))
        fwd, bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
        routes = {k: {r: n - before[k].get(r, 0)
                      for r, n in getattr(TF, "flash_attention_" + k).routes.items()
                      if n != before[k].get(r, 0)} for k in ("fwd", "bwd")}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del params, state, step, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, grad_norms=norms, fwd_launches=fwd, bwd_launches=bwd, routes=routes,
                step_ms=step_ms, steady_step_ms=statistics.median(step_ms[2:] or step_ms),
                peak_memory_gb=peak_gb, pp=hp.pp, division=hp.pp_division,
                pipeline_type=hp.pipeline_type, chunks=hp.chunks, steps=args.train_iters,
                strategy=os.path.relpath(args.galvatron_config_path))


def train_pipelines(torch, TF):
    from galvatron_tpu_torch.tools import train_cell as C

    t0 = time.perf_counter()
    out = "chiprun_out"
    argvs = {
        "llama_pp1": (C.pp_argv(C.write_pp_strategy(out, [C.LAYERS])), 1),
        "llama_pp2_gpipe": (C.pp_argv(C.write_pp_strategy(out, C.PP_DIVISION, "gpipe")), 2),
        "llama_pp2_1f1b": (C.pp_argv(C.write_pp_strategy(out, C.PP_DIVISION,
                                                         "pipedream_flush")), 2),
        "gpt_pp1": (C.pp_argv(C.write_pp_strategy(out, [C.LAYERS], gpt=True), gpt=True), 1),
        "gpt_pp2_53_1f1b": (C.pp_argv(C.write_pp_strategy(out, C.GPT_PP_DIVISION,
                                                          "pipedream_flush", gpt=True),
                                      gpt=True), 2),
    }
    runs = {name: _hosted_run(torch, TF, argv, world) for name, (argv, world) in argvs.items()}
    remat = sum(C.PP_CHECKPOINT)
    for name, r in runs.items():
        check(all(math.isfinite(x) for x in r["losses"]) and len(r["losses"]) == r["steps"],
              "%s losses %s" % (name, r["losses"]))
        want = (r["steps"] * r["chunks"] * (C.LAYERS + remat), r["steps"] * r["chunks"] * C.LAYERS)
        check((r["fwd_launches"], r["bwd_launches"]) == want,
              "%s launched the forward kernel %d times and the backward %d times (expected %d "
              "and %d = %d steps x %d micro-batches x (%d layers + %d recomputed) / x %d layers)"
              % (name, r["fwd_launches"], r["bwd_launches"], want[0], want[1], r["steps"],
                 r["chunks"], C.LAYERS, remat, C.LAYERS))
        check(r["routes"] == {"fwd": {"wgmma": want[0]}, "bwd": {"wgmma": want[1]}},
              "%s launches by route: %s (every one must be wgmma)" % (name, r["routes"]))
    limits = (("losses", TOL_PP_LOSS), ("grad_norms", TOL_PP_GRAD_NORM))

    def rel_errs(r, ref):
        return {key: [abs(x - y) / abs(y) for x, y in zip(r[key], ref[key])] for key, _ in limits}

    for name, ref in (("llama_pp2_gpipe", "llama_pp1"), ("llama_pp2_1f1b", "llama_pp1"),
                      ("gpt_pp2_53_1f1b", "gpt_pp1")):
        for key, rel in rel_errs(runs[name], runs[ref]).items():
            runs[name][key + "_rel_err"] = rel
        for key, tol in limits:
            rel = runs[name][key + "_rel_err"]
            check(max(rel) <= tol,
                  "%s %s differ from the unpipelined run's by %.3g relative (tol %.0e): %s vs %s"
                  % (name, key, max(rel), tol, runs[name][key], runs[ref][key]))
    # the planted fault: under 1F1B, stage 1 never applies its update
    planted = _hosted_run(torch, TF, *argvs["llama_pp2_1f1b"], frozen_stage=1)
    planted_err = {key: max(rel) for key, rel in rel_errs(planted, runs["llama_pp1"]).items()}
    check(any(planted_err[key] > tol for key, tol in limits),
          "the pipeline check passes a planted fault (stage 1 never updates): relative errors %s"
          % planted_err)
    return dict(runs=runs, tolerance=TOL_PP_LOSS, grad_norm_tolerance=TOL_PP_GRAD_NORM,
                planted_fault=dict(losses=planted["losses"], grad_norms=planted["grad_norms"],
                                   max_rel_err=planted_err),
                layers=C.LAYERS, chunks=C.PP_CHUNKS, global_bsz=C.GLOBAL_BSZ,
                remat=",".join(p if c else "none"
                               for c, p in zip(C.PP_CHECKPOINT, C.PP_REMAT_POLICY)),
                wall_s=time.perf_counter() - t0)

# ----------------------------------------------------------------- phase 12
# Galvatron's loop on the card, through the CLI entry points: profile the
# model, profile the hardware, search a strategy, train it. The model is
# phase 8's: LLaMA-7B width at depth 8 (cut from 32 for memory), seq 2048,
# global batch 8 in 2 micro-batches (fixed with --settle_bsz/--settle_chunk,
# so that the budget and not the micro-batch count decides the remat).
LOOP_DIR = os.path.join("chiprun_out", "phase12")
LOOP_PROFILE_BSZ = 8
LOOP_LAYERNUM = (1, 3)
LOOP_WARMUP, LOOP_ITERS = 2, 5  # ModelProfileArgs' defaults
# GB per GPU for the search: between the cost model's prediction for every
# layer checkpointed and for none at this depth and batch (both printed),
# so the search must checkpoint some layers and not all
LOOP_MEMORY_GB = 44.0


def profile_search_train(torch, TF):
    """Phase 12 (see the module note): returns what it measured."""
    import shutil

    from galvatron_tpu_torch.cli import profile as cli_profile
    from galvatron_tpu_torch.cli import search as cli_search
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.cli.arguments import hp_config_from_args, model_config_from_args
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.profiler import validate as V
    from galvatron_tpu_torch.tools import train_cell as C
    from galvatron_tpu_torch.utils.jsonio import read_json_config

    t0 = time.perf_counter()
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    model = C.model_argv()
    out = {}

    # 1. profile: static mode, layers 1 and 3, batch 8, remat fractions
    torch.cuda.empty_cache()
    TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches = 0, 0
    routes0 = {k: dict(v.routes) for k, v in (("fwd", TF.flash_attention_fwd),
                                              ("bwd", TF.flash_attention_bwd))}
    prof = cli_profile.main_model(model + [
        "--device", "cuda", "--config_dir", LOOP_DIR, "--profile_mode", "static",
        "--profile_batch_size", str(LOOP_PROFILE_BSZ), "--layernum_min", str(LOOP_LAYERNUM[0]),
        "--layernum_max", str(LOOP_LAYERNUM[1]), "--profile_remat", "1"])
    fwd, bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    routes = {k: {r: n - routes0[k].get(r, 0) for r, n in v.routes.items()
                  if n != routes0[k].get(r, 0)}
              for k, v in (("fwd", TF.flash_attention_fwd), ("bwd", TF.flash_attention_bwd))}
    lo, hi = LOOP_LAYERNUM
    w, both = LOOP_WARMUP + LOOP_ITERS, lo + hi
    # the programs the differencing runs, each at lo and at hi layers:
    want_fwd = (w * both              # forward times (computation table)
                + w * lo              # embedding+head time: the model at lo layers
                + w * both            # forward times again (remat fractions)
                + w * both            # forward+backward, no remat
                + 3 * w * 2 * both    # full, nothing_saveable, dots_saveable: + recompute
                + both + 2 * both)    # activation bytes: no remat, full remat
    want_bwd = w * both + 3 * w * both + 2 * both
    check((fwd, bwd) == (want_fwd, want_bwd),
          "profile launched the forward kernel %d times and the backward %d times (expected "
          "%d and %d)" % (fwd, bwd, want_fwd, want_bwd))
    check(routes == {"fwd": {"wgmma": fwd}, "bwd": {"wgmma": bwd}},
          "profile launches by route: %s (every one must be wgmma)" % routes)
    comp, mem = prof["computation"], prof["memory"]
    out["profile"] = dict(computation=comp, memory=mem, act_records=prof["act_records"],
                          fwd_launches=fwd, bwd_launches=bwd)
    for rec in prof["act_records"]:
        check(rec["allocator"] is not None and rec["allocator"] > 0 and rec["saved"] > 0,
              "activation measurement %s" % rec)

    # 2. profile-hardware at world 1: no group of two, so no all-reduce file
    hw = cli_profile.main_hardware(["--device", "cuda", "--config_dir", LOOP_DIR])
    check(hw["world_size"] == 1, "profile-hardware ran at world %d" % hw["world_size"])
    check(not os.path.exists(hw["paths"]["allreduce"]) and os.path.exists(hw["paths"]["overlap"]),
          "profile-hardware at world 1 wrote %s" % sorted(os.listdir(LOOP_DIR)))
    out["hardware"] = {k: v for k, v in hw.items() if k != "paths"}

    # 3. search at world 1 for the phase-8 model under LOOP_MEMORY_GB
    cfg = model_config_from_args(cli_train.initialize_galvatron(argv=C.argv(""), mode="train"))[1]
    hw_tables = {k: read_json_config(p) for k, p in hw["paths"].items() if os.path.exists(p)}

    def predicted_mb(ckpt):
        hp = HybridParallelConfig(world_size=1, pp=1, layers=[LayerStrategy(checkpoint=ckpt)]
                                  * C.LAYERS, global_bsz=C.GLOBAL_BSZ, chunks=C.CHUNKS)
        return V.predict_memory_mb(hp, mem, cfg.max_seq_len, cfg.hidden_size)["total_mb"]

    out["predicted_mb_uniform"] = {"no_remat": predicted_mb(0), "all_remat": predicted_mb(1)}
    log("phase 12 cost model at %d layers, batch %d in %d: %.0f MB with no layer "
        "checkpointed, %.0f MB with every layer (+512 MB runtime reserve in the search); "
        "budget %.1f GB" % (C.LAYERS, C.GLOBAL_BSZ, C.CHUNKS,
                            out["predicted_mb_uniform"]["no_remat"],
                            out["predicted_mb_uniform"]["all_remat"], LOOP_MEMORY_GB))
    strategy = os.path.join(LOOP_DIR, "searched_strategy.json")
    os.environ["GALVATRON_WORLD_SIZE"] = "1"
    try:
        result = cli_search.main(model + [
            "--config_dir", LOOP_DIR, "--memory_constraint", str(LOOP_MEMORY_GB),
            "--settle_bsz", str(C.GLOBAL_BSZ), "--settle_chunk", str(C.CHUNKS),
            "--output_config_path", strategy, "--log_dir", os.path.join(LOOP_DIR, "logs")])
    finally:
        del os.environ["GALVATRON_WORLD_SIZE"]
    searched = HybridParallelConfig.from_json(strategy, world_size=1)
    ckpt = [s.checkpoint for s in searched.layers]
    check(0 < sum(ckpt) < len(ckpt),
          "the search under %.1f GB checkpointed %d of %d layers (expected some, not all)"
          % (LOOP_MEMORY_GB, sum(ckpt), len(ckpt)))
    out["search"] = dict(cost_ms=result["cost"], strategy=read_json_config(strategy),
                         checkpoint=ckpt, chunks=searched.chunks,
                         fsdp=[s.fsdp for s in searched.layers])

    # 4. train the emitted strategy, then predicted against measured
    argv = C.argv(strategy)
    args = cli_train.initialize_galvatron(argv=argv, mode="train")
    trained_hp = hp_config_from_args(args, C.LAYERS, 1)
    check((trained_hp.layers, trained_hp.pp, trained_hp.chunks, trained_hp.global_bsz)
          == (searched.layers, searched.pp, searched.chunks, searched.global_bsz),
          "the train CLI's strategy %s is not the searched one %s"
          % (trained_hp.describe(), searched.describe()))
    torch.cuda.empty_cache()
    TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches = 0, 0
    summary = cli_train.main(argv)
    fwd, bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    losses = summary["losses"]
    check(len(losses) == C.STEPS and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0], "phase 12 train losses %s (must fall)" % losses)
    want = (C.STEPS * searched.chunks * (C.LAYERS + sum(ckpt)),
            C.STEPS * searched.chunks * C.LAYERS)
    check((fwd, bwd) == want, "phase 12 train launched the forward kernel %d times and the "
          "backward %d times (expected %d and %d)" % (fwd, bwd, *want))
    check(summary["flash_routes"] == [{"fwd": {"wgmma": fwd}, "bwd": {"wgmma": bwd}}],
          "phase 12 train launches by route: %s" % summary["flash_routes"])
    budget_mb = LOOP_MEMORY_GB * 1024.0
    check(summary["peak_hbm_mb"] <= budget_mb, "phase 12 train peak %.0f MB > the %.0f MB budget"
          % (summary["peak_hbm_mb"], budget_mb))
    out["train"] = dict(summary=summary, fwd_launches=fwd, bwd_launches=bwd)
    torch.cuda.empty_cache()
    tv, mv = V.validate(cfg, searched, comp, mem, hw_tables, device="cuda")
    torch.cuda.empty_cache()
    check(mv.measured_mb <= budget_mb, "phase 12 validation peak %.0f MB > the %.0f MB budget"
          % (mv.measured_mb, budget_mb))
    out["validate"] = dict(time=dict(predicted_ms=tv.predicted_ms, measured_ms=tv.measured_ms,
                                     ratio=tv.ratio),
                           memory=dict(predicted_mb=mv.predicted_mb, measured_mb=mv.measured_mb,
                                       ratio=mv.ratio, layers_mb=mv.predicted_layers_mb,
                                       other_mb=mv.predicted_other_mb))
    out["wall_s"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- phase 13
# long context on the card: LLaMA-7B's 32 heads of 128, bf16, B=1, every cp
# rank's shards on this card (LocalRing: a hop is a copy on the card where
# NCCL would carry it). LC_SEQ is checked against the unsharded kernel on the
# same sequence, LC_PLAIN_SEQ against the plain ring version (fp32 logits a
# key chunk at a time).
LC_SEQ = 32768
LC_PLAIN_SEQ = 8192
LC_CPS = (2, 4)
LC_MODES = ("zigzag", "ring")
# the rows of the blocks a cp 4 zigzag step gives the kernels at LC_SEQ
# (2c and c, c = LC_SEQ / 8): phases 3-4 check and time these shapes
RING_BLOCK_ROWS = (8192, 4096)


def ring_launches(mode, cp):
    """Kernel calls of one ring pass over a cp-rank ring (every rank): one
    per step and rank under zigzag, r + 1 on rank r under ring."""
    return cp * cp if mode == "zigzag" else cp * (cp + 1) // 2


def check_lse(torch, name, got, ref, case):
    """Fail unless the (B, H, S) logsumexp `got` is within TOL_LSE of `ref`
    and two planted faults (the last and the first tile of rows off by
    log 2: one block merged twice) fail that check; returns the max err."""
    err = (got - ref).abs().max().item()
    check(err <= TOL_LSE, "%s lse err %.3g > %.3g at %s" % (name, err, TOL_LSE, case))
    for rows in (slice(-TILE, None), slice(0, TILE)):
        wrong = ref.clone()
        wrong[..., rows] += math.log(2.0)
        check((wrong - ref).abs().max().item() > TOL_LSE,
              "%s lse check passes a planted fault at %s" % (name, case))
    return err


def long_context(torch, TF, dev):
    """Phase 13 (see the module note): ring attention through LocalRing at
    cp 2 and 4, both cp modes, causal, with and without a key-padding
    tail (the cotangent zero on padded queries, whose outputs the model
    does not use); one ring forward and one ring backward per case. At
    LC_SEQ the output, the merged logsumexp and dq/dk/dv are held against
    the unsharded kernels (the backward fed the unsharded forward's own
    out and lse), at LC_PLAIN_SEQ against the plain ring (its backward fed
    the ring's merged out and lse, which are held against the plain
    forward's), with the phase 3-4 checks on the
    valid rows; exact launch counts on the wgmma route; at LC_SEQ the
    ring's forward and backward timed beside the unsharded kernel's."""
    from galvatron_tpu_torch.ops import ring_attention as R

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    nh, hd, dtype = 32, 128, torch.bfloat16
    scale = hd ** -0.5
    runs, launches = [], {"fwd": 0, "bwd": 0}
    for s, against in ((LC_SEQ, "kernel"), (LC_PLAIN_SEQ, "plain")):
        for cp in LC_CPS:
            for mode in LC_MODES:
                for padded in (False, True):
                    case = dict(s=s, cp=cp, mode=mode, padded=padded, against=against)
                    q, k, v, do = (torch.randn((1, s, nh, hd), generator=gen, device=dev)
                                   .to(dtype) for _ in range(4))
                    valid = s - s // 8 - 3 if padded else s
                    do[:, valid:] = 0
                    ids = segment_ids(torch, 1, s, valid, dev) if padded else None
                    idx = torch.as_tensor(R.zigzag_permutation(s, cp) if mode == "zigzag"
                                          else list(range(s)), device=dev)
                    inv = torch.empty_like(idx)
                    inv[idx] = torch.arange(s, device=dev)

                    def shards(t, _idx=idx, _cp=cp):
                        return dict(enumerate(x.contiguous() for x in t[:, _idx].chunk(_cp, 1)))

                    def natural(parts, dim=1, _inv=inv):
                        """Every rank's shard, back in sequence order."""
                        return torch.cat([parts[r] for r in sorted(parts)], dim).index_select(
                            dim, _inv)

                    qs, ks, vs, dos = (shards(t) for t in (q, k, v, do))
                    segs = shards(ids) if padded else None
                    kw = dict(transport=R.LocalRing(cp), mode=mode, causal=True, sm_scale=scale)
                    before = {w: dict(getattr(TF, "flash_attention_" + w).routes)
                              for w in ("fwd", "bwd")}
                    TF.flash_attention_fwd.launches = 0
                    TF.flash_attention_bwd.launches = 0
                    res = R.ring_forward(qs, ks, vs, segs, segs, **kw)
                    outs = {r: o for r, (o, _) in res.items()}
                    lses = {r: lse for r, (_, lse) in res.items()}
                    grads = R.ring_backward(qs, ks, vs, outs, lses, dos, segs, segs, **kw)
                    torch.cuda.synchronize()
                    fwd_n, bwd_n = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
                    want_n = ring_launches(mode, cp)
                    check((fwd_n, bwd_n) == (want_n, want_n),
                          "ring launched the forward kernel %d and the backward %d times, not "
                          "%d each, at %s" % (fwd_n, bwd_n, want_n, case))
                    for w in ("fwd", "bwd"):
                        now = getattr(TF, "flash_attention_" + w).routes
                        new = {r: n - before[w].get(r, 0) for r, n in now.items()
                               if n != before[w].get(r, 0)}
                        check(set(new) == {"wgmma"}, "ring %s routes %s at %s" % (w, new, case))
                    launches["fwd"] += fwd_n
                    launches["bwd"] += bwd_n
                    got = [natural(outs)] + [natural({r: g[i] for r, g in grads.items()})
                                             for i in range(3)]
                    got_lse = natural(lses, 2)
                    if against == "kernel":
                        seg = TF.SegmentIds(ids, ids) if padded else None
                        out_ref, lse_ref = TF.flash_attention_fwd(q, k, v, causal=True,
                                                                  sm_scale=scale, segment_ids=seg)
                        ref = [out_ref] + list(TF.flash_attention_bwd(
                            q, k, v, out_ref, lse_ref, do, causal=True, sm_scale=scale,
                            segment_ids=seg))
                    else:
                        positions = [torch.as_tensor(R.chunk_positions(mode, cp, r, s),
                                                     device=dev)[None] for r in range(cp)]
                        plain_args = [[d[r] for r in range(cp)] for d in (qs, ks, vs)]
                        plain_segs = [segs[r] for r in range(cp)] if padded else None
                        pouts, plses = R.ring_attention_reference(*plain_args, positions,
                                                                  segment_ids=plain_segs)
                        # the plain backward takes what the ring's kernels took,
                        # the merged (out, lse), as phase 4 feeds the kernel's
                        # to both backwards: the plain forward's bf16 out does
                        # not round p before P.V as the forward kernel does, and
                        # di = rowsum(out * dout) carries that difference into
                        # every ds of a row, past the limit on rows whose dq
                        # cancels. The merged out and lse are held against the
                        # plain forward's below.
                        pgrads = R.ring_attention_reference_bwd(
                            *plain_args, [outs[r] for r in range(cp)],
                            [lses[r] for r in range(cp)], [dos[r] for r in range(cp)],
                            positions, segment_ids=plain_segs)
                        ref = [natural(dict(enumerate(pouts)))] + [
                            natural({r: g[i] for r, g in enumerate(pgrads)}) for i in range(3)]
                        lse_ref = natural(dict(enumerate(plses)), 2)
                        del pouts, plses, pgrads
                    torch.cuda.synchronize()
                    errs, used = {}, {}
                    for name, g, w in zip(("out", "dq", "dk", "dv"), got, ref):
                        check(bool(torch.isfinite(g.float()).all()),
                              "ring %s not finite at %s" % (name, case))
                        # the output on every row; the gradients on the valid
                        # rows (the padded ones are zero through the cotangent)
                        rows = slice(None) if name == "out" else slice(0, valid)
                        errs[name], used[name], _ = check_against_plain(
                            torch, "ring " + name, g[:, rows], w[:, rows],
                            TOL_FWD_BF16 if name == "out" else TOL_BWD_BF16, case)
                    errs["lse"] = check_lse(torch, "ring", got_lse[..., :valid],
                                            lse_ref[..., :valid], case)
                    run = dict(case, valid_len=valid, launches=want_n, max_abs_err=errs,
                               limit_used=used)
                    if against == "kernel" and not padded:
                        ring_fwd = time_ms(torch, lambda: R.ring_forward(
                            qs, ks, vs, None, None, **kw), reps=5, warmup=1)
                        ring_bwd = time_ms(torch, lambda: R.ring_backward(
                            qs, ks, vs, outs, lses, dos, None, None, **kw), reps=5, warmup=1)
                        one_fwd = time_ms(torch, lambda: TF.flash_attention_fwd(
                            q, k, v, causal=True, sm_scale=scale), reps=5, warmup=1)
                        one_bwd = time_ms(torch, lambda: TF.flash_attention_bwd(
                            q, k, v, out_ref, lse_ref, do, causal=True, sm_scale=scale),
                            reps=5, warmup=1)
                        run.update(ring_fwd_ms=ring_fwd, ring_bwd_ms=ring_bwd,
                                   unsharded_fwd_ms=one_fwd, unsharded_bwd_ms=one_bwd,
                                   fwd_ratio=ring_fwd / one_fwd, bwd_ratio=ring_bwd / one_bwd)
                    runs.append(run)
                    log("ring %s cp %d S=%d %s vs %s: err out/dq/dk/dv %s (of the limit %s), "
                        "lse %.3g, launches %d fwd + %d bwd (wgmma)%s" % (
                            mode, cp, s, "padded" if padded else "full",
                            "the unsharded kernel" if against == "kernel" else "the plain ring",
                            "/".join("%.3g" % errs[n] for n in used),
                            "/".join("%.2f" % used[n] for n in used), errs["lse"], fwd_n, bwd_n,
                            "; ring fwd %.2f ms vs unsharded %.2f ms (x%.3f), bwd %.2f vs %.2f "
                            "ms (x%.3f)" % (run["ring_fwd_ms"], run["unsharded_fwd_ms"],
                                            run["fwd_ratio"], run["ring_bwd_ms"],
                                            run["unsharded_bwd_ms"], run["bwd_ratio"])
                            if "fwd_ratio" in run else ""))
                    del q, k, v, do, qs, ks, vs, dos, res, outs, lses, grads, got, got_lse
                    del ref, lse_ref
                    torch.cuda.empty_cache()
    return dict(runs=runs, launches=launches, wall_s=time.perf_counter() - t0,
                heads=nh, head_dim=hd)


def log_loop(loop, card):
    """Phase 12's lines."""
    p = loop["profile"]
    comp, mem = p["computation"], p["memory"]
    act = mem["layertype_0"]["tp_activation_per_bsz_dict"]
    log("phase 12 profile (llama-7b width, batch %d, seq 2048, bf16, layers %d and %d) on %s: "
        "forward %.4f ms per layer per sample, embedding+head+loss %.4f ms per sample; "
        "activation MB per layer per sample %s; stored: %.3f (no remat), %.3f (remat); "
        "remat recompute fractions %s; flash launches fwd %d / bwd %d (all wgmma)" % (
            LOOP_PROFILE_BSZ, LOOP_LAYERNUM[0], LOOP_LAYERNUM[1], card, comp["layertype_0"],
            comp["other_time"], "; ".join(
                "%s: allocator %.3f, saved tensors %.3f" % (
                    "remat" if r["remat"] else "no remat", r["allocator"], r["saved"])
                for r in p["act_records"]), act[1],
            act["checkpoint"], comp["remat_recompute_frac"], p["fwd_launches"],
            p["bwd_launches"]))
    log("phase 12 hardware (world 1): %s" % loop["hardware"])
    sr = loop["search"]
    log("phase 12 search (world 1, %.1f GB, global batch 8 in %d): checkpoint %s, fsdp %s, "
        "predicted %.1f ms/step" % (LOOP_MEMORY_GB, sr["chunks"], sr["checkpoint"], sr["fsdp"],
                                    sr["cost_ms"]))
    t = loop["train"]["summary"]
    v = loop["validate"]
    log("phase 12 train under the searched strategy on %s: step %.1f ms end to end, device "
        "%.1f ms/step, peak memory %.2f GB, losses %s, flash launches fwd %d / bwd %d; "
        "validate: step %.1f ms predicted, %.1f ms measured (ratio %.3f); peak %.2f GB "
        "predicted, %.2f GB measured (ratio %.3f); phase %.1f s" % (
            card, t["steady_step_ms"], t["device_step_ms"], t["peak_hbm_mb"] / 1024.0,
            ["%.4f" % x for x in t["losses"]], loop["train"]["fwd_launches"],
            loop["train"]["bwd_launches"], v["time"]["predicted_ms"], v["time"]["measured_ms"],
            v["time"]["ratio"], v["memory"]["predicted_mb"] / 1024.0,
            v["memory"]["measured_mb"] / 1024.0, v["memory"]["ratio"], loop["wall_s"]))


# ----------------------------------------------------------------- phase 14
# BERT-large and ViT-huge width at depth 2, one micro-batch, bf16 on the
# card against fp32 on the CPU from the same weights. Every matmul output
# on the card rounds to bf16 (2^-9 relative) and the plain attention's
# probabilities round to bf16 before the value product; through two layers
# and the head those roundings leave a parameter's gradient a few 1e-3 off
# the fp32 one in relative norm. The limit is phase 5's (two bf16 paths),
# 5e-2: room for the leaves few tokens reach (the second token-type row,
# the padded keys' rows) and still far below what a lost, doubled or
# misplaced gradient gives (>= 1). The losses (~ln 30522, ~ln 1000) within
# 1e-2, phase 5's.
TOL_ENCODER_GRAD_REL = 5e-2
TOL_ENCODER_LOSS = 1e-2
ENCODER_GRAD_LAYERS = 2


def _encoder_batch(torch, fam, cfg):
    """One micro-batch on the CPU: BERT, 2 x 512 tokens with token types
    (type 1 from a per-row split point), the second row's last 96 keys
    padded and out of the loss; ViT, 2 standard-normal images."""
    gen = torch.Generator().manual_seed(SEED)
    if fam == "vit":
        return {"pixels": torch.randn((2, cfg.image_size, cfg.image_size, cfg.num_channels),
                                      generator=gen),
                "labels": torch.randint(0, cfg.num_classes, (2,), generator=gen)}
    s = cfg.max_seq_len
    mask = torch.ones(2, s)
    mask[1, s - 96:] = 0.0
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=gen),
            "positions": torch.arange(s).expand(2, s),
            "labels": torch.randint(0, cfg.vocab_size, (2, s), generator=gen),
            "loss_mask": mask, "attn_mask": mask.clone(),
            "token_type_ids": (torch.arange(s)[None, :] >= torch.tensor([[200], [300]])).long()}


def encoder_grads(torch, TF, fam):
    """The loss and every gradient of one micro-batch at the family's
    width and depth 2: the card (bf16) against the CPU (fp32)."""
    from galvatron_tpu_torch.models import base as M
    from galvatron_tpu_torch.models.bert import bert_config
    from galvatron_tpu_torch.models.vit import vit_config
    from galvatron_tpu_torch.tools import train_cell as C

    make, size = (bert_config, C.BERT_SIZE) if fam == "bert" else (vit_config, C.VIT_SIZE)
    cpu_cfg = make(size, num_layers=ENCODER_GRAD_LAYERS, compute_dtype=torch.float32)
    card_cfg = make(size, num_layers=ENCODER_GRAD_LAYERS, compute_dtype=torch.bfloat16)
    params = M.init_model_params(cpu_cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = _encoder_batch(torch, fam, cpu_cfg)
    t0 = time.perf_counter()
    loss_cpu = M.loss_fn(params, batch, cpu_cfg)
    loss_cpu.backward()
    cpu_s = time.perf_counter() - t0
    want = {n: p.grad for n, p in params.named_parameters()}
    card = M.TransformerLM(card_cfg, "cuda")
    card.load_state_dict(params.state_dict())
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    loss = M.loss_fn(card, {k: v.cuda() for k, v in batch.items()}, card_cfg)
    loss.backward()
    launches = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    rel = {n: float((p.grad.float().cpu() - want[n]).norm() / want[n].norm().clamp(min=1e-30))
           for n, p in card.named_parameters()}
    worst = max(rel, key=rel.get)
    loss, loss_cpu = float(loss.detach()), float(loss_cpu.detach())
    check(abs(loss - loss_cpu) <= TOL_ENCODER_LOSS,
          "%s gradients: card loss %.6f vs CPU %.6f (tol %g)" % (fam, loss, loss_cpu,
                                                                TOL_ENCODER_LOSS))
    check(rel[worst] <= TOL_ENCODER_GRAD_REL,
          "%s gradients: %s at %.3g relative to the CPU's (tol %g)" % (
              fam, worst, rel[worst], TOL_ENCODER_GRAD_REL))
    check(launches == (0, 0), "%s gradients launched the flash kernels %s times" % (fam, launches))
    del card, params
    torch.cuda.empty_cache()
    return dict(loss=loss, loss_cpu=loss_cpu, worst=worst, worst_rel=rel[worst],
                median_rel=statistics.median(rel.values()), leaves=len(rel), cpu_s=cpu_s,
                launches=launches, tolerance=TOL_ENCODER_GRAD_REL)


def _plain_cli_run(torch, TF, name, argv):
    """``cli.train.main(argv)`` with the launch counts reset before it: its
    losses finite, no flash launch (the run's shapes take the plain
    path)."""
    import gc

    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.tools import train_cell as C

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    summary = cli_train.main(argv)
    launches = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    check(len(summary["losses"]) == C.STEPS and all(math.isfinite(x) for x in summary["losses"]),
          "%s losses %s" % (name, summary["losses"]))
    check(launches == (0, 0) and summary["flash_routes"] == [{"fwd": {}, "bwd": {}}],
          "%s launched the flash kernels %s times (%s): its shapes take the plain path"
          % (name, launches, summary["flash_routes"]))
    return dict(summary=summary, fwd_launches=launches[0], bwd_launches=launches[1],
                wall_s=time.perf_counter() - t0)


def encoder_families(torch, TF):
    """BERT-large and ViT-huge at full size through the train CLI, the
    gradient checks and the BERT step's trace (see the module note, phase
    14)."""
    import gc

    from galvatron_tpu_torch.tools import profile_train
    from galvatron_tpu_torch.tools import train_cell as C

    t0 = time.perf_counter()
    out = os.path.join("chiprun_out", "phase14")
    runs = {}

    def run(name, argv):
        runs[name] = _plain_cli_run(torch, TF, name, argv)

    run("bert_dp", C.bert_argv(C.write_bert_strategy(out)))
    run("bert_zero3", C.bert_argv(C.write_bert_strategy(out, zero3=True)))
    a, b = runs["bert_zero3"]["summary"]["losses"], runs["bert_dp"]["summary"]["losses"]
    rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    check(max(rel) <= TOL_LAYOUT_LOSS, "bert ZeRO-3/ZeRO-2 vs dp losses differ by %.3g relative "
          "(tol %.0e): %s vs %s" % (max(rel), TOL_LAYOUT_LOSS, a, b))
    t_shard = time.perf_counter()
    shard = C.write_vision_shard(out)
    shard_s = time.perf_counter() - t_shard
    shard_mb = os.path.getsize(shard + ".images.npy") / 1e6
    try:
        run("vit", C.vit_argv(shard))
    finally:
        for ext in (".images.npy", ".labels.npy"):
            os.remove(shard + ext)
    grads = {fam: encoder_grads(torch, TF, fam) for fam in ("bert", "vit")}
    gc.collect()
    torch.cuda.empty_cache()
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    trace = profile_train.main(["--cell", "bert", "--warmup", "1", "--steps", "1"])
    launches = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    check(launches == (0, 0), "the traced bert steps launched the flash kernels %s times"
          % (launches,))
    torch.cuda.empty_cache()
    return dict(runs=runs, loss_rel_err=rel, tolerance=TOL_LAYOUT_LOSS, grads=grads,
                trace={k: v for k, v in trace.items() if k != "argv"}, shard_mb=shard_mb,
                shard_s=shard_s, images=C.VISION_IMAGES, steps=C.STEPS,
                wall_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- phase 16
T5_GRAD_SWIN_DEPTHS = (2, 1, 1, 1)  # a shifted block and every patch merge


def _t5_swin_batch(torch, fam, cfg):
    """One micro-batch on the CPU: T5, 2 x 512 encoder and decoder tokens,
    the second row's last 96 encoder keys padded and its last 40 decoder
    positions out of the loss; Swin, 2 standard-normal images."""
    gen = torch.Generator().manual_seed(SEED)
    if fam == "swin":
        return {"pixels": torch.randn((2, cfg.image_size, cfg.image_size, cfg.num_channels),
                                      generator=gen),
                "labels": torch.randint(0, cfg.num_classes, (2,), generator=gen)}
    s = cfg.max_seq_len
    mask, loss_mask = torch.ones(2, s), torch.ones(2, s)
    mask[1, s - 96:] = 0.0
    loss_mask[1, s - 40:] = 0.0
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=gen),
            "dec_tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=gen),
            "labels": torch.randint(0, cfg.vocab_size, (2, s), generator=gen),
            "attn_mask": mask, "loss_mask": loss_mask}


def t5_swin_grads(torch, TF, fam):
    """The loss and every gradient of one micro-batch at the family's full
    width cut in depth: the card (bf16) against the CPU (fp32)."""
    from galvatron_tpu_torch.models import swin as W
    from galvatron_tpu_torch.models import t5 as T5
    from galvatron_tpu_torch.tools import train_cell as C

    if fam == "t5":
        def make(dtype):
            return T5.t5_config(C.T5_SIZE, num_enc_layers=1, num_dec_layers=1,
                                compute_dtype=dtype)
        init, tree, loss_fn = T5.init_t5_params, T5.T5Model, T5.t5_loss_fn
    else:
        def make(dtype):
            return W.swin_config(C.SWIN_SIZE, depths=T5_GRAD_SWIN_DEPTHS, compute_dtype=dtype)
        init, tree, loss_fn = W.init_swin_params, W.SwinModel, W.swin_loss_fn
    cpu_cfg, card_cfg = make(torch.float32), make(torch.bfloat16)
    params = init(cpu_cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = _t5_swin_batch(torch, fam, cpu_cfg)
    t0 = time.perf_counter()
    loss_cpu = loss_fn(params, batch, cpu_cfg)
    loss_cpu.backward()
    cpu_s = time.perf_counter() - t0
    want = {n: p.grad for n, p in params.named_parameters()}
    card = tree(card_cfg, "cuda")
    card.load_state_dict(params.state_dict())
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    loss = loss_fn(card, {k: v.cuda() for k, v in batch.items()}, card_cfg)
    loss.backward()
    launches = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    rel = {n: float((p.grad.float().cpu() - want[n]).norm() / want[n].norm().clamp(min=1e-30))
           for n, p in card.named_parameters()}
    worst = max(rel, key=rel.get)
    loss, loss_cpu = float(loss.detach()), float(loss_cpu.detach())
    check(abs(loss - loss_cpu) <= TOL_ENCODER_LOSS,
          "%s gradients: card loss %.6f vs CPU %.6f (tol %g)" % (fam, loss, loss_cpu,
                                                                TOL_ENCODER_LOSS))
    check(rel[worst] <= TOL_ENCODER_GRAD_REL,
          "%s gradients: %s at %.3g relative to the CPU's (tol %g)" % (
              fam, worst, rel[worst], TOL_ENCODER_GRAD_REL))
    check(launches == (0, 0), "%s gradients launched the flash kernels %s times" % (fam, launches))
    del card, params
    torch.cuda.empty_cache()
    return dict(loss=loss, loss_cpu=loss_cpu, worst=worst, worst_rel=rel[worst],
                median_rel=statistics.median(rel.values()), leaves=len(rel), cpu_s=cpu_s,
                launches=launches, tolerance=TOL_ENCODER_GRAD_REL)


def _rel_errs(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


T5_TRACE_BATCH = 8  # the T5 trace's global batch, one micro-batch


def t5_swin_families(torch, TF):
    """T5-large and Swin-large at full size through the train CLI and as
    hosted pp 2 pipelines, the gradient checks and the T5 step's trace
    (see the module note, phase 16)."""
    import gc

    from galvatron_tpu_torch.tools import profile_train
    from galvatron_tpu_torch.tools import train_cell as C

    t0 = time.perf_counter()
    out = os.path.join("chiprun_out", "phase16")
    runs, rel = {}, {}

    def hosted(name, argv, ref):
        t_run = time.perf_counter()
        r = _hosted_run(torch, TF, argv, 2)
        r["wall_s"] = time.perf_counter() - t_run
        check(all(math.isfinite(x) for x in r["losses"]) and (r["fwd_launches"],
                                                             r["bwd_launches"]) == (0, 0),
              "%s: losses %s, flash launches fwd %d / bwd %d" % (
                  name, r["losses"], r["fwd_launches"], r["bwd_launches"]))
        r["losses_rel_err"] = _rel_errs(r["losses"], runs[ref]["summary"]["losses"])
        check(max(r["losses_rel_err"]) <= TOL_PP_LOSS,
              "%s losses %s differ from the pp 1 run's %s by %.3g relative (tol %.0e)" % (
                  name, r["losses"], runs[ref]["summary"]["losses"], max(r["losses_rel_err"]),
                  TOL_PP_LOSS))
        runs[name] = r

    t_data = time.perf_counter()
    corpus = C.write_t5_corpus(out)
    corpus_mb = sum(os.path.getsize(corpus + e) for e in (".bin", ".idx.npy")) / 1e6
    data_s = time.perf_counter() - t_data
    try:
        runs["t5_dp"] = _plain_cli_run(torch, TF, "t5_dp", C.t5_argv(C.write_t5_strategy(out),
                                                                    corpus))
        runs["t5_zero"] = _plain_cli_run(torch, TF, "t5_zero", C.t5_argv(
            C.write_t5_strategy(out, zero=True), corpus))
        rel["t5_zero"] = _rel_errs(runs["t5_zero"]["summary"]["losses"],
                                   runs["t5_dp"]["summary"]["losses"])
        check(max(rel["t5_zero"]) <= TOL_LAYOUT_LOSS,
              "t5 ZeRO-3/ZeRO-2 vs dp losses differ by %.3g relative (tol %.0e)"
              % (max(rel["t5_zero"]), TOL_LAYOUT_LOSS))
        hosted("t5_pp2", C.t5_argv(C.write_t5_strategy(out, pp=2), corpus), "t5_dp")
    finally:
        for ext in (".bin", ".idx.npy"):
            if os.path.exists(corpus + ext):
                os.remove(corpus + ext)
    shard = C.write_vision_shard(out)
    try:
        runs["swin"] = _plain_cli_run(torch, TF, "swin", C.swin_argv(C.write_swin_strategy(out),
                                                                    shard))
        hosted("swin_pp2", C.swin_argv(C.write_swin_strategy(out, pp=2), shard), "swin")
    finally:
        for ext in (".images.npy", ".labels.npy"):
            if os.path.exists(shard + ext):
                os.remove(shard + ext)
    t_grads = time.perf_counter()
    grads = {fam: t5_swin_grads(torch, TF, fam) for fam in ("t5", "swin")}
    grads_s = time.perf_counter() - t_grads
    gc.collect()
    torch.cuda.empty_cache()
    t_trace = time.perf_counter()
    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    # one micro-batch of 8 (the runs' 32 in 4): a quarter of the ops to record
    trace = profile_train.main(["--cell", "t5", "--warmup", "1", "--steps", "1",
                                "--t5_batch", str(T5_TRACE_BATCH)])
    launches = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    check(launches == (0, 0), "the traced t5 steps launched the flash kernels %s times"
          % (launches,))
    torch.cuda.empty_cache()
    return dict(runs=runs, loss_rel_err=rel, tolerance=TOL_LAYOUT_LOSS,
                pp_tolerance=TOL_PP_LOSS, grads=grads, corpus_mb=corpus_mb, data_s=data_s,
                trace={k: v for k, v in trace.items() if k != "argv"}, steps=C.STEPS,
                grads_s=grads_s, trace_s=time.perf_counter() - t_trace,
                wall_s=time.perf_counter() - t0)


def log_t5_swin(ts, card):
    what = {"t5_dp": "t5-large, 24 + 24 layers, every layer plain dp, from span corruption",
            "t5_zero": "t5-large, encoder ZeRO-3, decoder ZeRO-2",
            "t5_pp2": "t5-large, pp 2 1F1B 24/24, both stages on this card",
            "swin": "swin-large, 24 blocks, plain dp, from a 512-image shard",
            "swin_pp2": "swin-large, pp 2 1F1B 12/12, both stages on this card"}
    for name, r in ts["runs"].items():
        t5 = name.startswith("t5")
        if "summary" in r:
            g = r["summary"]
            log("train %s (bf16, global batch %d) on %s: step %.1f ms end to end, device %.1f "
                "ms/step, %.0f %s/s, MFU %s, peak memory %.1f GB, losses %s, flash launches "
                "fwd %d / bwd %d" % (
                    what[name], 32 if t5 else 64, card, g["steady_step_ms"], g["device_step_ms"],
                    g["tokens_per_s"] if t5 else g["images_per_s"], "tokens" if t5 else "images",
                    "%.3f (989 TFLOP/s; %s)" % (g["mfu"], g["mfu_note"]) if g.get("mfu")
                    else "none (no analytic count)", g["peak_hbm_mb"] * 2**20 / 1e9,
                    ["%.5f" % x for x in g["losses"]], r["fwd_launches"], r["bwd_launches"]))
        else:
            log("train %s on %s: step %.1f ms (stages one after another), peak memory %.1f GB, "
                "losses %s, max rel err vs pp 1 %.3g (tol %.0e), flash launches fwd %d / bwd %d"
                % (what[name], card, r["steady_step_ms"], r["peak_memory_gb"],
                   ["%.5f" % x for x in r["losses"]], max(r["losses_rel_err"]),
                   ts["pp_tolerance"], r["fwd_launches"], r["bwd_launches"]))
    log("t5 dp vs ZeRO-3/ZeRO-2 losses agree within %.3g relative (tol %.0e)"
        % (max(ts["loss_rel_err"]["t5_zero"]), ts["tolerance"]))
    for fam, gr in ts["grads"].items():
        log("%s width, %s, card (bf16) vs CPU (fp32): loss %.6f vs %.6f, worst gradient %s at "
            "%.3g relative (median %.3g, %d leaves; tol %.0e)" % (
                fam, "1 + 1 layers" if fam == "t5" else "depths %s" % (T5_GRAD_SWIN_DEPTHS,),
                gr["loss"], gr["loss_cpu"], gr["worst"], gr["worst_rel"], gr["median_rel"],
                gr["leaves"], gr["tolerance"]))
    tr = ts["trace"]
    log("t5-large traced step (torch.profiler, 1 step) on %s: wall %.1f ms, device busy %.1f "
        "ms, idle share %.3f, plain attention %.1f ms = %.3f of busy, by kind %s; phase %.1f s "
        "(runs %s s, gradients %.1f s, trace %.1f s)"
        % (card, tr["wall_ms_per_step"], tr["device_busy_ms_per_step"], tr["idle_share"],
           tr["plain_attention_ms_per_step"], tr["plain_attention_share_of_busy"] or 0.0,
           {k: round(v, 2) for k, v in tr["by_kind_ms_per_step"].items()}, ts["wall_s"],
           {n: round(r["wall_s"], 1) for n, r in ts["runs"].items()}, ts["grads_s"],
           ts["trace_s"]))


# ----------------------------------------------------------------- phase 15
# phase 10's configuration as a pp 2 1F1B pipeline, one layer a stage, and
# the budget of the elastic search at world 1: the analytic estimate of the
# unremat'ed plan is ~24.8 GB and that of one full-remat layer ~17.6 GB, so
# the search must remat to fit
ELASTIC_PP2 = {"pp_deg": 2, "pp_division": "1,1", "pipeline_type": "pipedream_flush",
               "tp_sizes_enc": "1,1", "tp_consecutive_flags": "1,1", "dp_types_enc": "0,0",
               "checkpoint": ",".join(map(str, CKPT_CHECKPOINT)),
               "remat_policy": ",".join(CKPT_REMAT), "global_bsz": 8, "chunks": 2}
ELASTIC_BUDGET_GB = 24.0
ELASTIC_REF_STEPS = 6  # the plain resume from step 3: steps 3-8


class RssPeak:
    """The process's peak resident memory while the context is open,
    sampled from /proc/self/statm every 5 ms (read only)."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _sample(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self._rss())

    def as_dict(self):
        return {"rss_before_gb": self.before / 1e9, "rss_peak_gb": self.peak / 1e9}


def _resume_run(torch, TF, argv, world, load, iteration, steps, save=None):
    """The configuration of `argv` at `world` (= pp; every stage in this
    process) through the model API: restored from step `iteration` of
    `load` (``load_checkpoint(..., target=, allow_cross=True)``: across
    strategies when the step's differs), `steps` steps stepped as ``cli train`` steps them
    (guard on) on the batches of its stream from `iteration`, then saved
    at the end into `save` (one file per stage rank)."""
    import gc

    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.cli.arguments import (
        hp_config_from_args,
        initialize_galvatron,
        model_config_from_args,
    )
    from galvatron_tpu_torch.models import base as M
    from galvatron_tpu_torch.runtime import checkpoint as CK
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.dataloader import build_data_iterator
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.optimizer import get_optimizer_and_scheduler
    from galvatron_tpu_torch.runtime.provenance import build_provenance

    args = initialize_galvatron(argv=argv, mode="train")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with distributed.process_group("cuda") as dev:
        fam, cfg = model_config_from_args(args)
        hp = hp_config_from_args(args, cfg.num_layers, world)
        model = construct_hybrid_parallel_model(cfg, hp, dev,
                                                transport="local" if hp.pp > 1 else "p2p")
        tx, _ = get_optimizer_and_scheduler(cli_train.optimizer_args_from(args))
        params = model.init_params(args.seed + 1)  # overwritten by the restore
        state = model.init_opt_state(tx, params)
        torch.cuda.synchronize()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            _, _, meta = CK.load_checkpoint(load, iteration, params_target=params,
                                            opt_state_target=state, target=model,
                                            allow_cross=True, model_cfg=cfg)
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
        out.update(rss.as_dict(), restore=meta["restore"])
        extra = meta["restore"].get("device_extra_gb")
        if extra is not None:
            # across strategies: the continuity check gathers one leaf at a
            # time, so its device memory beyond the live state stays within
            # a few of the largest leaf
            largest = max(p.numel() * p.element_size()
                          for p in M.TransformerLM(cfg, "meta").parameters()) / 1e9
            out.update(largest_leaf_gb=largest)
            check(extra <= 4 * largest, "the restore's continuity check took %.3f GB of "
                  "device memory beyond the live state (largest leaf %.3f GB)" % (extra, largest))
        check(all(st.count == iteration for st in state.values()),
              "restored Adam counts %s != %d" % ([st.count for st in state.values()], iteration))
        step = model.make_train_step(tx, guard_anomalies=True)
        batches = build_data_iterator(args, fam, cfg, hp, start_step=iteration, device=dev)
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        losses, norms = [], []
        for _ in range(steps):
            params, state, metrics = step(params, state, next(batches))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            check(not metrics["anomalous"], "resumed run: step flagged anomalous")
        out.update(losses=losses, grad_norms=norms, fwd_launches=TF.flash_attention_fwd.launches,
                   bwd_launches=TF.flash_attention_bwd.launches, pp=hp.pp,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if save is not None:
            info = CK.save_checkpoint(
                save, iteration + steps, None, rank_views=model.checkpoint_views(params, state),
                hp=hp, provenance=build_provenance(hp, cfg, cli_train.optimizer_args_from(args)),
                train_meta={"iteration": iteration + steps})
            out["save"] = {k: v for k, v in info.items() if k not in ("items", "ranks")}
        del params, state, step, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def elastic_resume(torch, TF, phase10):
    """Phase 10's checkpoint across pipeline layouts and world sizes (see
    the module note, phase 15); deletes phase 10's step data and corpus and
    this phase's checkpoint at its end."""
    import gc
    import shutil

    from galvatron_tpu_torch.analysis.strategy_lint import estimate_stage_memory_mb
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.runtime import elastic as els

    t0 = time.perf_counter()
    out_dir = os.path.join("chiprun_out", "phase15")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ck10, corpus, pp1 = phase10["ckpt"], phase10["corpus"], phase10["strategy"]
    pp2 = os.path.join(out_dir, "strategy_pp2.json")
    with open(pp2, "w") as f:
        json.dump(ELASTIC_PP2, f)
    ck15 = os.path.join(out_dir, "ckpt")
    per_step = (2 * (CKPT_LAYERS + sum(CKPT_CHECKPOINT)), 2 * CKPT_LAYERS)

    def argv(strategy, extra=()):
        return _phase10_argv(strategy, corpus, ["--train_iters", "9"] + list(extra))

    def launches_ok(name, r, steps, want_per_step=per_step):
        want = (steps * want_per_step[0], steps * want_per_step[1])
        check((r["fwd_launches"], r["bwd_launches"]) == want,
              "%s launched fwd %d / bwd %d, expected %d / %d" % (
                  name, r["fwd_launches"], r["bwd_launches"], want[0], want[1]))

    runs = {}
    try:
        # the reference: phase 10's strategy resumed plainly, steps 3-8
        runs["pp1_plain"] = ref = _resume_run(torch, TF, argv(pp1), 1, ck10, CKPT_INTERVAL,
                                              ELASTIC_REF_STEPS)
        check(not ref["restore"].get("cross_strategy"), "the plain resume went across strategies")
        # its first loss is the restored state's (the later ones follow the
        # schedule of 9 steps, phase 10's of 6)
        first = phase10["resumed_losses"][0]
        check(abs(ref["losses"][0] - first) <= TOL_PP_LOSS * abs(first),
              "the plain resume's first loss %r differs from phase 10's %r" % (
                  ref["losses"][0], first))
        launches_ok("pp1 plain resume", ref, ELASTIC_REF_STEPS)
        # pp 1 -> pp 2: both stages on this card
        runs["pp1_to_pp2"] = r2 = _resume_run(torch, TF, argv(pp2), 2, ck10, CKPT_INTERVAL,
                                              CKPT_STEPS - CKPT_INTERVAL, save=ck15)
        check(r2["restore"].get("cross_strategy") and r2["restore"]["saved_world_size"] == 1,
              "pp 1 -> pp 2 restore: %s" % r2["restore"])
        launches_ok("pp 2 resumed run", r2, CKPT_STEPS - CKPT_INTERVAL)
        errs = {key: [abs(a - b) / abs(b) for a, b in zip(r2[key], ref[key])]
                for key in ("losses", "grad_norms")}
        r2["rel_err"] = errs
        check(max(errs["losses"]) <= TOL_PP_LOSS and max(errs["grad_norms"]) <= TOL_PP_GRAD_NORM,
              "pp 2 resumed run vs the plain resume: losses %s vs %s, norms %s vs %s" % (
                  r2["losses"], ref["losses"], r2["grad_norms"], ref["grad_norms"]))
        # pp 2 -> pp 1 through the CLI (world 2 -> 1), steps 6-8
        gc.collect()
        torch.cuda.empty_cache()
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        with RssPeak() as rss:
            s3 = cli_train.train(cli_train.initialize_galvatron(argv=argv(pp1, [
                "--elastic", "resume", "--elastic_strategy", pp1, "--load", ck15]), mode="train"))
        r3 = runs["pp2_to_pp1_cli"] = dict(
            summary=s3, fwd_launches=TF.flash_attention_fwd.launches,
            bwd_launches=TF.flash_attention_bwd.launches, restore=s3["checkpoint_restore"],
            **rss.as_dict())
        check(r3["restore"].get("cross_strategy") and r3["restore"]["saved_world_size"] == 2
              and r3["restore"]["iteration"] == CKPT_STEPS,
              "pp 2 -> pp 1 restore: %s" % r3["restore"])
        launches_ok("pp 1 CLI resume", r3, 9 - CKPT_STEPS)
        rel = [abs(a - b) / abs(b) for a, b in zip(s3["losses"], ref["losses"][3:])]
        r3["rel_err"] = rel
        check(len(rel) == 3 and max(rel) <= TOL_PP_LOSS,
              "pp 1 CLI resume losses %s vs the plain resume's %s" % (s3["losses"],
                                                                     ref["losses"][3:]))
        # --elastic search at world 1 under the budget: a remat plan that fits
        search_argv = argv(pp1, ["--elastic", "search", "--elastic_memory_gb",
                                 str(ELASTIC_BUDGET_GB), "--load", ck15])
        search_argv[search_argv.index("--train_iters") + 1] = str(CKPT_STEPS + 2)
        args = cli_train.initialize_galvatron(argv=search_argv, mode="train")
        _, cfg = cli_train.model_config_from_args(args)
        plan = els.resolve_resume_strategy(args, cfg, 1)
        est_gb = max(estimate_stage_memory_mb(plan.hp, cfg)) / 1024.0
        check(plan.action == "search" and any(s.checkpoint for s in plan.hp.layers)
              and est_gb <= ELASTIC_BUDGET_GB,
              "elastic search plan %s (estimate %.2f GB, budget %.1f GB)" % (
                  plan.hp.to_json_dict(), est_gb, ELASTIC_BUDGET_GB))
        gc.collect()
        torch.cuda.empty_cache()
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0
        s4 = cli_train.train(args)
        remat = sum(s.checkpoint for s in plan.hp.layers)
        r4 = runs["search"] = dict(
            summary=s4, fwd_launches=TF.flash_attention_fwd.launches,
            bwd_launches=TF.flash_attention_bwd.launches, restore=s4["checkpoint_restore"],
            plan=plan.hp.to_json_dict(), estimate_gb=est_gb, budget_gb=ELASTIC_BUDGET_GB)
        check(len(s4["losses"]) == 2 and all(math.isfinite(x) for x in s4["losses"]),
              "elastic search run losses %s" % s4["losses"])
        launches_ok("elastic search run", r4, 2, (plan.hp.chunks * (CKPT_LAYERS + remat),
                                                  plan.hp.chunks * CKPT_LAYERS))
    finally:
        shutil.rmtree(ck15, ignore_errors=True)
        remove_phase10_data(phase10)
    torch.cuda.empty_cache()
    return dict(runs=runs, tolerance=TOL_PP_LOSS, grad_norm_tolerance=TOL_PP_GRAD_NORM,
                pp2=ELASTIC_PP2, wall_s=time.perf_counter() - t0)


def remove_phase10_data(phase10=None):
    """Phase 10's step data and corpus (~8 GB): the manifests stay."""
    import shutil

    ck = os.path.join("chiprun_out", "phase10", "ckpt")
    if os.path.isdir(ck):
        for d in os.listdir(ck):
            if d.isdigit():
                shutil.rmtree(os.path.join(ck, d), ignore_errors=True)
    for ext in (".bin", ".idx.npy"):
        path = os.path.join("chiprun_out", "phase10", "corpus" + ext)
        if os.path.exists(path):
            os.remove(path)


def log_encoders(enc, card):
    for name, r in enc["runs"].items():
        g = r["summary"]
        vit = name == "vit"
        log("train %s (%s, bf16, global batch %d in 2 micro-batches, %s) on %s: step %.1f ms "
            "end to end, device %.1f ms/step, %.0f %s/s, MFU %.3f (989 TFLOP/s), peak memory "
            "%.1f GB, losses %s, flash launches fwd %d / bwd %d" % (
                "vit-huge" if vit else "bert-large",
                "32 layers, 197 positions" if vit else "24 layers, seq 512",
                64 if vit else 32, {"bert_dp": "every layer plain dp",
                                    "bert_zero3": "layers 0-11 ZeRO-3, the rest ZeRO-2",
                                    "vit": "plain dp, from a %d-image shard" % enc["images"]}[name],
                card, g["steady_step_ms"], g["device_step_ms"],
                g["samples_per_s"] if vit else g["tokens_per_s"], "images" if vit else "tokens",
                g.get("mfu") or float("nan"), g["peak_hbm_mb"] * 2**20 / 1e9,
                ["%.5f" % x for x in g["losses"]], r["fwd_launches"], r["bwd_launches"]))
    log("bert dp vs ZeRO-3/ZeRO-2 losses agree within %.3g relative (tol %.0e)"
        % (max(enc["loss_rel_err"]), enc["tolerance"]))
    for fam, gr in enc["grads"].items():
        log("%s width, depth 2, card (bf16) vs CPU (fp32): loss %.6f vs %.6f, worst gradient %s "
            "at %.3g relative (median %.3g, %d leaves; tol %.0e)" % (
                fam, gr["loss"], gr["loss_cpu"], gr["worst"], gr["worst_rel"], gr["median_rel"],
                gr["leaves"], gr["tolerance"]))
    tr = enc["trace"]
    log("bert-large traced step (torch.profiler, 2 steps) on %s: wall %.1f ms, device busy %.1f "
        "ms, idle share %.3f, plain attention %.1f ms = %.3f of busy, by kind %s; phase %.1f s"
        % (card, tr["wall_ms_per_step"], tr["device_busy_ms_per_step"], tr["idle_share"],
           tr["plain_attention_ms_per_step"], tr["plain_attention_share_of_busy"] or 0.0,
           {k: round(v, 2) for k, v in tr["by_kind_ms_per_step"].items()}, enc["wall_s"]))


def log_elastic(el, card):
    r = el["runs"]
    for name in ("pp1_plain", "pp1_to_pp2"):
        x = r[name]
        log("elastic %s (llama-7b width, 2 layers, from phase 10's step %d) on %s: restore %.2f "
            "s (verify %.2f, move %.2f, continuity %.2f, %s leaves sha256-checked, device "
            "memory %s GB beyond the live state), host RSS %.2f -> peak %.2f GB, losses %s, "
            "gradient norms %s%s, peak memory %.1f GB%s" % (
                name, CKPT_INTERVAL, card, x["restore_s"], x["restore"].get("verify_s", 0.0),
                x["restore"].get("move_s", 0.0), x["restore"].get("continuity_s", 0.0),
                x["restore"].get("leaves_checked", "no"), x["restore"].get("device_extra_gb"),
                x["rss_before_gb"], x["rss_peak_gb"],
                ["%.5f" % v for v in x["losses"]], ["%.5f" % v for v in x["grad_norms"]],
                ", max rel err vs plain: loss %.3g, norm %.3g" % (
                    max(x["rel_err"]["losses"]), max(x["rel_err"]["grad_norms"]))
                if "rel_err" in x else "", x["peak_memory_gb"],
                ", save %.2f GB in %.2f s" % (x["save"]["bytes"] / 1e9, x["save"]["seconds"])
                if "save" in x else ""))
    x = r["pp2_to_pp1_cli"]
    log("elastic pp2 -> pp1 through cli train (world 2 -> 1) on %s: restore %.2f s (%s leaves "
        "sha256-checked, device memory %s GB beyond the live state), host RSS peak %.2f GB "
        "over the run, losses %s (max rel err vs plain %.3g)" % (
            card, x["restore"]["seconds"], x["restore"]["leaves_checked"],
            x["restore"].get("device_extra_gb"), x["rss_peak_gb"],
            ["%.5f" % v for v in x["summary"]["losses"]], max(x["rel_err"])))
    x = r["search"]
    log("elastic search at world 1 under %.1f GB on %s: plan chunks %s, checkpoint %s, "
        "estimate %.2f GB, measured peak %.1f GB, restore %.2f s, losses %s; phase %.1f s" % (
            x["budget_gb"], card, x["plan"]["chunks"], x["plan"].get("checkpoint"),
            x["estimate_gb"], x["summary"]["peak_hbm_mb"] * 2**20 / 1e9,
            x["restore"]["seconds"], ["%.5f" % v for v in x["summary"]["losses"]],
            el["wall_s"]))


# ----------------------------------------------------------------- phase 17
# A fine-tuning user's path at full width: a published model's config.json
# (written here from the published numbers; nothing is downloaded) and HF
# weights made from seeded port parameters rounded to bf16, converted by the
# CLI (h2g), trained and served from the conversion, exported back (g2h).
# LLaMA-7B's numbers with num_hidden_layers cut from 32 to 2 (as phase 10
# cuts it): 0.67 B parameters, a 1.3 GB bf16 model.safetensors, a 2.7 GB
# fp32 params-only checkpoint. T5-large's numbers at full depth.
LLAMA_7B_HF = {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
               "hidden_size": 4096, "intermediate_size": 11008, "num_attention_heads": 32,
               "num_key_value_heads": 32, "num_hidden_layers": 2, "vocab_size": 32000,
               "max_position_embeddings": 2048, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
               "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
T5_LARGE_HF = {"model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
               "d_model": 1024, "d_ff": 4096, "num_heads": 16, "d_kv": 64, "num_layers": 24,
               "num_decoder_layers": 24, "vocab_size": 32128,
               "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
               "feed_forward_proj": "relu", "tie_word_embeddings": True,
               "layer_norm_epsilon": 1e-6}
HF_TRAIN_STEPS = 3
HF_T5_STEPS = 2
HF_SERVE_REQUESTS = 4
HF_CORPUS_LINES = 6000  # ~4.8 MB of seeded text: ~4.8 M byte tokens
# T5 sequence sharding on one card: T5-large width, one encoder and one
# decoder layer, S encoder and decoder tokens, every rank played by this
# process (models.t5.LocalSeq); bf16 card against the unsharded layers on
# the card: the same products in the same dtypes, row and head blocks apart
T5_SEQ = 4096
T5_SEQ_PAD = 256  # the encoder's key-padding tail
T5_SEQ_CASES = (("cp2_zigzag", 2, 1), ("cp4_zigzag", 4, 1), ("ulysses2", 1, 2),
                ("ulysses4", 1, 4))
TOL_T5_SEQ_REL = 2e-2  # per tensor, ||got - want|| / ||want||


def _hf_dir(torch, path, config, params, export):
    """An HF model directory of `params` (the port's state dict): the
    config.json and a bf16 model.safetensors; returns its bytes."""
    from galvatron_tpu_torch.models.hf_utils import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in export(params).items()}
    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    return sd, os.path.getsize(os.path.join(path, "model.safetensors"))


def _seeded_bf16_params(torch, cfg, layers):
    """Seeded port parameters rounded to bf16 (kept fp32), on the host."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    model = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, layers), "cuda")
    out = {n: p.detach().to(torch.bfloat16).float().cpu()
           for n, p in model.init_params(SEED)[0].named_parameters()}
    del model
    torch.cuda.empty_cache()
    return out


def _bitwise(torch, got, want, what):
    """Every tensor of `want` equal in `got`, bit for bit (fp32)."""
    check(sorted(got) == sorted(want), "%s: names differ (%s)" % (
        what, sorted(set(got) ^ set(want))[:4]))
    bad = [n for n, t in want.items() if not torch.equal(got[n].float(), t.float())]
    check(not bad, "%s: %d tensors differ, e.g. %s" % (what, len(bad), bad[:3]))


def hf_finetune(torch, TF):
    """HF checkpoint -> h2g -> train and serve from it -> g2h, for LLaMA-7B
    width (depth 2) and T5-large (see the module note, phase 17)."""
    import gc
    import shutil
    import warnings

    import numpy as np

    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.models import llama as LL
    from galvatron_tpu_torch.models import t5 as T5
    from galvatron_tpu_torch.runtime import checkpoint as CK
    from galvatron_tpu_torch.runtime.model_api import HybridParallelModel
    from galvatron_tpu_torch.tools import convert_checkpoint as CONV
    from galvatron_tpu_torch.tools import tokenize_corpus as TOK
    from galvatron_tpu_torch.tools import train_cell as C

    root = os.path.join("build", "phase17")  # ~25 GB at its largest: kept out of the output dir
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    secs, out = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        secs[name] = time.perf_counter() - t0
        log("phase 17 %s: %.1f s" % (name, secs[name]))
        return r

    def launches():
        return TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches

    def reset():
        gc.collect()
        torch.cuda.empty_cache()
        TF.flash_attention_fwd.launches = 0
        TF.flash_attention_bwd.launches = 0

    import torch.utils.deterministic as det
    prev_det, prev_fill = torch.are_deterministic_algorithms_enabled(), \
        det.fill_uninitialized_memory
    try:
        with RssPeak() as rss, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # ------------------------------------------------ LLaMA-7B width
            hf_dir, ck = os.path.join(root, "llama_hf"), os.path.join(root, "llama_h2g")
            cfg = LL.llama_config_from_hf(_ns_config(LLAMA_7B_HF, "llama"))
            params = step("init", lambda: _seeded_bf16_params(torch, cfg, cfg.num_layers))
            hf_sd, hf_bytes = step("export_hf", lambda: _hf_dir(
                torch, hf_dir, LLAMA_7B_HF, params, lambda p: LL.export_hf_llama(p, cfg)))
            step("h2g", lambda: CONV.main(["h2g", "--model_type", "llama", "--hf_path", hf_dir,
                                           "--output_dir", ck]))
            ck_bytes = sum(os.path.getsize(os.path.join(ck, "0", f))
                           for f in os.listdir(os.path.join(ck, "0")))
            full, meta = step("verify_h2g", lambda: CK.load_full_params(ck, None, cfg))
            items = CK.read_manifest(ck, 0)["items"]
            check(meta.get("source") == "hf" and "params" in items and "opt_state" not in items,
                  "h2g step 0: meta %s, manifest items %s" % (meta, sorted(items)))
            _bitwise(torch, full, params, "h2g params vs the seeded params")
            del full
            corpus_txt = os.path.join(root, "corpus.txt")
            rng = np.random.RandomState(SEED)
            words = ["".join(chr(97 + c) for c in rng.randint(0, 26, n))
                     for n in rng.randint(2, 10, 5000)]
            with open(corpus_txt, "w") as f:
                for _ in range(HF_CORPUS_LINES):
                    f.write(" ".join(words[i] for i in rng.randint(0, len(words), 150)) + "\n")
            prefix = os.path.join(root, "corpus")
            tok = step("tokenize", lambda: TOK.main(["--input", corpus_txt, "--output", prefix,
                                                     "--tokenizer", "bytes", "--append-eod"]))
            # phase 10's depth-2 strategy (layer 0 full remat, layer 1
            # dots_saveable) at phase 8's batch
            argv = _llama_argv(_layers_strategy(
                os.path.join(root, "strategy.json"), CKPT_CHECKPOINT, CKPT_REMAT,
                [0] * cfg.num_layers), cfg.num_layers, HF_TRAIN_STEPS,
                ["--data_path", prefix, "--split", "1,0,0"])
            torch.use_deterministic_algorithms(True, warn_only=True)
            det.fill_uninitialized_memory = False
            reset()
            trained_ck = os.path.join(root, "llama_trained")
            loaded = step("train_load", lambda: cli_train.main(argv + [
                "--train_iters", str(HF_TRAIN_STEPS), "--load", ck, "--save", trained_ck]))
            train_launches = launches()
            reset()
            orig_init = HybridParallelModel.init_params
            HybridParallelModel.init_params = lambda self, seed: self.shard_params(params)
            try:
                memory = step("train_memory", lambda: cli_train.main(argv + [
                    "--train_iters", str(HF_TRAIN_STEPS)]))
            finally:
                HybridParallelModel.init_params = orig_init
            torch.use_deterministic_algorithms(prev_det)
            det.fill_uninitialized_memory = prev_fill
            check(loaded["checkpoint_restore"].get("params_only")
                  and len(loaded["losses"]) == HF_TRAIN_STEPS
                  and all(math.isfinite(x) for x in loaded["losses"]),
                  "train --load of the conversion: %s, losses %s" % (
                      loaded.get("checkpoint_restore"), loaded["losses"]))
            check(loaded["losses"] == memory["losses"],
                  "losses from the conversion %r != from the in-memory params %r (a fresh "
                  "optimizer in both)" % (loaded["losses"], memory["losses"]))
            want = (HF_TRAIN_STEPS * 2 * (cfg.num_layers + sum(CKPT_CHECKPOINT)),
                    HF_TRAIN_STEPS * 2 * cfg.num_layers)
            check(train_launches == want, "train --load launched %s, expected %s"
                  % (train_launches, want))
            reset()
            served = step("serve_load", lambda: cli_serve.main(SERVE_ARGV + [
                "--set_layernum_manually", "1", "--num_layers", str(cfg.num_layers),
                "--num_requests", str(HF_SERVE_REQUESTS), "--load", ck]))
            serve_launches = launches()
            check(served["requests"] == HF_SERVE_REQUESTS and served["shed"] == 0
                  and serve_launches[0] > 0 and serve_launches[1] == 0,
                  "serve --load: %d requests, shed %d, launches %s" % (
                      served["requests"], served["shed"], serve_launches))
            back = os.path.join(root, "llama_back.bin")
            step("g2h", lambda: CONV.main(["g2h", "--model_type", "llama", "--hf_config_path",
                                           hf_dir, "--checkpoint_dir", ck, "--output_path", back]))
            got = torch.load(back, map_location="cpu", weights_only=True, mmap=True)
            _bitwise(torch, got, hf_sd, "g2h of step 0 vs the HF file")
            del got
            os.remove(back)
            step("g2h_trained", lambda: CONV.main([
                "g2h", "--model_type", "llama", "--hf_config_path", hf_dir, "--checkpoint_dir",
                trained_ck, "--output_path", back]))
            got = torch.load(back, map_location="cpu", weights_only=True, mmap=True)
            trained, _ = CK.load_full_params(trained_ck, None, cfg)
            check(torch.equal(got["model.norm.weight"], trained["final_norm.scale"])
                  and not torch.equal(got["model.norm.weight"], hf_sd["model.norm.weight"].float()),
                  "g2h of the trained step does not hold the trained norm")
            del got, trained, hf_sd, params
            os.remove(back)
            for path in (ck, trained_ck, hf_dir):
                shutil.rmtree(path)
            out["llama"] = dict(
                hf_gb=hf_bytes / 1e9, ckpt_gb=ck_bytes / 1e9,
                h2g_gbps=hf_bytes / 1e9 / secs["h2g"], losses=loaded["losses"],
                memory_losses=memory["losses"], restore=loaded["checkpoint_restore"],
                step_ms=loaded["steady_step_ms"], tokens=tok,
                launches={"train": train_launches, "serve": serve_launches},
                serve=served)
            # --------------------------------------------------- T5-large
            hf_dir, ck = os.path.join(root, "t5_hf"), os.path.join(root, "t5_h2g")
            tcfg = T5.t5_config_from_hf(_ns_config(T5_LARGE_HF, "t5"))
            params = step("t5_init", lambda: _seeded_bf16_params(torch, tcfg, tcfg.num_layers))
            hf_sd, t5_bytes = step("t5_export_hf", lambda: _hf_dir(
                torch, hf_dir, T5_LARGE_HF, params, lambda p: T5.export_hf_t5(p, tcfg)))
            step("t5_h2g", lambda: CONV.main(["h2g", "--model_type", "t5", "--hf_path", hf_dir,
                                              "--output_dir", ck]))
            full, _ = CK.load_full_params(ck, None, tcfg)
            _bitwise(torch, full, params, "t5 h2g params vs the seeded params")
            del full, params
            reset()
            t5_run = step("t5_train_load", lambda: cli_train.main(C.t5_argv(
                C.write_t5_strategy(root), prefix) + ["--train_iters", str(HF_T5_STEPS),
                                                      "--lr_warmup_iters", "1", "--load", ck]))
            t5_launches = launches()
            check(t5_launches == (0, 0) and len(t5_run["losses"]) == HF_T5_STEPS
                  and all(math.isfinite(x) for x in t5_run["losses"])
                  and t5_run["checkpoint_restore"].get("params_only"),
                  "t5 train --load: losses %s, launches %s" % (t5_run["losses"], t5_launches))
            back = os.path.join(root, "t5_back.bin")
            step("t5_g2h", lambda: CONV.main(["g2h", "--model_type", "t5", "--hf_config_path",
                                              hf_dir, "--checkpoint_dir", ck, "--output_path",
                                              back]))
            got = torch.load(back, map_location="cpu", weights_only=True, mmap=True)
            _bitwise(torch, got, hf_sd, "t5 g2h of step 0 vs the HF file")
            del got, hf_sd
            out["t5"] = dict(hf_gb=t5_bytes / 1e9, losses=t5_run["losses"],
                             step_ms=t5_run["steady_step_ms"], launches=t5_launches,
                             h2g_gbps=t5_bytes / 1e9 / secs["t5_h2g"])
    finally:
        torch.use_deterministic_algorithms(prev_det)
        det.fill_uninitialized_memory = prev_fill
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    reset()
    seq = step("t5_seq_sharding", lambda: t5_seq_sharding(torch, TF))
    out.update(seq=seq, seconds=secs, rss=rss.as_dict(), wall_s=time.perf_counter() - t_phase,
               runs={"hf_llama_train": dict(fwd_launches=out["llama"]["launches"]["train"][0],
                                            bwd_launches=out["llama"]["launches"]["train"][1]),
                     "hf_llama_serve": dict(fwd_launches=out["llama"]["launches"]["serve"][0],
                                            bwd_launches=0),
                     "hf_t5_train": dict(fwd_launches=0, bwd_launches=0),
                     "t5_seq_sharding": dict(fwd_launches=seq["launches"][0],
                                             bwd_launches=seq["launches"][1])})
    return out


def _ns_config(config, family):
    """A hand-written config.json's namespace (``read_hf_config``)."""
    import tempfile

    from galvatron_tpu_torch.models.hf_utils import read_hf_config

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        return read_hf_config(d, family)


def t5_seq_sharding(torch, TF, dev="cuda", n=T5_SEQ, pad=T5_SEQ_PAD, size="t5-large",
                    timer=None):
    """T5-large width, one encoder and one decoder layer on `n` tokens: cp
    (zigzag order) and the Ulysses head split with every rank played by
    this process, forward and backward, against the unsharded layers."""
    from galvatron_tpu_torch.models import t5 as T5
    from galvatron_tpu_torch.ops.ring_attention import zigzag_permutation

    cfg = T5.t5_config(size, num_enc_layers=1, num_dec_layers=1)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = T5.init_t5_params(cfg, gen, dev)
    enc, dec = model.enc_layers["0"], model.dec_layers["0"]
    h = cfg.hidden_size
    timer = timer or (lambda fn: time_ms(torch, fn, reps=3, warmup=0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, y, mem = (randn(1, n, h).to(cfg.compute_dtype) for _ in range(3))
    g_enc, g_dec = randn(1, n, h), randn(1, n, h)
    kb = torch.zeros(1, 1, 1, n, device=dev)
    kb[..., n - pad:] = -1e9
    leaves = dict(model.named_parameters())

    def run(cp, tp, zigzag):
        """(outputs and gradients by name, ms of one forward + backward)."""
        play = T5.LocalSeq(cp, tp) if cp * tp > 1 else None
        order = torch.as_tensor(zigzag_permutation(n, cp), device=dev) if zigzag else \
            torch.arange(n, device=dev)
        inv = torch.argsort(order)
        ins = {k: t.detach().clone().requires_grad_() for k, t in (("x", x), ("y", y),
                                                                   ("mem", mem))}

        def fwd():
            xs, ys = ins["x"][:, order], ins["y"][:, order]
            if play is None:
                be = T5.rel_bias(model.enc_rel_bias, n, n, cfg, bidirectional=True) + kb
                bd = T5.rel_bias(model.dec_rel_bias, n, n, cfg, bidirectional=False)
                oe = T5.enc_layer_forward(enc, xs, cfg, be)
                od = T5.dec_layer_forward(dec, ys, ins["mem"], cfg, bd, kb)
            else:
                r = cp * tp
                be = play.bias(model.enc_rel_bias, order, 1, cfg, bidirectional=True,
                               key_bias=kb[..., order])
                bd = play.bias(model.dec_rel_bias, order, 1, cfg, bidirectional=False)
                oe = play.rank_unshard(T5.enc_layer_forward(enc, play.rank_shards(xs), cfg, be,
                                                            seq=play))
                od = play.rank_unshard(T5.dec_layer_forward(
                    dec, play.rank_shards(ys), ins["mem"].expand(r, n, h), cfg, bd,
                    kb.expand(r, 1, 1, n), seq=play))
            oe, od = oe[:, inv], od[:, inv]
            loss = (oe.float() * g_enc).sum() + (od.float() * g_dec).sum()
            return oe, od, loss

        def once():
            for p in leaves.values():
                p.grad = None
            for t in ins.values():
                t.grad = None
            oe, od, loss = fwd()
            loss.backward()
            return oe, od
        once()  # warm-up
        ms = timer(once)
        oe, od = once()
        got = {"enc_out": oe.detach().float(), "dec_out": od.detach().float()}
        got.update({"d_" + k: t.grad.float() for k, t in ins.items()})
        got.update({k: p.grad.float() for k, p in leaves.items() if p.grad is not None})
        return got, ms

    TF.flash_attention_fwd.launches = 0
    TF.flash_attention_bwd.launches = 0
    want, ms_ref = run(1, 1, False)
    cases = {}
    for name, cp, tp in T5_SEQ_CASES:
        got, ms = run(cp, tp, name.endswith("zigzag"))
        check(sorted(got) == sorted(want), "%s: gradients of %s" % (name, sorted(got)))
        rel = {k: float((got[k] - w).norm() / w.norm().clamp(min=1e-30)) for k, w in want.items()}
        worst = max(rel, key=rel.get)
        check(rel[worst] <= TOL_T5_SEQ_REL, "t5 %s on one card: %s off the unsharded layers "
              "by %.3g relative (tol %.0e)" % (name, worst, rel[worst], TOL_T5_SEQ_REL))
        cases[name] = dict(cp=cp, tp=tp, ms=ms, ratio=ms / ms_ref, worst=worst,
                           worst_rel=rel[worst])
    fl = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)
    check(fl == (0, 0), "t5 sequence sharding launched the flash kernels %s times" % (fl,))
    del model, want
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(seq=n, unsharded_ms=ms_ref, cases=cases, launches=fl, tolerance=TOL_T5_SEQ_REL)


def log_hf_finetune(hf, card):
    s, l5, l7 = hf["seconds"], hf["t5"], hf["llama"]
    log("phase 17 llama-7b width (%d layers) from HF on %s: init %.1f s, export %.2f GB bf16 "
        "safetensors %.1f s, h2g %.1f s (%.2f GB/s of HF file; %.2f GB fp32 params-only step), "
        "h2g params bitwise (checked in %.1f s), tokenize %.1f s (%d docs, %d tokens), train "
        "--load %d steps %.1f s (step %.1f ms, losses %s; restore %.1f s), losses bitwise "
        "equal to the in-memory run's (%s, %.1f s), serve --load %d requests %.1f s (%.1f "
        "tok/s), g2h step 0 %.1f s (bitwise), g2h trained step %.1f s; flash launches train "
        "fwd %d / bwd %d, serve fwd %d" % (
            LLAMA_7B_HF["num_hidden_layers"], card, s["init"], l7["hf_gb"], s["export_hf"],
            s["h2g"], l7["h2g_gbps"], l7["ckpt_gb"],
            s["verify_h2g"], s["tokenize"], l7["tokens"]["n_docs"], l7["tokens"]["n_tokens"],
            HF_TRAIN_STEPS, s["train_load"], l7["step_ms"], ["%.5f" % x for x in l7["losses"]],
            l7["restore"]["seconds"], ["%r" % x for x in l7["memory_losses"]], s["train_memory"],
            l7["serve"]["requests"], s["serve_load"], l7["serve"]["tokens_per_s"], s["g2h"],
            s["g2h_trained"], l7["launches"]["train"][0], l7["launches"]["train"][1],
            l7["launches"]["serve"][0]))
    log("phase 17 t5-large from HF: export %.2f GB %.1f s, h2g %.1f s (%.2f GB/s), h2g params "
        "bitwise, train --load %d steps %.1f s (step %.1f ms, losses %s), g2h step 0 %.1f s "
        "(bitwise), flash launches %s" % (
            l5["hf_gb"], s["t5_export_hf"], s["t5_h2g"], l5["h2g_gbps"], HF_T5_STEPS,
            s["t5_train_load"], l5["step_ms"], ["%.5f" % x for x in l5["losses"]], s["t5_g2h"],
            l5["launches"]))
    q = hf["seq"]
    log("phase 17 t5-large width, 1 + 1 layers, S=%d, every rank on %s: unsharded fwd+bwd "
        "%.2f ms; %s; flash launches %s" % (
            q["seq"], card, q["unsharded_ms"], "; ".join(
                "%s %.2f ms (x%.3f, worst %s %.3g rel)" % (k, c["ms"], c["ratio"], c["worst"],
                                                           c["worst_rel"])
                for k, c in q["cases"].items()), q["launches"]))
    log("phase 17 host RSS %.2f -> peak %.2f GB; phase %.1f s" % (
        hf["rss"]["rss_before_gb"], hf["rss"]["rss_peak_gb"], hf["wall_s"]))



# ----------------------------------------------------------------- phase 18
# the silent-corruption sentinel's fold kernel and the resilience paths
FOLD_SOURCE = "galvatron_tpu_torch/csrc/tree_fold.cu"
FOLD_REPLACES = "galvatron_tpu/runtime/sdc.py:76"  # tree_fold_metrics (a jnp loop, no Pallas)
SDC_STEPS = 4  # b: the train cell (phase 8's configuration) with and without the digest
MIG_LAYERS, MIG_STEPS, MIG_AT = 2, 5, 2  # d: SIGUSR1 at step 2 of 5
MIG_FSDP = [1, 0]  # layer 0 ZeRO-3, layer 1 ZeRO-2 (default zero2) -> all ZeRO-2
AUTOTUNE_LAYERS, AUTOTUNE_STEPS = 4, 16  # e: every layer under full remat at the start
AUTOTUNE_BUDGET_GB = 70.0
HANG_AT, HANG_S = 4, 4.0  # c: the step call that sleeps, and for how long
SERVE_HANG_AT = 6  # f: the decode tick that sleeps HANG_S
# one full-width LLaMA-7B layer (embedding and head at the full vocab: its
# checkpoint with the Adam moments is 6.4 GB): the hang drill
DRILL_FLAGS = ["--device", "cuda", "--hidden_size", "4096", "--num_attention_heads", "32",
               "--ffn_hidden_size", "11008", "--vocab_size", "32000", "--seq_length", "2048",
               "--num_layers", "1", "--mixed_precision", "bf16",
               "--global_train_batch_size", "2", "--chunks", "1", "--lr", "1e-4"]
WATCHDOG_FLAGS = ["--watchdog", "1", "--watchdog_factor", "2", "--watchdog_startup_s", "300"]


def _layers_strategy(path, checkpoint, remat, fsdp, default_dp_type="ddp", chunks=2):
    n = len(checkpoint)
    with open(path, "w") as f:
        json.dump({"pp_deg": 1, "tp_sizes_enc": ",".join(["1"] * n),
                   "tp_consecutive_flags": ",".join(["1"] * n),
                   "dp_types_enc": ",".join(map(str, fsdp)), "default_dp_type": default_dp_type,
                   "checkpoint": ",".join(map(str, checkpoint)), "remat_policy": ",".join(remat),
                   "global_bsz": 8, "chunks": chunks}, f)
    return path


def _llama_argv(strategy, layers, steps, extra=()):
    return ["--model_type", "llama", "--model_size", "llama-7b", "--set_layernum_manually", "1",
            "--num_layers", str(layers), "--mixed_precision", "bf16", "--device", "cuda",
            "--global_train_batch_size", "8", "--chunks", "2", "--galvatron_config_path",
            strategy, "--train_iters", str(steps), "--lr", "1e-4", "--lr_warmup_iters", "2",
            "--seed", str(SEED)] + list(extra)


class _Deterministic:
    """``torch.use_deterministic_algorithms`` (warn only, uninitialized
    memory not filled) while open: two runs of one configuration give the
    same losses bit for bit (phase 10's condition)."""

    def __init__(self, torch):
        import torch.utils.deterministic as det

        self.torch, self.det = torch, det

    def __enter__(self):
        self.prev = (self.torch.are_deterministic_algorithms_enabled(),
                     self.det.fill_uninitialized_memory)
        self.torch.use_deterministic_algorithms(True, warn_only=True)
        self.det.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.prev[0])
        self.det.fill_uninitialized_memory = self.prev[1]


def _train_with_hooks(argv, hooks):
    from galvatron_tpu_torch.cli import train as cli_train

    args = cli_train.initialize_galvatron(argv=argv, mode="train")
    args.fault_hooks = hooks
    return cli_train.train(args)


def _launch_counts(TF, TFold):
    return (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches,
            TFold.tree_fold.launches)


def _reset_counts(torch, TF, TFold):
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    TF.flash_attention_fwd.launches = TF.flash_attention_bwd.launches = 0
    TFold.tree_fold.launches = 0


def fold_kernel(torch):
    """Phase 18a: the fold kernel against its plain version on the card,
    bitwise, on leaves of every width and kind, odd lengths, an empty leaf,
    all of them as one tree, and the LLaMA-7B-width depth-8 parameter
    tree; a planted bit flip must change the fold. Times the kernel on the
    depth-8 tree beside its bound, the plain version and two library
    reductions over the same bytes."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models import llama as LL
    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(n, dtype):
        return torch.randn(n, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, n, dtype):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    leaves = {
        "fp32": randn(1_000_003, torch.float32), "bf16": randn(777_777, torch.bfloat16),
        "fp16": randn(4097, torch.float16), "fp64": randn(1023, torch.float64),
        "int32": randint(-2**31, 2**31 - 1, 123_457, torch.int32),
        "int64": randint(-2**62, 2**62, 54_321, torch.int64),
        "uint8": randint(0, 256, 333, torch.uint8),
        "bool": torch.rand(4099, generator=gen, device=dev) > 0.5,
        "empty": torch.zeros(0, device=dev),
    }
    cases = {name: [t] for name, t in leaves.items()}
    cases["all"] = list(leaves.values())
    rows = {}
    for name, tree in cases.items():
        n0 = TFold.tree_fold.launches
        fold, sumsq = TFold.tree_fold(tree)
        launched = TFold.tree_fold.launches - n0
        ref_fold, ref_sumsq = TFold.tree_fold_reference(tree)
        check(int(fold) == int(ref_fold), "fold kernel %s: 0x%08x != plain 0x%08x"
              % (name, int(fold), int(ref_fold)))
        check(launched == (1 if any(t.numel() for t in tree) else 0),
              "fold kernel %s launched %d times" % (name, launched))
        rows[name] = dict(fold=int(fold), launches=launched,
                          sumsq_rel_err=abs(float(sumsq) - float(ref_sumsq))
                          / max(abs(float(ref_sumsq)), 1e-30))
    flipped = leaves["fp32"].clone()
    flipped.view(torch.int32)[500_000] ^= 1 << 18
    clean = int(TFold.tree_fold([leaves["fp32"]])[0])
    check(int(TFold.tree_fold([flipped])[0]) != clean, "a planted bit flip left the fold as it was")
    del leaves, cases, flipped

    cfg = LL.llama_config("llama-7b", num_layers=8)
    model = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, 8), "cuda")
    tree = list(model.init_params(SEED)[0].parameters())
    nbytes = TFold.tree_bytes(tree)
    fold, sumsq = TFold.tree_fold(tree)
    ref_fold, ref_sumsq = TFold.tree_fold_reference(tree)
    check(int(fold) == int(ref_fold), "fold kernel on the depth-8 tree: 0x%08x != plain 0x%08x"
          % (int(fold), int(ref_fold)))
    rows["llama7b_depth8"] = dict(fold=int(fold), launches=1, bytes=nbytes,
                                  sumsq_rel_err=abs(float(sumsq) - float(ref_sumsq))
                                  / max(abs(float(ref_sumsq)), 1e-30))
    ms = time_stream_ms(torch, lambda: TFold.tree_fold(tree))
    ms_single = time_ms(torch, lambda: TFold.tree_fold(tree))
    plain_ms = time_ms(torch, lambda: TFold.tree_fold_reference(tree), reps=3, warmup=1)
    flat = torch.cat([p.detach().reshape(-1) for p in tree])
    lib_fold_ms = time_stream_ms(torch, lambda: flat.view(torch.int32).sum(dtype=torch.int64))
    lib_sumsq_ms = time_stream_ms(torch, lambda: flat.float().square().sum())
    del flat, tree, model
    TFold.tree_fold.launches = 0  # the comparisons count on no path
    torch.cuda.empty_cache()
    bound = nbytes / H100_BYTES_PER_S * 1e3
    return dict(rows=rows, bytes=nbytes, ms=ms, ms_single=ms_single, plain_ms=plain_ms,
                library_ms=lib_fold_ms + lib_sumsq_ms,
                library_calls={"view(int32).sum(dtype=int64)": lib_fold_ms,
                               "float().square().sum()": lib_sumsq_ms},
                bound_ms=bound, bound_by="bytes", share_of_bound=bound / ms,
                wall_s=time.perf_counter() - t0)


def sdc_digest(torch, TF):
    """Phase 18b: the train cell through ``cli.train.main`` without and
    with ``--sdc_check digest`` (deterministic algorithms in both): the
    losses bit for bit, one fold launch per step, the step time of each."""
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.tools import train_cell as C

    t0 = time.perf_counter()
    argv = C.argv(C.write_strategy(os.path.join("build", "phase18")))
    argv[argv.index("--train_iters") + 1] = str(SDC_STEPS)
    runs = {}
    with _Deterministic(torch):
        for name, extra in (("plain", []), ("digest", ["--sdc_check", "digest"])):
            _reset_counts(torch, TF, TFold)
            summary = cli_train.main(argv + extra)
            fwd, bwd, folds = _launch_counts(TF, TFold)
            runs[name] = dict(summary=summary, fwd_launches=fwd, bwd_launches=bwd,
                              fold_launches=folds)
    plain, digest = runs["plain"], runs["digest"]
    check(digest["summary"]["losses"] == plain["summary"]["losses"],
          "digest losses %r != the plain run's %r" % (digest["summary"]["losses"],
                                                       plain["summary"]["losses"]))
    check(digest["fold_launches"] == SDC_STEPS and plain["fold_launches"] == 0,
          "fold launches: digest %d (expected %d, one per step), plain %d"
          % (digest["fold_launches"], SDC_STEPS, plain["fold_launches"]))
    check(digest["summary"]["resilience"]["sdc_checks"] == SDC_STEPS,
          "sdc_checks %s" % digest["summary"]["resilience"])
    remat = sum(C.CHECKPOINT)
    want = (SDC_STEPS * C.CHUNKS * (C.LAYERS + remat), SDC_STEPS * C.CHUNKS * C.LAYERS)
    for name, r in runs.items():
        check((r["fwd_launches"], r["bwd_launches"]) == want,
              "sdc %s run launched %s, expected %s" % (name, (r["fwd_launches"],
                                                           r["bwd_launches"]), want))
    return dict(runs=runs, steps=SDC_STEPS, layers=C.LAYERS,
                overhead_ms=digest["summary"]["steady_step_ms"]
                - plain["summary"]["steady_step_ms"], wall_s=time.perf_counter() - t0)


def hang_exit(torch, TF):
    """Phase 18c: a subprocess (``tests/torch_fault_injection.py --scenario
    hang``) trains one full-width LLaMA-7B layer under ``--watchdog``; step
    call 4 sleeps 4 s after its work: the watchdog fires, escalates, the
    loop makes an emergency save at the next boundary and the process exits
    3; then ``cli train --load --elastic resume`` here continues from that
    save to the end."""
    import shutil

    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.runtime import checkpoint as CK
    from tests import torch_fault_injection as FI

    t0 = time.perf_counter()
    root = os.path.join("build", "phase18")
    ckdir = os.path.join(root, "hang")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    steps = 8
    env = dict(os.environ, PYTHONPATH=os.getcwd() + os.pathsep + os.environ.get("PYTHONPATH", ""))
    try:
        t_sub = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join("tests", "torch_fault_injection.py"), "--scenario",
             "hang", "--train_iters", str(steps), "--save", ckdir, "--hang_at", str(HANG_AT),
             "--hang_s", str(HANG_S), "--"] + DRILL_FLAGS + WATCHDOG_FLAGS
            + ["--inflight_steps", "0"], capture_output=True, text=True, timeout=600, env=env)
        sub_s = time.perf_counter() - t_sub
        check(proc.returncode == 3, "the hang drill exited %d, expected 3:\n%s\n%s" % (
            proc.returncode, proc.stdout[-3000:], proc.stderr[-3000:]))

        def line(key):
            return json.loads(next(x for x in proc.stdout.splitlines()
                                   if x.startswith(key + "=")).split("=", 1)[1])

        sub = line("SUMMARY")
        hung = line("LOSSES")
        saved = CK.intact_iterations(ckdir)
        check(sub["interrupted"] == "watchdog" and sub["watchdog"]["escalated"]
              and sub["resilience"]["emergency_saves"] == 1 and saved == [len(hung)],
              "hang drill: %s, saved steps %s, %d losses" % (sub, saved, len(hung)))
        _reset_counts(torch, TF, TFold)
        t_res = time.perf_counter()
        resumed = _train_with_hooks(FI.tiny_train_argv(steps, load=ckdir, extra=DRILL_FLAGS
                                                       + ["--elastic", "resume"]), None)
        res_s = time.perf_counter() - t_res
        fwd, bwd, _ = _launch_counts(TF, TFold)
        left = steps - saved[0]
        check(resumed["checkpoint_restore"]["iteration"] == saved[0]
              and len(resumed["losses"]) == left
              and all(math.isfinite(x) for x in resumed["losses"]) and (fwd, bwd) == (left, left),
              "resume after the hang: restore %s, losses %s, launches %s" % (
                  resumed.get("checkpoint_restore"), resumed["losses"], (fwd, bwd)))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return dict(watchdog=sub["watchdog"], hung_losses=hung, saved=saved[0],
                resumed_losses=resumed["losses"], subprocess_s=sub_s, resume_s=res_s,
                fwd_launches=fwd, bwd_launches=bwd, wall_s=time.perf_counter() - t0)


def live_migration(torch, TF):
    """Phase 18d: LLaMA-7B width at depth 2, layer 0 ZeRO-3 and layer 1
    ZeRO-2 (one-rank NCCL groups): SIGUSR1 at step 2 migrates the live
    state in memory to every layer ZeRO-2 (``--elastic_strategy``, the
    digest's continuity held across it) and trains on to step 5; against
    it, a run that saves at step 2 and ``cli train --elastic resume`` of that
    save under the same target. The steps before the swap equal the saving
    run's and the steps after it the resumed run's, bit for bit
    (deterministic algorithms)."""
    import shutil

    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    t0 = time.perf_counter()
    root = os.path.join("build", "phase18")
    os.makedirs(root, exist_ok=True)
    ck = os.path.join(root, "migrate")
    shutil.rmtree(ck, ignore_errors=True)
    remat = ["full", "dots_saveable"]
    source = _layers_strategy(os.path.join(root, "mig_from.json"), [1, 1], remat, MIG_FSDP,
                              "zero2")
    target = _layers_strategy(os.path.join(root, "mig_to.json"), [1, 1], remat,
                              [0] * MIG_LAYERS, "zero2")
    sent = {"done": False}

    def on_step(it):
        if it == MIG_AT and not sent["done"]:
            sent["done"] = True
            os.kill(os.getpid(), signal.SIGUSR1)

    def on_term(it):
        if it == MIG_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    runs = {}
    try:
        with _Deterministic(torch):
            _reset_counts(torch, TF, TFold)
            runs["migrated"] = _train_with_hooks(_llama_argv(
                source, MIG_LAYERS, MIG_STEPS, ["--elastic_strategy", target, "--sdc_check",
                                                "digest"]), FaultHooks(on_step=on_step))
            launches = _launch_counts(TF, TFold)
            # the same run (its schedule is the migrated run's) stopped by
            # SIGTERM at the swap's boundary: one emergency save there
            runs["saved"] = _train_with_hooks(_llama_argv(source, MIG_LAYERS, MIG_STEPS,
                                                          ["--save", ck]),
                                              FaultHooks(on_step=on_term))
            runs["resumed"] = _train_with_hooks(_llama_argv(
                source, MIG_LAYERS, MIG_STEPS, ["--load", ck, "--elastic", "resume",
                                                "--elastic_strategy", target]), None)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    m = runs["migrated"]
    mig = m.get("migrations") or [{}]
    check([(x.get("reason"), x.get("iteration")) for x in mig] == [("sigusr1", MIG_AT)],
          "migrations %s" % mig)
    check(m["losses"][:MIG_AT] == runs["saved"]["losses"]
          and m["losses"][MIG_AT:] == runs["resumed"]["losses"]
          and runs["resumed"]["checkpoint_restore"].get("cross_strategy"),
          "migrated losses %r vs saved %r + resumed %r" % (
              m["losses"], runs["saved"]["losses"], runs["resumed"]["losses"]))
    want = (MIG_STEPS * 2 * 2 * MIG_LAYERS, MIG_STEPS * 2 * MIG_LAYERS)
    check(launches[:2] == want, "the migrated run launched %s, expected %s" % (launches[:2], want))
    return dict(losses=m["losses"], seconds=mig[0]["seconds"],
                device_extra_gb=mig[0]["device_extra_gb"], fwd_launches=launches[0],
                bwd_launches=launches[1], fold_launches=launches[2],
                step_ms=m["steady_step_ms"], wall_s=time.perf_counter() - t0)


def autotune_swap(torch, TF):
    """Phase 18e: LLaMA-7B width at depth 4 from a misspecified start (every
    layer under full remat) with ``--autotune apply``: once the step time
    settles, the re-search on the measured tables swaps once, in memory, to
    its winner, and the next epoch finds it identical."""
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.ops import tree_fold as TFold

    t0 = time.perf_counter()
    root = os.path.join("build", "phase18")
    os.makedirs(root, exist_ok=True)
    strategy = _layers_strategy(os.path.join(root, "autotune_start.json"),
                                [1] * AUTOTUNE_LAYERS, ["full"] * AUTOTUNE_LAYERS,
                                [0] * AUTOTUNE_LAYERS)
    _reset_counts(torch, TF, TFold)
    summary = cli_train.main(_llama_argv(strategy, AUTOTUNE_LAYERS, AUTOTUNE_STEPS, [
        "--autotune", "apply", "--autotune_window", "3", "--autotune_rel_std", "0.1",
        "--elastic_memory_gb", str(AUTOTUNE_BUDGET_GB)]))
    fwd, bwd, _ = _launch_counts(TF, TFold)
    a = summary["autotune"]
    epochs = a["epochs"]
    check(a["swaps"] == 1 and epochs and epochs[0]["swapped"] and len(epochs) >= 2
          and not any(e["swapped"] for e in epochs[1:]),
          "autotune: %s" % json.dumps(a))
    check(len(summary["losses"]) == AUTOTUNE_STEPS
          and all(math.isfinite(x) for x in summary["losses"]), "losses %s" % summary["losses"])
    winner = summary["strategy"]
    return dict(epochs=epochs, strategy=winner, losses=summary["losses"],
                migration=summary["migrations"][0], predicted_ms=epochs[0]["winner_ms"],
                incumbent_ms=epochs[0]["incumbent_ms"],
                measured_before_ms=epochs[0]["steady_step_ms"],
                measured_after_ms=epochs[1]["steady_step_ms"], fwd_launches=fwd,
                bwd_launches=bwd, wall_s=time.perf_counter() - t0)


def serve_drains(torch, TF):
    """Phase 18f: ``cli serve`` with ``--watchdog`` on one full-width
    LLaMA-7B layer: decode tick 6 sleeps 4 s, the batcher drains and
    ``main`` exits 3; then SIGTERM at decode step 3 drains and ``main``
    returns (exit 0)."""
    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    t0 = time.perf_counter()
    argv = SERVE_ARGV + ["--set_layernum_manually", "1", "--num_layers", "1", "--num_requests",
                         "4", "--prompt_len_max", "300", "--max_new_tokens", "16"] \
        + WATCHDOG_FLAGS
    calls = {"n": 0}

    def wrap(fn):
        def stalled(*a, **kw):
            out = fn(*a, **kw)
            if calls["n"] == SERVE_HANG_AT:
                time.sleep(HANG_S)
            calls["n"] += 1
            return out
        return stalled

    def on_step(tick):
        if tick == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    out, seen = {}, {}
    orig_parse, orig_serve = cli_serve.initialize_galvatron, cli_serve.serve
    for name, hooks in (("hang", FaultHooks(wrap_step_fn=wrap)),
                        ("sigterm", FaultHooks(on_step=on_step))):
        def parse(argv=None, mode="serve", hooks=hooks):
            args = orig_parse(argv=argv, mode=mode)
            args.fault_hooks = hooks
            return args

        def serve(args):
            seen["summary"] = orig_serve(args)
            return seen["summary"]

        cli_serve.initialize_galvatron, cli_serve.serve = parse, serve
        _reset_counts(torch, TF, TFold)
        code = 0
        try:
            cli_serve.main(argv)
        except SystemExit as e:
            code = e.code
        finally:
            cli_serve.initialize_galvatron, cli_serve.serve = orig_parse, orig_serve
        s = seen.pop("summary")
        out[name] = dict(exit_code=code, drain=s["drain"], requests=s["requests"],
                         shed=s["shed"], watchdog=s.get("watchdog"),
                         fwd_launches=TF.flash_attention_fwd.launches)
    h, t = out["hang"], out["sigterm"]
    check(h["exit_code"] == 3 and h["drain"] == "watchdog" and h["watchdog"]["escalated"]
          and h["requests"] + h["shed"] == 4, "serve hang drill: %s" % h)
    check(t["exit_code"] == 0 and t["drain"] == "SIGTERM" and t["requests"] + t["shed"] == 4
          and not (t["watchdog"] or {}).get("escalated"), "serve SIGTERM drill: %s" % t)
    out["wall_s"] = time.perf_counter() - t0
    return out


def serve_mig_paths(sm):
    """Phase 19's paths with their flash launches, for the kernels line."""
    return {"migrated": sm["migrate"], "searched_plan": sm["searched"]}


def resilience_paths(res):
    """Phase 18's paths with their flash launches, for the kernels line."""
    return {"sdc_plain": res["sdc"]["runs"]["plain"], "sdc_digest": res["sdc"]["runs"]["digest"],
            "hang_resume": res["hang"], "migrate": res["migrate"], "autotune": res["autotune"],
            "serve_watchdog": dict(res["serve"]["hang"], bwd_launches=0),
            "serve_sigterm": dict(res["serve"]["sigterm"], bwd_launches=0)}


def resilience(torch, TF):
    """Phase 18: b-f (18a runs with the kernel checks)."""
    t0 = time.perf_counter()
    out = dict(sdc=sdc_digest(torch, TF), hang=hang_exit(torch, TF),
               migrate=live_migration(torch, TF), autotune=autotune_swap(torch, TF),
               serve=serve_drains(torch, TF))
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_resilience(fold, r, card):
    rows = fold["rows"]
    log("phase 18a fold kernel on %s: bitwise equal to its plain version on %s; a planted "
        "flip changes the fold; llama-7b width depth 8 tree (%.2f GB): %.4f ms (single call "
        "%.4f), bound %.4f ms (%.1f%% of it), plain %.2f ms, library %.4f ms as two calls %s; "
        "sumsq rel err %.2e" % (
            card, ", ".join(sorted(rows)), fold["bytes"] / 1e9, fold["ms"], fold["ms_single"],
            fold["bound_ms"], 100 * fold["share_of_bound"], fold["plain_ms"],
            fold["library_ms"], {k: round(v, 4) for k, v in fold["library_calls"].items()},
            rows["llama7b_depth8"]["sumsq_rel_err"]))
    s = r["sdc"]
    log("phase 18b sdc digest (llama-7b width, %d layers, %d steps) on %s: losses bitwise equal "
        "to the run without it; fold launches %d; step %.1f ms vs %.1f ms without (overhead "
        "%.2f ms/step); phase %.1f s" % (
            s["layers"], s["steps"], card, s["runs"]["digest"]["fold_launches"],
            s["runs"]["digest"]["summary"]["steady_step_ms"],
            s["runs"]["plain"]["summary"]["steady_step_ms"], s["overhead_ms"], s["wall_s"]))
    h = r["hang"]
    log("phase 18c hang drill on %s: watchdog fired %d, escalated (deadline %.2f s), emergency "
        "save at %d, exit 3 (subprocess %.1f s); --elastic resume continued %d steps (%.1f s); "
        "phase %.1f s" % (card, h["watchdog"]["fires"], h["watchdog"]["deadline_s"], h["saved"],
                          h["subprocess_s"], len(h["resumed_losses"]), h["resume_s"],
                          h["wall_s"]))
    m = r["migrate"]
    log("phase 18d live migration (llama-7b width, %d layers, ZeRO-3 + ZeRO-2 -> ZeRO-2) on %s: "
        "SIGUSR1 at step %d, migrated in %.3f s, device memory beyond the live state %.3f GB, "
        "losses bitwise equal to save + --elastic resume; fold launches %d; phase %.1f s" % (
            MIG_LAYERS, card, MIG_AT, m["seconds"], m["device_extra_gb"] or float("nan"),
            m["fold_launches"], m["wall_s"]))
    a = r["autotune"]
    log("phase 18e autotune apply (llama-7b width, %d layers, all full remat at the start) on "
        "%s: swapped once at step %d to %s; incumbent %.1f ms, predicted winner %.1f ms, "
        "measured %.1f -> %.1f ms; epochs %s; phase %.1f s" % (
            AUTOTUNE_LAYERS, card, a["epochs"][0]["iteration"],
            {k: a["strategy"][k] for k in ("checkpoint", "chunks")}, a["incumbent_ms"] or -1,
            a["predicted_ms"] or -1, a["measured_before_ms"] or -1, a["measured_after_ms"] or -1,
            [(e["iteration"], e["reason"]) for e in a["epochs"]], a["wall_s"]))
    v = r["serve"]
    log("phase 18f serve drills on %s: stalled tick -> drain %s, exit %d (%d served, %d shed); "
        "SIGTERM -> drain %s, exit %d (%d served, %d shed); phase %.1f s" % (
            card, v["hang"]["drain"], v["hang"]["exit_code"], v["hang"]["requests"],
            v["hang"]["shed"], v["sigterm"]["drain"], v["sigterm"]["exit_code"],
            v["sigterm"]["requests"], v["sigterm"]["shed"], v["wall_s"]))

# ----------------------------------------------------------------- phase 19
# Serve layouts and live serve migration on the one card (the world > 1
# runs need NCCL between cards: tools/serve_cell.py on four). (i) phase 7's
# load (LLaMA-7B, 32 layers, bf16, 16 requests) through the engine under
# its world-1 layout, uninterrupted, then again interrupted after
# SERVE_MIGRATE_AT decode ticks by `migrate_to` onto a freshly built engine
# whose cache holds SERVE_SMALL_PAGES pages (1024 tokens): the in-flight
# requests whose journal still fits are re-prefilled, the rest shed
# retryable (and later arrivals that no longer fit refused); (ii) ``cli
# serve`` at world 1 under the plan ``cli search --objective serve`` writes
# (on analytic tables), with the mesh probe on and --migrate_on_degrade 1.
SERVE_MIGRATE_AT = 3
SERVE_SMALL_PAGES = 8
SERVE_PLAN_DIR = os.path.join("chiprun_out", "phase19")
# replayed logits against the uninterrupted run at 32 layers: TOL_DECODE's
# rule (bf16 roundings in different places, ~1.3 logit std) set for 4
# layers, scaled as a random walk to 8x the layers. The journal re-prefill
# computes the cached tokens' k/v in one prefill (the flash kernel, one
# GEMM over the bucket) where the uninterrupted run computed the generated
# ones a token at a time in decode: on the H100 (PR 14) the first replayed
# row is 0.23-0.34 off and the later steps 0.16-0.24, with the cache's
# geometry unchanged or smaller alike; a replay that drops the journal's
# last token (a wrong cache column) must fail it.
TOL_REPLAY = TOL_DECODE * math.sqrt(32 / 4)


def _serve_recorder(engine, batcher, prompts, logs, calls):
    """`engine`'s prefill / decode_step recording each request's logits by
    the index of the token they predict (a re-prefill of ``journal[:-1]``
    predicts ``output[-1]`` again)."""
    import numpy as np

    class Recorder:
        def prefill(self, prompt, slot):
            tok, row = engine.prefill(prompt, slot)
            rid = next(r for r, p in prompts.items() if list(prompt[:len(p)]) == p)
            k = len(prompt) - len(prompts[rid])
            logs.setdefault(rid, {})[k] = row
            calls["replays" if k else "prefills"] += 1
            if k:
                calls["replay_at"][rid] = k
            calls["nonfinite"] += int(not np.isfinite(row).all())
            return tok, row

        def decode_step(self, tokens, active, pages):
            nxt, lg = engine.decode_step(tokens, active, pages)
            for i, req in enumerate(batcher["b"].slot_req):
                if req is not None:
                    logs.setdefault(req.rid, {})[len(req.output)] = lg[i]
                    calls["nonfinite"] += int(not np.isfinite(lg[i]).all())
            return nxt, lg

    return Recorder()


def serve_migration(torch, TF, device="cuda", argv=SERVE_ARGV, small_pages=SERVE_SMALL_PAGES):
    """Phase 19 (see its note above): returns what it measured. `device`,
    `argv` (the model and load flags) and `small_pages` let a rehearsal run
    it at a small size."""
    import numpy as np

    from galvatron_tpu_torch.cli import search as cli_search
    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.cli.arguments import (hp_config_from_args, initialize_galvatron,
                                                   model_config_from_args)
    from galvatron_tpu_torch.ops import tree_fold as TFold
    from galvatron_tpu_torch.profiler.model import ModelProfileArgs, ModelProfiler
    from galvatron_tpu_torch.runtime import distributed, elastic
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.serve import engine as E
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, request_fits
    from galvatron_tpu_torch.utils.jsonio import write_json_config

    t0 = time.perf_counter()
    out = {}
    argv = [a if a != "cuda" else device for a in argv]
    args = initialize_galvatron(argv=argv)
    _, cfg = model_config_from_args(args)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with distributed.process_group(device) as dev:
        hp = hp_config_from_args(args, cfg.num_layers, 1)
        model = construct_hybrid_parallel_model(cfg, hp, dev, mode="serve")
        params = model.init_params(SEED)[0]
        kv = KVCacheConfig(max_slots=8, page_size=128, max_pages=-(-cfg.max_seq_len // 128))
        small = KVCacheConfig(max_slots=8, page_size=128, max_pages=small_pages)

        def load():
            return E.synthetic_requests(
                args.num_requests, vocab_size=cfg.vocab_size, seed=args.seed, rate_rps=0.0,
                prompt_len_range=(args.prompt_len_min, min(args.prompt_len_max,
                                                           kv.max_ctx - args.max_new_tokens)),
                max_new_tokens=args.max_new_tokens)

        prompts = {r.rid: list(r.prompt) for r in load()}

        class DropLast:
            """A planted fault: each replay prefills without the journal's
            last token, so the replayed cache misses one column."""

            def __init__(self, engine):
                self.engine = engine

            def prefill(self, prompt, slot):
                return self.engine.prefill(prompt[:-1], slot)

            def decode_step(self, tokens, active, pages):
                return self.engine.decode_step(tokens, active, pages)

        runs = {}
        for name in ("uninterrupted", "migrated", "planted"):
            logs, calls = {}, {"prefills": 0, "replays": 0, "nonfinite": 0, "replay_at": {}}
            holder, mig = {}, {}
            engine = E.ServeEngine(cfg, params, kv, device=dev, hp=hp, mesh=model.mesh)

            def control(b, name=name, mig=mig, logs=logs, calls=calls, holder=holder):
                if name != "uninterrupted" and b.decode_steps == SERVE_MIGRATE_AT and not mig:
                    inflight = [r for r in b.slot_req if r is not None]
                    fits = [r.rid for r in inflight if request_fits(
                        small, len(r.journal) - 1, r.max_new_tokens - len(r.output) + 1)]
                    new = E.ServeEngine(cfg, params, small, device=dev, hp=hp, mesh=model.mesh)
                    if name == "planted":
                        new = DropLast(new)
                    n0 = TF.flash_attention_fwd.launches
                    tm = time.perf_counter()
                    mig.update(b.migrate_to(_serve_recorder(new, holder, prompts, logs, calls),
                                            small))
                    sync()
                    mig.update(seconds=time.perf_counter() - tm, inflight=len(inflight),
                               fits=fits, launches=TF.flash_attention_fwd.launches - n0)
                return None

            b = E.ContinuousBatcher(None, kv, control=control)
            holder["b"] = b
            b.engine = _serve_recorder(engine, holder, prompts, logs, calls)
            _reset_counts(torch, TF, TFold)
            tr = time.perf_counter()
            done = b.run(load())
            sync()
            runs[name] = dict(done={r.rid: list(r.output) for r in done},
                              shed={r.rid: (r.finish_reason, r.retryable) for r in b.shed},
                              logs=logs, calls=calls, mig=mig, seconds=time.perf_counter() - tr,
                              fwd_launches=TF.flash_attention_fwd.launches,
                              bwd_launches=TF.flash_attention_bwd.launches)
            del engine, b
        ref, got = runs["uninterrupted"], runs["migrated"]
        mig = got["mig"]
        layers = cfg.num_layers
        check(len(ref["done"]) == args.num_requests and not ref["shed"],
              "phase 19 uninterrupted run: %d completed, shed %s" % (len(ref["done"]),
                                                                     ref["shed"]))
        check(ref["calls"]["nonfinite"] == 0 and got["calls"]["nonfinite"] == 0,
              "phase 19 non-finite logits")
        check(mig.get("inflight") and mig["replayed"] == len(mig["fits"]) and mig["shed"] >= 1
              and mig["replayed"] >= 1,
              "phase 19 migration: %s (at least one request must be replayed and one shed as "
              "no longer fitting)" % {k: v for k, v in mig.items() if k != "fits"})
        migrated_shed = [rid for rid, (why, retry) in got["shed"].items()
                         if why == "migrate_infeasible" and retry]
        check(len(migrated_shed) == mig["shed"], "phase 19 shed %s" % got["shed"])
        check(mig["launches"] == layers * mig["replayed"],
              "phase 19 re-prefills launched the forward kernel %d times, expected %d layers x "
              "%d replays" % (mig["launches"], layers, mig["replayed"]))
        check(got["fwd_launches"] == layers * (got["calls"]["prefills"] + got["calls"]["replays"])
              and got["bwd_launches"] == 0,
              "phase 19 migrated run launched fwd %d / bwd %d, expected %d x (%d + %d)" % (
                  got["fwd_launches"], got["bwd_launches"], layers, got["calls"]["prefills"],
                  got["calls"]["replays"]))
        # every replayed request against the uninterrupted run: its logits
        # from the re-prefill on, while its tokens agree
        def replay_errs(run):
            errs, agree = [], 0
            for rid in run["mig"]["fits"]:
                want, have = ref["logs"][rid], run["logs"][rid]
                first = run["calls"]["replay_at"][rid]
                for k in sorted(k for k in have if k >= first and k in want):
                    if run["done"][rid][:k] != ref["done"][rid][:k]:
                        break
                    errs.append(float(np.abs(have[k] - want[k]).max()))
                agree += int(run["done"][rid] == ref["done"][rid])
            return errs, agree

        errs, agree = replay_errs(got)
        compared = len(errs)
        check(compared >= len(mig["fits"]) and max(errs) <= TOL_REPLAY,
              "phase 19 replayed logits vs the uninterrupted run: max err %.4f over %d steps "
              "(tol %.3f)" % (max(errs or [float("inf")]), compared, TOL_REPLAY))
        planted = max(replay_errs(runs["planted"])[0] or [float("inf")])
        check(planted > TOL_REPLAY, "phase 19 planted fault (a replay without its last token) "
              "passed the check: max err %.4f <= %.3f" % (planted, TOL_REPLAY))
        out["migrate"] = dict(
            inflight=mig["inflight"], replayed=mig["replayed"], shed=mig["shed"],
            replay_seconds=mig["seconds"], replay_launches=mig["launches"],
            small_ctx=small.max_ctx, max_abs_err=max(errs), steps_compared=compared,
            first_step_err=errs[0], tolerance=TOL_REPLAY, planted_err=planted,
            replayed_requests_identical=agree,
            refused_after=sorted(rid for rid, (why, _) in got["shed"].items()
                                 if why == "oversize"),
            completed=len(got["done"]), runs_s={n: r["seconds"] for n, r in runs.items()},
            fwd_launches=got["fwd_launches"], bwd_launches=got["bwd_launches"],
            prefills=got["calls"]["prefills"])
        del params, model, runs
        _reset_counts(torch, TF, TFold)

    # (ii) cli search --objective serve at world 1, then cli serve under its
    # plan with the mesh probe on: healthy, no migration
    os.makedirs(SERVE_PLAN_DIR, exist_ok=True)
    margs = argv[:argv.index("--device")]
    paths = ModelProfiler(cfg, model_name="llama", args=ModelProfileArgs(
        mixed_precision="bf16", config_dir=SERVE_PLAN_DIR)).config_paths()
    time_cfg, mem_cfg = elastic.analytic_model_profiles(cfg, max_tp=1)
    write_json_config(time_cfg, paths["computation"])
    write_json_config(mem_cfg, paths["memory"])
    write_json_config(elastic.analytic_hardware_profiles(1)[2],
                      os.path.join(SERVE_PLAN_DIR, "overlap_coefficient.json"))
    plan = os.path.join(SERVE_PLAN_DIR, "serve_plan.json")
    os.environ["GALVATRON_WORLD_SIZE"] = "1"
    try:
        cli_search.main(margs + ["--config_dir", SERVE_PLAN_DIR, "--objective", "serve",
                                 "--serve_max_concurrency", "8", "--serve_page_size", "128",
                                 "--memory_constraint", "70", "--output_config_path", plan,
                                 "--log_dir", os.path.join(SERVE_PLAN_DIR, "logs")])
    finally:
        del os.environ["GALVATRON_WORLD_SIZE"]
    with open(plan) as f:
        planned = json.load(f)
    _reset_counts(torch, TF, TFold)
    summary = cli_serve.main(margs + [
        "--device", device, "--galvatron_config_path", plan, "--num_requests", "8",
        "--prompt_len_min", "100", "--prompt_len_max", "1500", "--max_new_tokens", "16",
        "--seed", str(SEED), "--mesh_probe_interval", "0.05", "--migrate_on_degrade", "1"])
    fwd = TF.flash_attention_fwd.launches
    check(summary["requests"] == 8 and not summary["shed"] and not summary["migrations"]
          and summary["mesh_probes"] >= 1 and summary["world_size"] == 1,
          "phase 19 cli serve under the searched plan: %d served, shed %d, migrations %s, "
          "probes %d" % (summary["requests"], summary["shed"], summary["migrations"],
                         summary["mesh_probes"]))
    check(fwd == cfg.num_layers * 8 and TF.flash_attention_bwd.launches == 0,
          "phase 19 cli serve launched the forward kernel %d times, expected %d" % (
              fwd, cfg.num_layers * 8))
    out["searched"] = dict(plan={k: planned.get(k) for k in (
        "tp_sizes_enc", "dp_types_enc", "serve_max_concurrency", "serve_page_size")},
        probes=summary["mesh_probes"], requests=summary["requests"],
        ttft_ms=summary["ttft_ms"], tpot_ms=summary["tpot_ms"],
        tokens_per_s=summary["tokens_per_s"], fwd_launches=fwd, bwd_launches=0)
    out["wall_s"] = time.perf_counter() - t0
    return out


def log_serve_migration(sm, card):
    m, s = sm["migrate"], sm["searched"]
    log("phase 19 serve migration (llama-7b, 32 layers, bf16, phase 7's 16 requests) on %s: "
        "at decode tick %d, %d in flight -> cache of %d tokens: %d replayed (re-prefills %.2f s, "
        "%d forward launches), %d shed retryable, %d later arrivals refused; replayed logits "
        "max abs err %.4f (first replayed row %.4f) over %d steps (tol %.3f; planted fault "
        "%.3f) vs the uninterrupted run, %d of %d replayed requests token-identical; runs %s s"
        % (card, SERVE_MIGRATE_AT, m["inflight"], m["small_ctx"], m["replayed"],
           m["replay_seconds"], m["replay_launches"], m["shed"], len(m["refused_after"]),
           m["max_abs_err"], m["first_step_err"], m["steps_compared"], m["tolerance"],
           m["planted_err"], m["replayed_requests_identical"], m["replayed"],
           {k: round(v, 2) for k, v in m["runs_s"].items()}))
    log("phase 19 cli serve under the searched serve plan %s with the mesh probe: %d probes "
        "healthy, no migration, %d requests, TTFT p50 %.1f ms, TPOT p50 %.1f ms, %d forward "
        "launches; phase %.1f s" % (
            s["plan"], s["probes"], s["requests"], s["ttft_ms"]["p50"], s["tpot_ms"]["p50"],
            s["fwd_launches"], sm["wall_s"]))


# ----------------------------------------------------------------- phase 20
# observability and lint on the card: the traced train run (a), the served
# run (b), the checkpoint audit (c: phase 10's checkpoint inside the try
# that keeps it, then a depth-1 checkpoint of this phase with planted
# faults) and the strategy lint (d)
OBS_LAYERS = 4
OBS_CHECKPOINT = [1, 1, 1, 0]  # phase 8's remat mix at depth 4
OBS_REMAT = ["full", "full", "dots_saveable", "full"]
OBS_STEPS = 8
OBS_TRACE = (5, 6)  # --trace_steps, inclusive
OBS_SERVE_REQUESTS = 8
OBS_DIR = os.path.join("chiprun_out", "phase20")
OBS_CKPT = os.path.join("build", "phase20", "ckpt")  # ~5.6 GB at depth 1, deleted after
TOL_REPORT_STEP = 0.10  # the report's steady step against the driver's summary, relative
# the flash kernels' names in a trace (demangled or not: the name's
# identifier, not preceded by a letter)
TRACE_KERNELS = {"fwd": r"(?<![A-Za-z])flash_fwd_(?:wgmma_|mma_)?kernel",
                 "dkv": r"(?<![A-Za-z])dkv_(?:wgmma_)?kernel",
                 "dq": r"(?<![A-Za-z])dq_(?:wgmma_)?kernel"}


def _quiet(fn, argv):
    """Run a CLI's `run(argv + ["--json"])` in this process: (exit code,
    the parsed JSON, stderr)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(list(argv) + ["--json"])
    return rc, json.loads(out.getvalue()), err.getvalue()


def _lint(argv):
    from galvatron_tpu_torch.cli import lint as cli_lint

    return _quiet(cli_lint.run, argv)


def _report(path):
    from galvatron_tpu_torch.obs import report as R

    return _quiet(R.run, [path])


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def audit_phase10_checkpoint(torch, phase10):
    """Phase 20 (c), first part: ``cli lint --ckpt --deep`` on phase 10's
    checkpoint (every step restored on the card, its params and its params
    with the Adam state folded: two fold launches a step)."""
    from galvatron_tpu_torch.ops import flash_attention as TF
    from galvatron_tpu_torch.ops import tree_fold as TFold

    ck = phase10["ckpt"]
    steps = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    nbytes = sum(_dir_bytes(os.path.join(ck, str(s))) for s in steps)
    _reset_counts(torch, TF, TFold)
    t0 = time.perf_counter()
    rc, payload, err = _lint(["--ckpt", ck, "--deep"])
    seconds = time.perf_counter() - t0
    folds = TFold.tree_fold.launches
    check(rc == 0 and payload["summary"]["errors"] == 0,
          "lint --deep of phase 10's checkpoint exited %d: %s %s" % (rc, payload, err))
    check(folds == 2 * len(steps), "lint --deep launched the fold kernel %d times for %d steps "
          "(expected 2 a step)" % (folds, len(steps)))
    torch.cuda.empty_cache()
    return dict(steps=steps, bytes=nbytes, seconds=seconds, s_per_gb=seconds / (nbytes / 1e9),
                fold_launches=folds, warnings=[d["message"] for d in payload["diagnostics"]])


def _trace_kernels(path):
    """The flash kernels' events in a Chrome trace, by TRACE_KERNELS; the
    events by category and the kernel names (for a failure message)."""
    import collections
    import re

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    count = {k: sum(1 for n in kernels if re.search(rx, n)) for k, rx in TRACE_KERNELS.items()}
    cats = collections.Counter(str(e.get("cat")) for e in events)
    names = sorted(set(n[:100] for n in kernels))
    return count, dict(cats), names


def traced_train(torch, TF, TFold):
    """Phase 20 (a): ``cli train`` with --telemetry, --xla_trace over
    OBS_TRACE, --train_log_dir and --profile; the trace's flash kernels
    against the launch counters over the window, the log, the report."""
    from galvatron_tpu_torch.cli import train as cli_train
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, layer_runs
    from galvatron_tpu_torch.runtime.resilience import FaultHooks

    tele = os.path.join(OBS_DIR, "train.jsonl")
    trace_dir, log_dir = os.path.join(OBS_DIR, "trace"), os.path.join(OBS_DIR, "logs")
    strategy = _layers_strategy(os.path.join(OBS_DIR, "strategy.json"), OBS_CHECKPOINT,
                                OBS_REMAT, [0] * OBS_LAYERS)
    argv = _llama_argv(strategy, OBS_LAYERS, OBS_STEPS, [
        "--telemetry", tele, "--xla_trace", trace_dir, "--trace_steps", "%d:%d" % OBS_TRACE,
        "--train_log_dir", log_dir, "--profile", "1"])
    marks = {}

    def on_step(it):  # before step `it` is dispatched: the counters over the window
        if it in (OBS_TRACE[0], OBS_TRACE[1] + 1):
            marks[it] = (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches)

    _reset_counts(torch, TF, TFold)
    summary = _train_with_hooks(argv, FaultHooks(on_step=on_step))
    fwd, bwd, _ = _launch_counts(TF, TFold)
    losses = summary["losses"]
    check(len(losses) == OBS_STEPS and all(math.isfinite(x) for x in losses),
          "phase 20 traced train losses %s" % losses)
    remat = sum(OBS_CHECKPOINT)
    want = (OBS_STEPS * 2 * (OBS_LAYERS + remat), OBS_STEPS * 2 * OBS_LAYERS)
    check((fwd, bwd) == want, "phase 20 traced train launched %d / %d, expected %d / %d"
          % (fwd, bwd, *want))
    lo, hi = marks[OBS_TRACE[0]], marks[OBS_TRACE[1] + 1]
    window = {"fwd": hi[0] - lo[0], "bwd": hi[1] - lo[1]}
    trace_path = os.path.join(trace_dir, "trace_rank0.json")
    check(os.path.exists(trace_path), "no trace at %s: %s" % (
        trace_path, os.listdir(trace_dir) if os.path.isdir(trace_dir) else "no dir"))
    trace_mb = os.path.getsize(trace_path) / 1e6
    in_trace, cats, names = _trace_kernels(trace_path)
    os.remove(trace_path)  # tens of MB: only the counts are kept
    from galvatron_tpu_torch.obs import telemetry

    events, errors = telemetry.read_events(tele)
    check(errors == [], "train telemetry schema errors %s" % errors)
    marks_seen = [e["action"] for e in events if e["type"] == "trace"]
    check(marks_seen == ["start", "stop"], "trace events %s (start and stop, no error)"
          % [e for e in events if e["type"] == "trace"])
    check(in_trace == {"fwd": window["fwd"], "dkv": window["bwd"], "dq": window["bwd"]},
          "the trace holds %s flash kernels over steps %d-%d; the launch counters moved by %s "
          "(events by category %s; kernels %s)" % (in_trace, OBS_TRACE[0], OBS_TRACE[1], window,
                                                   cats, names[:40]))
    log_path = os.path.join(log_dir, "train_llama_llama-7b.log")
    with open(log_path) as f:
        lines = f.read().splitlines()
    check([int(x.split()[1]) for x in lines] == list(range(OBS_STEPS)),
          "%s holds %d lines for %d iterations" % (log_path, len(lines), OBS_STEPS))
    rc, rep, err = _report(tele)
    check(rc == 0 and rep["schema_errors"] == [], "cli report exited %d: %s" % (rc, err))
    steady = rep["steady"]
    rel = abs(steady["step_ms"] - summary["steady_step_ms"]) / summary["steady_step_ms"]
    check(rel <= TOL_REPORT_STEP, "the report's steady step %.2f ms is %.3f off the driver's "
          "%.2f ms (tol %.2f)" % (steady["step_ms"], rel, summary["steady_step_ms"],
                                  TOL_REPORT_STEP))
    check(0 < steady["mfu"] < 1, "the report's MFU %r" % steady["mfu"])
    hp = HybridParallelConfig.from_json(strategy, world_size=1)
    runs = len(layer_runs(hp)) + 1  # and the embed/head row
    check(len(rep["divergence"]) == runs == rep["counts"].get("layer_run"),
          "%d divergence rows for %d layer runs (+ head), %s layer_run events"
          % (len(rep["divergence"]), runs - 1, rep["counts"].get("layer_run")))
    torch.cuda.empty_cache()
    return dict(summary={k: summary[k] for k in ("steady_step_ms", "device_step_ms", "mfu",
                                                 "tokens_per_s", "peak_hbm_mb")},
                losses=losses, fwd_launches=fwd, bwd_launches=bwd, window_launches=window,
                trace_kernels=in_trace, trace_events=cats, trace_kernel_names=len(names),
                trace_mb=trace_mb, log_lines=len(lines),
                report=dict(steady=steady, divergence=rep["divergence"],
                            timeline=rep["timeline"]), report_step_rel=rel)


def served_with_telemetry(torch, TF, TFold):
    """Phase 20 (b): ``cli serve --telemetry`` at depth OBS_LAYERS; the
    report's serving percentiles against the serve summary's."""
    from galvatron_tpu_torch.cli import serve as cli_serve
    from galvatron_tpu_torch.serve import engine as E

    tele = os.path.join(OBS_DIR, "serve.jsonl")
    argv = [a for a in SERVE_ARGV] + ["--set_layernum_manually", "1", "--num_layers",
                                      str(OBS_LAYERS), "--telemetry", tele]
    argv[argv.index("--num_requests") + 1] = str(OBS_SERVE_REQUESTS)
    prefills = [0]
    orig = E.ServeEngine.prefill

    def prefill(self, prompt, slot):
        prefills[0] += 1
        return orig(self, prompt, slot)

    _reset_counts(torch, TF, TFold)
    E.ServeEngine.prefill = prefill
    try:
        summary = cli_serve.main(argv)
    finally:
        E.ServeEngine.prefill = orig
    fwd, bwd, _ = _launch_counts(TF, TFold)
    check(summary["requests"] == OBS_SERVE_REQUESTS and summary["shed"] == 0,
          "phase 20 served %d of %d requests" % (summary["requests"], OBS_SERVE_REQUESTS))
    check(fwd == OBS_LAYERS * prefills[0] and bwd == 0,
          "phase 20 serve launched the forward kernel %d times, expected %d layers x %d "
          "prefills" % (fwd, OBS_LAYERS, prefills[0]))
    rc, rep, err = _report(tele)
    check(rc == 0, "cli report on the serve stream exited %d: %s" % (rc, err))
    sv = rep["serving"]
    for name in ("ttft_ms", "tpot_ms"):
        for q in ("p50", "p99"):
            check(math.isclose(sv[name][q], summary[name][q], rel_tol=1e-9),
                  "the report's %s %s %r differs from the serve summary's %r"
                  % (name, q, sv[name][q], summary[name][q]))
    torch.cuda.empty_cache()
    return dict(fwd_launches=fwd, prefills=prefills[0], requests=summary["requests"],
                ttft_ms=sv["ttft_ms"], tpot_ms=sv["tpot_ms"],
                tokens_per_s=summary["tokens_per_s"])


def _flip_one_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)  # inside the tensor data
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x40]))


def planted_checkpoint_faults(torch, TF, TFold):
    """Phase 20 (c), second part: a depth-1 checkpoint of this phase, one
    byte flipped in its rank file (GLS214 under --deep, exit 1), then its
    manifest removed (GLS210)."""
    import shutil

    from galvatron_tpu_torch.runtime import checkpoint as CK

    shutil.rmtree(OBS_CKPT, ignore_errors=True)
    try:
        strategy = _layers_strategy(os.path.join(OBS_DIR, "strategy_depth1.json"), [1],
                                    ["full"], [0])
        _reset_counts(torch, TF, TFold)
        _train_with_hooks(_llama_argv(strategy, 1, 1, ["--lr_warmup_iters", "0",
                                                        "--save", OBS_CKPT]), None)
        step = CK.latest_iteration(OBS_CKPT)
        rc, clean, err = _lint(["--ckpt", OBS_CKPT])
        check(rc == 0 and clean["summary"]["errors"] == 0,
              "lint of phase 20's own checkpoint exited %d: %s %s" % (rc, clean, err))
        _flip_one_byte(CK._rank_file(OBS_CKPT, step, 0))
        _reset_counts(torch, TF, TFold)
        t0 = time.perf_counter()
        rc, flipped, err = _lint(["--ckpt", OBS_CKPT, "--deep"])
        deep_s = time.perf_counter() - t0
        folds = TFold.tree_fold.launches
        check(rc == 1 and "GLS214" in flipped["summary"]["codes"] and folds == 2,
              "lint --deep after a flipped byte exited %d with %s, %d fold launches"
              % (rc, flipped["summary"], folds))
        os.remove(CK._manifest_path(OBS_CKPT, step))
        rc, torn, err = _lint(["--ckpt", OBS_CKPT])
        check(rc == 1 and "GLS210" in torn["summary"]["codes"],
              "lint after removing the manifest exited %d with %s" % (rc, torn["summary"]))
        return dict(step=step, bytes=_dir_bytes(os.path.join(OBS_CKPT, str(step))),
                    deep_seconds=deep_s, fold_launches=folds,
                    flipped=[d["message"] for d in flipped["diagnostics"]],
                    torn=torn["summary"]["codes"])
    finally:
        shutil.rmtree(OBS_CKPT, ignore_errors=True)
        torch.cuda.empty_cache()


def strategy_lint(loop):
    """Phase 20 (d): ``cli lint`` on phase 12's searched strategy: clean at
    80 GB, GLS101 at 1 GB (exit 0, and 1 under --strict)."""
    path = os.path.join(OBS_DIR, "searched_strategy.json")
    with open(path, "w") as f:
        json.dump(loop["search"]["strategy"], f)
    model = ["--world_size", "1", "--model_type", "llama", "--model_size", "llama-7b"]
    rc, roomy, err = _lint([path, "--memory_budget_gb", "80"] + model)
    check(rc == 0 and roomy["summary"]["errors"] == 0 and "GLS101" not in roomy["summary"]["codes"],
          "lint of the searched strategy at 80 GB exited %d: %s %s" % (rc, roomy, err))
    rc, tight, _ = _lint([path, "--memory_budget_gb", "1"] + model)
    rc_strict, _, _ = _lint([path, "--memory_budget_gb", "1", "--strict"] + model)
    gls101 = [d["message"] for d in tight["diagnostics"] if d["code"] == "GLS101"]
    check(rc == 0 and rc_strict == 1 and gls101,
          "lint at 1 GB exited %d (strict %d), GLS101 %s" % (rc, rc_strict, gls101))
    return dict(roomy=roomy["summary"], tight_gls101=gls101, exit=rc, exit_strict=rc_strict)


def observability(torch, TF, audit10, loop):
    """Phase 20 (a), (b), the rest of (c), (d); (c)'s phase-10 audit ran
    before phase 15 (`audit_phase10_checkpoint`)."""
    import shutil

    from galvatron_tpu_torch.ops import tree_fold as TFold

    t0 = time.perf_counter()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)
    out = dict(train=traced_train(torch, TF, TFold), serve=served_with_telemetry(torch, TF, TFold),
               audit10=audit10, planted=planted_checkpoint_faults(torch, TF, TFold),
               lint=strategy_lint(loop))
    out["wall_s"] = time.perf_counter() - t0 + audit10["seconds"]
    return out


def log_observability(ob, card):
    a, s, c, p, d = ob["train"], ob["serve"], ob["audit10"], ob["planted"], ob["lint"]
    log("phase 20 trace window (llama-7b width, %d layers, steps %d-%d of %d) on %s: flash "
        "kernels in the trace fwd %d / dkv %d / dq %d, launch counters over the window fwd "
        "%d / bwd %d; events by category %s, %.1f MB (deleted); iteration log %d lines"
        % (OBS_LAYERS, OBS_TRACE[0], OBS_TRACE[1], OBS_STEPS, card, a["trace_kernels"]["fwd"],
           a["trace_kernels"]["dkv"], a["trace_kernels"]["dq"], a["window_launches"]["fwd"],
           a["window_launches"]["bwd"], a["trace_events"], a["trace_mb"], a["log_lines"]))
    log("phase 20 report of the traced run: steady step %.2f ms (%s from iter %s) vs the "
        "driver's %.2f ms (%.4f off), MFU %.4f vs %.4f, %d divergence rows %s; serve (%d "
        "layers, %d requests): TTFT p50/p99 %.2f/%.2f ms, TPOT p50/p99 %.2f/%.2f ms, equal "
        "to the serve summary's, forward launches %d = %d layers x %d prefills" % (
            a["report"]["steady"]["step_ms"], a["report"]["steady"]["method"],
            a["report"]["steady"].get("start_iter"), a["summary"]["steady_step_ms"],
            a["report_step_rel"], a["report"]["steady"]["mfu"], a["summary"].get("mfu", 0.0),
            len(a["report"]["divergence"]),
            [(r["strategy"], r.get("predicted_ms"), r.get("measured_ms"))
             for r in a["report"]["divergence"]],
            OBS_LAYERS, s["requests"], s["ttft_ms"]["p50"], s["ttft_ms"]["p99"],
            s["tpot_ms"]["p50"], s["tpot_ms"]["p99"], s["fwd_launches"], OBS_LAYERS,
            s["prefills"]))
    log("phase 20 lint --deep of phase 10's checkpoint: steps %s, %.2f GB in %.2f s (%.3f s/GB), "
        "%d fold launches; planted faults on a depth-1 step (%.2f GB): flipped byte -> %s "
        "(deep %.2f s, %d fold launches), manifest removed -> %s; searched strategy at 80 "
        "GB %s, at 1 GB %s (exit %d, strict %d); phase %.1f s" % (
            c["steps"], c["bytes"] / 1e9, c["seconds"], c["s_per_gb"], c["fold_launches"],
            p["bytes"] / 1e9, p["flipped"], p["deep_seconds"], p["fold_launches"], p["torn"],
            d["roomy"], d["tight_gls101"], d["exit"], d["exit_strict"], ob["wall_s"]))


def main():
    try:
        import torch
    except ImportError as e:
        fail("torch is not importable: %s" % e)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    try:
        from galvatron_tpu_torch.ops import flash_attention as TF
    except ImportError as e:
        fail("cannot import galvatron_tpu_torch (run from the repository root): %s" % e)

    t_start = time.perf_counter()
    card = identify_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    log("card: %s | torch %s, CUDA %s, %d device(s)" % (
        card, torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    built, ptxas, ptxas_kernels, helper = build_kernels(TF)
    build_s = {os.path.basename(src): sec for src, (_, sec) in built.items()}
    for (so, sec), name in zip(helper, ("index_helpers.cpp", "dp_core.cpp")):
        build_s[name] = sec
        log("built %s in %.1f s (g++)" % (os.path.relpath(so), sec))
    for src, (so, sec) in built.items():
        log("built %s in %.1f s\n  %s" % (os.path.relpath(so), sec,
                                          "\n  ".join(ptxas[os.path.basename(src)])))
    wgmma_ptxas = gate_wgmma_ptxas(ptxas_kernels, ptxas)
    log("wgmma kernels: %s" % "; ".join(
        "%s %d registers, spill %d/%d bytes" % (
            next(w for w in WGMMA_KERNELS if w in k), v["registers"], v["spill_stores"],
            v["spill_loads"]) for k, v in wgmma_ptxas.items()))

    shapes = check_kernel(torch, TF, dev)
    bwd_shapes = check_bwd_kernel(torch, TF, dev)
    grads = grads_in_place(torch, TF, dev)
    decode = decode_vs_recompute(torch, dev)
    served = serve(torch, TF)
    trained = train(torch, TF)
    layouts = train_gpt_layouts(torch, TF)
    try:
        corpus = corpus_checkpoint_resume(torch, TF)
        pipelines = train_pipelines(torch, TF)
        loop = profile_search_train(torch, TF)
        lc = long_context(torch, TF, dev)
        encoders = encoder_families(torch, TF)
        audit10 = audit_phase10_checkpoint(torch, corpus)  # phase 20 (c), before phase 15
        elastic = elastic_resume(torch, TF, corpus)
    finally:
        remove_phase10_data()
    t5_swin = t5_swin_families(torch, TF)
    hf = hf_finetune(torch, TF)
    fold = fold_kernel(torch)
    res = resilience(torch, TF)
    serve_mig = serve_migration(torch, TF)
    obs = observability(torch, TF, audit10, loop)
    s, t = served["summary"], trained["summary"]

    def at_2048(rows, b):
        return next(r for r in rows if r["shape"] == [b, 2048, 32, 128] and r["valid_len"] == 2048
                    and r["dtype"] == "bfloat16" and r["causal"])

    def entry(name, source, rows, launches, by_path, tol):
        head = at_2048(rows, 1)
        at_b = {"b%d" % b: at_2048(rows, b) for b in (4, 2, 8)}
        return {
            "name": name, "route": "cuda", "source": source, "replaces": REPLACES,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "kernel_route": head["route"], "ms_single": head["ms_single"],
            "library_ms_single": head["library_ms_single"], "shape": head["shape"],
            **{key: {k: r[k] for k in ("shape", "route", "ms", "ms_single", "plain_ms",
                                       "library_ms", "library_ms_single", "bound_ms", "bound_by",
                                       "max_abs_err", "limit_used" if "limit_used" in r
                                       else "limit_used_by_grad")}
               for key, r in at_b.items()},
            "tolerance": tol, "shapes": rows,
        }

    z3, z2 = layouts["runs"]["zero3"], layouts["runs"]["zero2"]
    c = corpus["launches"]
    pp_runs = pipelines["runs"]
    kernels = {"kernels": [
        entry("flash_attn_fwd", SOURCE, shapes, z3["fwd_launches"],
              {"serve": served["flash_launches"], "train": trained["fwd_launches"],
               "train_gpt_zero3": z3["fwd_launches"], "train_gpt_zero2": z2["fwd_launches"],
               "train_data": c["train_data"]["fwd"], "eval": c["eval"]["fwd"],
               "serve_load": c["serve_load"]["fwd"],
               **{"train_" + n: r["fwd_launches"] for n, r in pp_runs.items()},
               "profile": loop["profile"]["fwd_launches"],
               "train_searched": loop["train"]["fwd_launches"],
               "long_context": lc["launches"]["fwd"],
               **{"train_" + n: r["fwd_launches"] for n, r in encoders["runs"].items()},
               **{"elastic_" + n: r["fwd_launches"] for n, r in elastic["runs"].items()},
               **{"train_" + n: r["fwd_launches"] for n, r in t5_swin["runs"].items()},
               **{n: r["fwd_launches"] for n, r in hf["runs"].items()},
               **{n: r["fwd_launches"] for n, r in resilience_paths(res).items()},
               **{"serve_" + n: r["fwd_launches"] for n, r in serve_mig_paths(serve_mig).items()},
               "obs_train_traced": obs["train"]["fwd_launches"],
               "obs_serve": obs["serve"]["fwd_launches"]},
              TOL_FWD_BF16),
        entry("flash_attn_bwd", BWD_SOURCE, bwd_shapes, z3["bwd_launches"],
              {"serve": 0, "train": trained["bwd_launches"],
               "train_gpt_zero3": z3["bwd_launches"], "train_gpt_zero2": z2["bwd_launches"],
               "train_data": c["train_data"]["bwd"], "eval": c["eval"]["bwd"],
               "serve_load": c["serve_load"]["bwd"],
               **{"train_" + n: r["bwd_launches"] for n, r in pp_runs.items()},
               "profile": loop["profile"]["bwd_launches"],
               "train_searched": loop["train"]["bwd_launches"],
               "long_context": lc["launches"]["bwd"],
               **{"train_" + n: r["bwd_launches"] for n, r in encoders["runs"].items()},
               **{"elastic_" + n: r["bwd_launches"] for n, r in elastic["runs"].items()},
               **{"train_" + n: r["bwd_launches"] for n, r in t5_swin["runs"].items()},
               **{n: r["bwd_launches"] for n, r in hf["runs"].items()},
               **{n: r["bwd_launches"] for n, r in resilience_paths(res).items()},
               **{"serve_" + n: r["bwd_launches"] for n, r in serve_mig_paths(serve_mig).items()},
               "obs_train_traced": obs["train"]["bwd_launches"], "obs_serve": 0},
              TOL_BWD_BF16),
        {"name": "tree_fold", "route": "cuda", "source": FOLD_SOURCE, "replaces": FOLD_REPLACES,
         "launches": res["sdc"]["runs"]["digest"]["fold_launches"],
         "launches_by_path": {"sdc_digest": res["sdc"]["runs"]["digest"]["fold_launches"],
                              "sdc_plain": res["sdc"]["runs"]["plain"]["fold_launches"],
                              "migrate": res["migrate"]["fold_launches"],
                              "lint_deep": obs["audit10"]["fold_launches"],
                              "lint_deep_planted": obs["planted"]["fold_launches"]},
         "max_abs_err": 0, "ms": fold["ms"], "plain_ms": fold["plain_ms"],
         "bound_ms": fold["bound_ms"], "bound_by": fold["bound_by"],
         "library_ms": fold["library_ms"], "library_calls": fold["library_calls"],
         "ms_single": fold["ms_single"], "bytes": fold["bytes"],
         "tolerance": "bitwise (the fold; the sum of squares is not compared)",
         "shapes": fold["rows"]},
    ]}
    results = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=build_s, ptxas=ptxas, wgmma_ptxas=wgmma_ptxas,
                   kernels=kernels["kernels"], grads=grads,
                   decode=decode, serve=served, train=trained, train_gpt_layouts=layouts,
                   corpus_checkpoint=corpus, train_pipelines=pipelines,
                   profile_search_train=loop, long_context=lc, encoder_families=encoders,
                   elastic_resume=elastic, t5_swin_families=t5_swin, hf_finetune=hf,
                   fold_kernel=fold, resilience=res, serve_migration=serve_mig,
                   observability=obs,
                   wall_s=time.perf_counter() - t_start)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)

    log("serve llama-7b (32 layers, bf16) on %s: %d requests, %.1f tok/s, TTFT p50/p90/p99 "
        "%.1f/%.1f/%.1f ms, TPOT p50/p90/p99 %.1f/%.1f/%.1f ms, decode tick median %.1f ms, "
        "weight casts %.1f ms/tick (%.1f GB), peak memory %.1f GB, flash launches %d = "
        "%d layers x %d prefills" % (
            card, s["requests"], s["tokens_per_s"], s["ttft_ms"]["p50"], s["ttft_ms"]["p90"],
            s["ttft_ms"]["p99"], s["tpot_ms"]["p50"], s["tpot_ms"]["p90"], s["tpot_ms"]["p99"],
            served["decode_tick_ms_median"], served["weight_cast_ms_per_tick"],
            served["weight_cast_gb_per_tick"], served["peak_memory_gb"],
            served["flash_launches"], served["layers"], served["prefills"]))
    # step ms: the median step period, end to end (previous step's end to
    # this one's, idle included; tokens/s and MFU come from these periods).
    # The numbers in brackets are the earlier loop's host-synced step times
    # (sync, step, sync), without the guard and the prefetch thread.
    # device: the stream's busy span of a step. loop wall: fenced wall of
    # the post-warmup loop per step.
    log("train llama-7b width (%d layers, bf16, seq 2048, global batch %d in %d micro-batches, "
        "remat %s, anomaly guard and prefetch on) on %s: step %.1f ms end to end (before: "
        "618-622 ms host-synced, without the guard and the prefetch thread), device %.1f "
        "ms/step, loop wall %.1f ms/step, host blocked %.2f ms/step, %.0f tokens/s, MFU %.3f "
        "(989 TFLOP/s), peak memory %.1f GB, losses %s, flash launches fwd %d / bwd %d"
        % (trained["layers"], trained["global_bsz"], trained["chunks"], trained["remat"], card,
           t["steady_step_ms"], t["device_step_ms"], t.get("wall_ms_per_iter", float("nan")),
           t.get("host_blocked_ms", float("nan")), t["tokens_per_s"], t.get("mfu", float("nan")),
           t["peak_hbm_mb"] * 2**20 / 1e9, ["%.4f" % x for x in t["losses"]],
           trained["fwd_launches"], trained["bwd_launches"]))
    for name, r, pr4 in (("ZeRO-3 layers 0-3 + ZeRO-2", z3, "782"),
                         ("ZeRO-2 everywhere", z2, "746")):
        g = r["summary"]
        log("train gpt-6.7b width through the layout path (%d layers, bf16, seq 2048, global "
            "batch %d in %d micro-batches, remat %s, %s, world 1, guard and prefetch on) on %s: "
            "step %.1f ms end to end (before: %s ms host-synced, without them), device %.1f "
            "ms/step, %.0f tokens/s per GPU, MFU %.3f (989 TFLOP/s), "
            "peak memory %.1f GB, losses %s, flash launches fwd %d / bwd %d" % (
                layouts["layers"], layouts["global_bsz"], layouts["chunks"], layouts["remat"],
                name, card, g["steady_step_ms"], pr4, g["device_step_ms"],
                g["tokens_per_s_per_gpu"],
                g.get("mfu", float("nan")), g["peak_hbm_mb"] * 2**20 / 1e9,
                ["%.5f" % x for x in g["losses"]], r["fwd_launches"], r["bwd_launches"]))
    log("gpt layout runs: ZeRO-3 vs ZeRO-2 losses agree within %.3g relative (tol %.0e)"
        % (max(layouts["loss_rel_err"]), layouts["tolerance"]))
    r1 = corpus["runs"]["train"]
    log("corpus, eval, checkpoint, resume (llama-7b width, %d layers, %d documents, %.1f MB) "
        "on %s: step %.1f ms end to end, valid losses %s, test loss "
        "%.5f; save %.2f GB in %.2f s (copy %.2f, digest %.2f, write %.2f), load %.2f GB in "
        "%.2f s (digest %.2f); eval passes %s ms; resumed losses %s vs %s (%s); planted NaN "
        "step skipped, state "
        "unchanged (%d tensors); serve --load %d requests, first prefill logits within %.4f; "
        "launches train %s, eval %s, serve %s; phase %.1f s" % (
            CKPT_LAYERS, CORPUS_DOCS, corpus["corpus_mb"], card,
            r1["steady_step_ms"], ["%.5f" % v for _, v in corpus["valid_losses"]],
            corpus["test_loss"], corpus["save"]["bytes"] / 1e9, corpus["save"]["seconds"],
            corpus["save"]["copy_s"], corpus["save"]["digest_s"], corpus["save"]["write_s"],
            corpus["load"]["bytes"] / 1e9, corpus["load"]["seconds"], corpus["load"]["digest_s"],
            ["%.1f" % x for x in r1["eval_pass_ms"]],
            ["%.6f" % x for x in corpus["resumed_losses"]],
            ["%.6f" % x for x in corpus["losses"][CKPT_INTERVAL:]],
            "bitwise" if corpus["resume_bitwise"] else "max diff %.3g" % max(
                corpus["resume_loss_diff"]),
            corpus["nan_step"]["leaves"], corpus["serve"]["summary"]["requests"],
            corpus["serve"]["first_prefill_err"], corpus["launches"]["train_data"],
            corpus["launches"]["eval"], corpus["launches"]["serve_load"], corpus["wall_s"]))
    if corpus["nondeterministic_warnings"]:
        log("phase 10 ops without a deterministic path (warnings): %s"
            % corpus["nondeterministic_warnings"])
    for name, r in pp_runs.items():
        log("pipeline %s (%s width, %d layers, pp %d divided %s, %s, %d steps, global batch %d "
            "in %d micro-batches, remat %s, every stage on this card) on %s: step %.1f ms "
            "(stages run one after another), peak memory %.1f GB, losses %s, gradient norms "
            "%s%s, flash launches fwd %d / bwd %d" % (
                name, "gpt-6.7b" if name.startswith("gpt") else "llama-7b",
                pipelines["layers"], r["pp"], ",".join(map(str, r["division"])),
                r["pipeline_type"] if r["pp"] > 1 else "unpipelined", r["steps"],
                pipelines["global_bsz"], r["chunks"], pipelines["remat"], card,
                r["steady_step_ms"], r["peak_memory_gb"], ["%.5f" % x for x in r["losses"]],
                ["%.5f" % x for x in r["grad_norms"]],
                ", max rel err vs unpipelined: loss %.3g, gradient norm %.3g" % (
                    max(r["losses_rel_err"]), max(r["grad_norms_rel_err"]))
                if "losses_rel_err" in r else "", r["fwd_launches"], r["bwd_launches"]))
    log("phase 11 planted fault (1F1B, stage 1 never updates): max rel err vs unpipelined: "
        "loss %.3g, gradient norm %.3g (limits %.0e, %.0e)" % (
            pipelines["planted_fault"]["max_rel_err"]["losses"],
            pipelines["planted_fault"]["max_rel_err"]["grad_norms"], TOL_PP_LOSS,
            TOL_PP_GRAD_NORM))
    log("phase 11 (pipelines) %.1f s" % pipelines["wall_s"])
    log_loop(loop, card)
    timed = [r for r in lc["runs"] if "fwd_ratio" in r]
    log("phase 13 long context (%d heads x %d, bf16, B=1, every cp rank on %s): %d ring runs "
        "checked, launches fwd %d / bwd %d (all wgmma); ring/unsharded time at S=%d: %s; "
        "phase %.1f s" % (
            lc["heads"], lc["head_dim"], card, len(lc["runs"]), lc["launches"]["fwd"],
            lc["launches"]["bwd"], LC_SEQ, "; ".join(
                "%s cp %d fwd x%.3f bwd x%.3f" % (r["mode"], r["cp"], r["fwd_ratio"],
                                                  r["bwd_ratio"]) for r in timed),
            lc["wall_s"]))
    log_encoders(encoders, card)
    log_elastic(elastic, card)
    log_t5_swin(t5_swin, card)
    log_hf_finetune(hf, card)
    log_resilience(fold, res, card)
    log_serve_migration(serve_mig, card)
    log_observability(obs, card)
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
