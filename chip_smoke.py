#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (galvatron_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA GPU + nvcc

Phases, in order; any failure exits non-zero and prints no result line:

1. Identify the card (nvidia-smi name and power limit); TF32 off.
2. Build the flash-attention forward kernel from csrc/ with nvcc (sm_90a)
   and hold it against its plain PyTorch version on the card, in bf16, at
   B=1, nh=32, hd=128, S in {128, 512, 1536, 2048}, causal, with and without a
   key-padding tail, on ALL rows (plus one fp32 and one head_dim-256 case).
   Times the kernel, the plain version and, as a yardstick the port never
   calls, torch's scaled_dot_product_attention (CUDA events, median of 25).
3. Decode against recompute: LLaMA-7B width at depth 4, bf16, through
   ServeEngine (prefill, then 4 decode steps); each step's logits against a
   full-sequence recompute through the plain attention path.
4. Serve: ``galvatron_tpu_torch.cli.serve.main`` in-process, LLaMA-7B at
   full depth (32 layers), 16 requests; asserts every request completes,
   the logits stay finite, and the flash kernel launched exactly
   32 x prefills times. Also times the fp32 -> bf16 weight casts one decode
   tick performs.

The last lines of standard output are the serve summary, the ``kernels``
JSON line, the card line, and ``{"ok": true, "device": {...}}``. Details go
to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import os
import random
import statistics
import subprocess
import sys
import time

SEED = 1234
# kernel vs plain version, elementwise |out - ref| <= atol + rtol * |ref|.
# bf16: the output rounds to bf16 (one ulp is 2^-8 relative: 0.0156 at
# |x| in [2, 4)) and the tensor-core path rounds p to bf16 before P.V, as
# the Pallas kernel does (2^-9 relative per term).
TOL_BF16 = 2e-2
RTOL_BF16 = 1e-2
TOL_FP32 = 1e-4  # fp32 inputs: the two differ only in summation order
TOL_LSE = 1e-3   # fp32 logsumexp, both fp32 math
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


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1
def identify_card():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, "nvidia-smi failed: %s" % proc.stderr.strip())
    line = proc.stdout.strip().splitlines()[0].strip()
    return line


# ------------------------------------------------------------------ phase 2
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


def admitted_pairs(torch, s, valid, causal):
    """(query, key) pairs the masks admit, per (batch, head): the work a
    flash kernel must do on these inputs."""
    rows = torch.arange(s)
    if causal:
        per_row = rows + 1
        if valid < s:
            # valid rows see valid keys <= row; pad rows see pad keys <= row
            per_row = torch.where(rows < valid, rows + 1, rows - valid + 1)
    else:
        per_row = torch.full((s,), s) if valid == s else torch.where(
            rows < valid, torch.full((s,), valid), torch.full((s,), s - valid))
    return int(per_row.sum().item())


def bound_ms(torch, b, s, nh, hd, valid, causal, dtype):
    elem = 2 if dtype == torch.bfloat16 else 4
    flops = 4.0 * hd * admitted_pairs(torch, s, valid, causal) * nh * b
    nbytes = 4.0 * b * s * nh * hd * elem + 4.0 * b * nh * s  # q, k, v, o + lse
    if valid < s:
        nbytes += 2 * 4.0 * b * s  # q and kv segment ids
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def check_kernel(torch, TF, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cases = []
    for s in (128, 512, 1536, 2048):
        for padded in (False, True):
            cases.append(dict(s=s, nh=32, hd=128, padded=padded, causal=True,
                              dtype=torch.bfloat16))
    cases.append(dict(s=512, nh=32, hd=128, padded=True, causal=False, dtype=torch.bfloat16))
    cases.append(dict(s=512, nh=32, hd=128, padded=True, causal=True, dtype=torch.float32))
    cases.append(dict(s=512, nh=8, hd=256, padded=True, causal=True, dtype=torch.bfloat16))
    results = []
    for c in cases:
        b, s, nh, hd, dtype, causal = 1, c["s"], c["nh"], c["hd"], c["dtype"], c["causal"]
        q, k, v = (torch.randn((b, s, nh, hd), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        valid = s - s // 8 - 3 if c["padded"] else s
        seg = None
        if c["padded"]:
            ids = (torch.arange(s, device=dev) < valid).to(torch.int32)[None].contiguous()
            seg = TF.SegmentIds(q=ids, kv=ids)
        scale = hd ** -0.5
        out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=scale, segment_ids=seg)
        torch.cuda.synchronize()
        ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=scale,
                                                        segment_ids=seg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), "kernel output not finite at %s" % c)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol, rtol = (TOL_BF16, RTOL_BF16) if dtype == torch.bfloat16 else (TOL_FP32, 0.0)
        n_bad = int((diff > tol + rtol * ref.float().abs()).sum().item())
        check(n_bad == 0, "kernel vs plain: %d elements off by more than %.3g + %.3g|ref| "
              "(max abs err %.3g) at %s" % (n_bad, tol, rtol, err, c))
        check(lse_err <= TOL_LSE, "kernel lse err %.3g > %.3g at %s" % (lse_err, TOL_LSE, c))
        kernel = time_ms(torch, lambda: TF.flash_attention_fwd(
            q, k, v, causal=causal, sm_scale=scale, segment_ids=seg))
        plain = time_ms(torch, lambda: TF.flash_attention_fwd_reference(
            q, k, v, causal=causal, sm_scale=scale, segment_ids=seg), reps=21)
        library = None
        if not c["padded"]:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale))
        bms, by, flops = bound_ms(torch, b, s, nh, hd, valid, causal, dtype)
        r = dict(shape=[b, s, nh, hd], dtype=str(dtype).replace("torch.", ""), causal=causal,
                 valid_len=valid, max_abs_err=err, lse_err=lse_err, tolerance=tol, rtol=rtol,
                 ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bms, bound_by=by,
                 gflop=flops / 1e9, tflops=flops / kernel / 1e9)
        results.append(r)
        log("flash S=%d nh=%d hd=%d %s %s%s: err %.3g lse %.3g | kernel %.3f ms, plain %.3f ms, "
            "sdpa %s ms, bound %.4f ms (%s), %.1f TFLOP/s" % (
                s, nh, hd, r["dtype"], "padded" if c["padded"] else "full",
                "" if causal else " non-causal", err, lse_err,
                kernel, plain, "%.3f" % library if library is not None else "-", bms, by,
                r["tflops"]))
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 3
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
    params = model.init_params(SEED)
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


# ------------------------------------------------------------------ phase 4
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

    t0 = time.perf_counter()
    so = TF.build()
    build_s = time.perf_counter() - t0
    with open(so + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    log("built %s in %.1f s\n  %s" % (os.path.relpath(so), build_s, "\n  ".join(ptxas)))

    shapes = check_kernel(torch, TF, dev)
    decode = decode_vs_recompute(torch, dev)
    served = serve(torch, TF)
    s = served["summary"]

    head = next(r for r in shapes if r["shape"] == [1, 2048, 32, 128] and r["valid_len"] == 2048
                and r["dtype"] == "bfloat16" and r["causal"])
    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": served["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes if r["dtype"] == "bfloat16"),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["shape"], "tolerance": TOL_BF16, "rtol": RTOL_BF16, "shapes": shapes,
    }]}
    results = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                   build_s=build_s, ptxas=ptxas, kernels=kernels["kernels"], decode=decode,
                   serve=served, wall_s=time.perf_counter() - t_start)
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
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
