"""``python -m galvatron_tpu_torch.cli serve`` — inference on one device.

Port of ``galvatron_tpu/cli/serve.py``: builds the model from fresh weights
(seeded by ``--seed``), the prefill/decode engine over the KV cache
(serve/), drives a synthetic or replayed request load through the
continuous batcher, and reports TTFT/TPOT percentiles and tokens/s.

    python -m galvatron_tpu_torch.cli serve --model_type llama \\
        --model_size llama-7b --device cuda --num_requests 16

The strategy is linted in serve mode first: pp>1, ring-cp and ulysses
layouts refuse with GLS014, and any layout other than world size 1 refuses
with a ValueError (the tp/dp serve layouts come in a later slice). The run
happens on ``--device`` (default ``cuda``); with no GPU visible ``cuda``
raises. Checkpoint restore, the serve watchdog and degraded-mesh migration
are not ported yet and their flags are refused.
"""

from __future__ import annotations

import time
from typing import Optional

from galvatron_tpu_torch.cli.arguments import (
    hp_config_from_args,
    initialize_galvatron,
    model_config_from_args,
    resolve_device,
)
from galvatron_tpu_torch.obs import telemetry


def serve(args) -> dict:
    """Returns the load summary dict; with --telemetry the
    serve_request/decode_batch events stream to JSONL."""
    sink = None
    if getattr(args, "telemetry", None):
        sink = telemetry.JsonlSink(
            args.telemetry,
            depth=max(int(getattr(args, "telemetry_buffer", 1024) or 1), 1),
        )
        telemetry.install(sink)
    try:
        return _serve(args)
    finally:
        if sink is not None:
            telemetry.uninstall(sink)
            sink.close()


def _serve(args) -> dict:
    device = resolve_device(args.device)
    fam, cfg = model_config_from_args(args)
    world = args.world_size or 1
    hp = hp_config_from_args(args, cfg.num_layers, world)

    # fail fast before building anything: decode-incompatible layouts (pp>1,
    # ring cp, ulysses) refuse with GLS014
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

    report = _slint.lint_hp(
        hp, file=getattr(args, "galvatron_config_path", None), mode="serve")
    for d in report.warnings:
        print("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)

    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.serve.engine import (
        ContinuousBatcher,
        ServeEngine,
        replay_requests,
        summarize,
        synthetic_requests,
    )
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, kv_bytes_per_slot

    model = construct_hybrid_parallel_model(cfg, hp, device)
    params = model.init_params(args.seed)

    # cache geometry: CLI flags win, then the strategy JSON's serve knobs,
    # then defaults; pages default to covering the model's max_seq_len
    max_slots = args.serve_max_concurrency or hp.serve_max_concurrency or 8
    page = args.serve_page_size or hp.serve_page_size or 16
    max_pages = args.serve_max_pages or -(-cfg.max_seq_len // page)
    kv_cfg = KVCacheConfig(max_slots=max_slots, page_size=page, max_pages=max_pages)

    engine = ServeEngine(
        cfg, params, kv_cfg, device=device,
        temperature=args.temperature, rng_seed=args.seed,
    )

    if args.replay:
        reqs = replay_requests(args.replay, vocab_size=cfg.vocab_size, seed=args.seed)
    else:
        pmax = max(args.prompt_len_min,
                   min(args.prompt_len_max, kv_cfg.max_ctx - args.max_new_tokens))
        reqs = synthetic_requests(
            args.num_requests, vocab_size=cfg.vocab_size, seed=args.seed,
            rate_rps=args.rate_rps,
            prompt_len_range=(args.prompt_len_min, pmax),
            max_new_tokens=args.max_new_tokens,
        )

    # shedding knobs: CLI flags win, then the strategy JSON's serve_* knobs
    batcher = ContinuousBatcher(
        engine, kv_cfg,
        p99_ttft_ms=getattr(args, "p99_ttft_ms", 0.0) or hp.serve_p99_ttft_ms,
        max_pending=getattr(args, "max_pending", 0) or hp.serve_max_pending,
        request_timeout_s=getattr(args, "request_timeout_s", 0.0) or 0.0,
        min_shed_samples=int(getattr(args, "shed_min_samples", 3) or 3),
    )
    t0 = time.monotonic()
    completed = batcher.run(reqs)
    wall = time.monotonic() - t0

    summary = summarize(completed, wall, world_size=hp.world_size, shed=batcher.shed)
    summary["decode_steps"] = batcher.decode_steps
    summary["drain"] = batcher.drain_reason
    summary["device"] = str(device)
    bytes_per = 2 if args.mixed_precision == "bf16" else 4
    summary["kv_mb_per_slot"] = kv_bytes_per_slot(
        cfg, kv_cfg.max_ctx, dtype_bytes=bytes_per) / 2**20
    print("served %d requests in %.2f s on %s: %.1f tok/s (%.2f tok/s/device), "
          "%d decode steps" % (
              summary["requests"], wall, device, summary["tokens_per_s"],
              summary["tokens_per_s_per_chip"], batcher.decode_steps))
    if summary["shed"]:
        print("shed %d request(s) (%d retryable): %s" % (
            summary["shed"], summary["shed_retryable"],
            ", ".join("%s=%d" % kv for kv in
                      sorted(summary["shed_by_reason"].items()))))
    for name in ("ttft_ms", "tpot_ms"):
        p = summary[name]
        print("%s p50/p90/p99: %.1f / %.1f / %.1f"
              % (name, p["p50"], p["p90"], p["p99"]))
    return summary


def main(argv: Optional[list] = None):
    args = initialize_galvatron(argv=argv)
    return serve(args)


if __name__ == "__main__":
    main()
