"""``python -m galvatron_tpu_torch.cli serve`` — searched-strategy inference.

Port of ``galvatron_tpu/cli/serve.py``: builds the model's shards under the
strategy (the global flags or a ``--galvatron_config_path`` JSON, such as
``cli search --objective serve`` writes) from fresh weights (seeded by
``--seed``) or the parameters of a train checkpoint (``--load``,
``--load_iteration``: a checkpoint of any strategy and world size, restored
into the serve layout with each rank reading only the slices it holds, as
``cli train --elastic resume`` restores; the optimizer state is not read),
the prefill/decode engine over the strategy-sharded KV cache (serve/),
drives a synthetic or replayed request load through the continuous batcher
on every rank, and reports TTFT/TPOT percentiles and tokens/s (per GPU).

    torchrun --nproc_per_node 4 -m galvatron_tpu_torch.cli serve \\
        --model_type llama --model_size llama-7b --galvatron_config_path s.json

One process per GPU under ``torchrun`` (gloo ranks with ``--device cpu``);
without it a world of one. The strategy is linted in serve mode first:
pp>1, ring-cp and ulysses layouts refuse with GLS014 (the decode step
cannot run them), and ``runtime.model_api.check_layout`` refuses vocab sp
and vocab cp. Rank 0 prints and writes the telemetry.

Resilience, as in the reference, polled once per scheduler iteration in the
train loop's step-boundary order (hooks -> preemption -> watchdog -> mesh
probe), every rank taking the same branch through one all-reduced flag
vector (``runtime.distributed.agree_max``):

- ``--watchdog`` arms ``runtime/health.Watchdog`` around every prefill and
  decode tick; a first missed deadline is logged (the synchronous tick has
  returned by then), a second one drains the batcher gracefully (admitted
  requests finish or shed retryable, pending ones shed retryable) and
  `main` exits 3. SIGTERM or SIGINT drains the same way and exits 0;
- ``--mesh_probe_interval`` probes the world between iterations, and on a
  degraded verdict ``--migrate_on_degrade`` re-plans serving for the
  surviving ranks (``--elastic_strategy`` or a fresh ``--objective serve``
  search, ``runtime/elastic.py``), moves the params in memory, rebuilds the
  KV cache in the new layout and journal-replays the in-flight requests (a
  ``serve_migrate`` event); the ranks that left return at once (exit 0). A
  surviving world that cannot serve drains and exits 2 (GLS015).
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from galvatron_tpu_torch.cli.arguments import (
    hp_config_from_args,
    initialize_galvatron,
    model_config_from_args,
)
from galvatron_tpu_torch.obs import telemetry
from galvatron_tpu_torch.runtime import distributed


def serve(args) -> dict:
    """Returns the load summary dict (``{"departed": True, ...}`` on a rank
    that left the world in a serve migration); with --telemetry rank 0
    streams the serve_request/decode_batch events to JSONL. Runs inside a
    process group that it tears down (`runtime.distributed.process_group`)."""
    with distributed.process_group(args.device) as device:
        sink = None
        if getattr(args, "telemetry", None) and distributed.rank() == 0:
            sink = telemetry.JsonlSink(
                args.telemetry,
                depth=max(int(getattr(args, "telemetry_buffer", 1024) or 1), 1),
            )
            telemetry.install(sink)
        try:
            return _serve(args, device)
        finally:
            if sink is not None:
                telemetry.uninstall(sink)
                sink.close()


def _per_rank(obj) -> list:
    """`obj` of every rank, in rank order (collective)."""
    if distributed.world_size() == 1:
        return [obj]
    every = [None] * distributed.world_size()
    torch.distributed.all_gather_object(every, obj)
    return every


def _serve(args, device) -> dict:
    fam, cfg = model_config_from_args(args)
    if cfg.head_type != "lm":
        raise ValueError("serving supports the generic causal-LM families only; %r has a %s "
                         "head" % (fam.name, cfg.head_type))
    if fam.build is not None:
        raise ValueError("serving supports the generic causal-LM families only; %r builds its "
                         "own model tree" % fam.name)
    world = args.world_size or distributed.world_size()
    hp = hp_config_from_args(args, cfg.num_layers, world)
    say = print if distributed.rank() == 0 else (lambda *a, **k: None)

    # fail fast before building anything: decode-incompatible layouts (pp>1,
    # ring cp, ulysses) refuse with GLS014
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

    report = _slint.lint_hp(hp, model_cfg=cfg, file=getattr(args, "galvatron_config_path", None),
                            mode="serve")
    for d in report.warnings:
        say("strategy lint: %s" % d.format())
    if not report.ok:
        raise DiagnosticError(report.errors)
    if world != distributed.world_size():
        raise ValueError("the strategy is for a world of %d but the process group has %d "
                         "rank(s): launch with torchrun --nproc_per_node %d"
                         % (world, distributed.world_size(), world))

    from galvatron_tpu_torch.ops import flash_attention as TF
    from galvatron_tpu_torch.runtime import elastic as els
    from galvatron_tpu_torch.runtime import health as hlth
    from galvatron_tpu_torch.runtime import resilience as rsl
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.serve.engine import (
        ContinuousBatcher,
        ServeEngine,
        replay_requests,
        summarize,
        synthetic_requests,
    )
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, kv_bytes_per_slot

    model = construct_hybrid_parallel_model(cfg, hp, device, mode="serve")
    restore = None
    if getattr(args, "load", None):
        from galvatron_tpu_torch.runtime import checkpoint as ckpt

        # strategy-portable restore, params only: a train-layout checkpoint
        # of any strategy and world size fills this rank's serve shards
        # from the saved ranks' files (only the slices it holds)
        params, _, meta = ckpt.load_checkpoint(
            args.load, args.load_iteration, params_target=model.empty_params(),
            target=model, allow_cross=True, model_cfg=cfg)
        restore = meta["restore"]
        say("restored %s at iteration %s into the serve layout" % (args.load,
                                                                   meta.get("iteration")))
    else:
        params = model.init_params(args.seed)

    # cache geometry: CLI flags win, then the strategy JSON's serve knobs,
    # then defaults; pages default to covering the model's max_seq_len
    max_slots = args.serve_max_concurrency or hp.serve_max_concurrency or 8
    page = args.serve_page_size or hp.serve_page_size or 16
    max_pages = args.serve_max_pages or -(-cfg.max_seq_len // page)
    kv_cfg = KVCacheConfig(max_slots=max_slots, page_size=page, max_pages=max_pages)
    hooks = getattr(args, "fault_hooks", None)  # test seam; None in production

    def build_engine(model_, params_, kv_):
        eng = ServeEngine(cfg, params_[0], kv_, device=device, temperature=args.temperature,
                          rng_seed=args.seed, hp=model_.hp, mesh=model_.mesh)
        # fault-injection seam: a test wraps the decode ticks (a stalled
        # tick) and observes each scheduler step
        if hooks is not None and hooks.wrap_step_fn:
            eng.decode_step = hooks.wrap_step_fn(eng.decode_step)
        return eng

    engine = build_engine(model, params, kv_cfg)

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

    # ------------------------------------------------------ resilience stack
    wd = None
    if getattr(args, "watchdog", 0):
        wd = hlth.Watchdog(hlth.WatchdogConfig(
            floor_s=float(args.watchdog),
            factor=float(getattr(args, "watchdog_factor", 4.0)),
            startup_deadline_s=float(getattr(args, "watchdog_startup_s", 600.0)),
        )).start()
    # the mesh probe: live ranks against the strategy's plus one timed
    # all-reduce (`probe_devices_fn` is the test seam for a lost rank)
    probe_fn = getattr(args, "probe_devices_fn", None) or (
        hooks.probe_devices_fn if hooks is not None else None)

    def new_monitor(interval_s):
        return hlth.MeshHealthMonitor(interval_s=interval_s, devices_fn=probe_fn, device=device)

    mesh_monitor = None
    if getattr(args, "mesh_probe_interval", 0):
        mesh_monitor = new_monitor(float(args.mesh_probe_interval))
    preempt = rsl.PreemptionHandler().install()
    state = {"interrupted": None, "error": None, "departed": False, "probes": 0,
             "migrations": []}

    def do_serve_migrate(reason: str, verdict: dict, b: ContinuousBatcher) -> None:
        """Degraded-mesh serve migration: re-plan for the surviving ranks,
        move the params in memory, rebuild the KV cache, journal-replay the
        in-flight requests. Raises DiagnosticError (GLS015) when the
        surviving world cannot serve."""
        nonlocal model, params, hp, kv_cfg, mesh_monitor
        t0 = time.perf_counter()
        if wd is not None:
            wd.disarm()
        survivors = list(verdict["live_ids"])
        new_hp, action = els.resolve_serve_migration_strategy(args, cfg, len(survivors), hp,
                                                              kv_cfg)
        result = els.migrate_serve_params(model, params, new_hp, survivors=survivors,
                                          reason=reason)
        if result.departed:
            state["departed"] = True
            return
        new_kv = KVCacheConfig(max_slots=new_hp.serve_max_concurrency or kv_cfg.max_slots,
                               page_size=kv_cfg.page_size, max_pages=kv_cfg.max_pages)
        res = b.migrate_to(build_engine(result.model, result.params, new_kv), new_kv)
        seconds = time.perf_counter() - t0
        telemetry.emit(
            "serve_migrate", from_world=hp.world_size, to_world=new_hp.world_size,
            replayed=res["replayed"], shed=res["shed"], duration_ms=seconds * 1e3,
            reason=reason, from_strategy=hp.to_json_dict(), to_strategy=new_hp.to_json_dict(),
            kv_slots=new_kv.max_slots, kv_pages=new_kv.max_pages)
        state["migrations"].append(dict(res, reason=reason, action=action, seconds=seconds,
                                        from_world=hp.world_size, to_world=new_hp.world_size,
                                        to_strategy=new_hp.to_json_dict()))
        say("serve migration (%s/%s): world %d -> %d, %s relayout, %d in-flight replayed, "
            "%d shed, %.3f s" % (reason, action, hp.world_size, new_hp.world_size,
                                 "same pipeline layout" if result.same_layout else "pipeline",
                                 res["replayed"], res["shed"], seconds))
        model, params, hp, kv_cfg = result.model, result.params, new_hp, new_kv
        if mesh_monitor is not None:
            mesh_monitor = new_monitor(mesh_monitor.interval_s)

    def control(b: ContinuousBatcher) -> Optional[str]:
        """Polled once per scheduler iteration, in the train loop's
        step-boundary order: hooks -> preemption -> watchdog -> mesh probe.
        Returns a drain reason to wind the batcher down, else None."""
        if hooks is not None and hooks.on_step:
            hooks.on_step(b.decode_steps)
        flags = distributed.agree_max([
            float(preempt.triggered),
            float(wd is not None and wd.abort_requested),
            float(wd is not None and wd.retry_requested),
            float(mesh_monitor is not None and mesh_monitor.due()),
        ], device)
        if flags[0]:
            state["interrupted"] = preempt.signal_name or "SIGTERM"
            telemetry.emit("preemption", signal=state["interrupted"], iter=b.decode_steps)
            return state["interrupted"]
        if wd is not None:
            if flags[1]:
                # a second missed deadline: graceful drain, exit 3 (main)
                state["interrupted"] = "watchdog"
                return "watchdog"
            if flags[2]:
                # a first missed deadline: the stalled tick has returned by
                # now (the batcher is synchronous); log and go on
                wd.take_retry_request()
                telemetry.runtime_log("serve watchdog: tick stalled past its deadline at "
                                      "step %d; retrying" % b.decode_steps)
        if flags[3]:
            verdict = mesh_monitor.probe()
            state["probes"] += 1
            if verdict["status"] != "healthy":
                telemetry.emit("watchdog", action="mesh_probe", iter=b.decode_steps,
                               status=verdict["status"], expected=verdict["expected"],
                               live=verdict["live"], missing_ids=verdict["missing_ids"] or None,
                               detail=verdict.get("error"))
                telemetry.runtime_log("mesh probe: %s (expected %d ranks, live %d)"
                                      % (verdict["status"], verdict["expected"],
                                         verdict["live"]))
            if verdict["status"] == "degraded" and getattr(args, "migrate_on_degrade", 0):
                try:
                    do_serve_migrate("degraded_mesh", verdict, b)
                except DiagnosticError as e:
                    # GLS015: the surviving world cannot serve: drain
                    # (admitted requests complete or shed retryable), then
                    # _serve re-raises for the exit-2 contract
                    state["error"] = e
                    return "migrate_infeasible"
                if state["departed"]:
                    # this rank left the world: nothing of the load is its
                    b.slot_req = [None] * len(b.slot_req)
                    return "departed"
        return None

    # shedding knobs: CLI flags win, then the strategy JSON's serve_* knobs
    batcher = ContinuousBatcher(
        engine, kv_cfg,
        p99_ttft_ms=getattr(args, "p99_ttft_ms", 0.0) or hp.serve_p99_ttft_ms,
        max_pending=getattr(args, "max_pending", 0) or hp.serve_max_pending,
        request_timeout_s=getattr(args, "request_timeout_s", 0.0) or 0.0,
        min_shed_samples=int(getattr(args, "shed_min_samples", 3) or 3),
        watchdog=wd, control=control,
        # the ranks' scheduling decisions agree (a world of one reads its
        # clock live, as the reference's one controller)
        agree=(lambda values: distributed.agree_max(values, device)) if world > 1 else None,
    )
    launches0 = TF.flash_attention_fwd.launches
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    try:
        completed = batcher.run(reqs)
    finally:
        preempt.uninstall()
        if wd is not None:
            wd.stop()
    wall = time.monotonic() - t0
    if state["departed"]:
        return {"departed": True, "rank_before": distributed.rank(),
                "migrations": state["migrations"]}
    if state["error"] is not None:
        telemetry.emit("serve_drain", reason="migrate_infeasible",
                       completed=len(batcher.completed), shed=len(batcher.shed), exit_code=2)
        raise state["error"]

    summary = summarize(completed, wall, world_size=hp.world_size, shed=batcher.shed)
    summary["decode_steps"] = batcher.decode_steps
    summary["migrations"] = state["migrations"]
    summary["mesh_probes"] = state["probes"]
    summary["drain"] = batcher.drain_reason
    if state["interrupted"] is not None:
        summary["interrupted"] = state["interrupted"]
    if wd is not None:
        summary["watchdog"] = wd.summary()
    summary["device"] = str(device)
    summary["world_size"] = hp.world_size
    if restore is not None:
        summary["checkpoint_restore"] = {k: v for k, v in restore.items()
                                         if k in ("bytes", "seconds", "cross_strategy")}
    # every rank's forward-kernel launches and peak device memory
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    ranks = _per_rank({"flash_fwd_launches": TF.flash_attention_fwd.launches - launches0,
                       "peak_memory_gb": peak})
    summary["per_rank"] = ranks
    bytes_per = 2 if args.mixed_precision == "bf16" else 4
    summary["kv_mb_per_slot"] = kv_bytes_per_slot(
        cfg, kv_cfg.max_ctx, dtype_bytes=bytes_per) / 2**20
    summary["outputs"] = {r.rid: list(r.output) for r in completed}
    say("served %d requests in %.2f s on %d x %s: %.1f tok/s (%.2f tok/s/device), "
        "%d decode steps" % (
            summary["requests"], wall, hp.world_size, device.type, summary["tokens_per_s"],
            summary["tokens_per_s_per_chip"], batcher.decode_steps))
    if summary["shed"]:
        say("shed %d request(s) (%d retryable): %s" % (
            summary["shed"], summary["shed_retryable"],
            ", ".join("%s=%d" % kv for kv in sorted(summary["shed_by_reason"].items()))))
    if summary["drain"]:
        say("drained (%s): %d completed, %d shed" % (
            summary["drain"], summary["requests"], summary["shed"]))
    if summary["migrations"]:
        say("live serve migrations: %d (now world %d)" % (len(summary["migrations"]),
                                                         hp.world_size))
    for name in ("ttft_ms", "tpot_ms"):
        p = summary[name]
        say("%s p50/p90/p99: %.1f / %.1f / %.1f" % (name, p["p50"], p["p90"], p["p99"]))
    return summary


def main(argv: Optional[list] = None):
    args = initialize_galvatron(argv=argv)
    try:
        summary = serve(args)
    except Exception as e:
        from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

        if isinstance(e, DiagnosticError) and any(
                d.code.startswith("GLS2") or d.code == "GLS015" for d in e.diagnostics):
            # the degraded-world refusal contract (as train): actionable
            # diagnostics on stderr and exit code 2, "needs operator input"
            for d in e.diagnostics:
                print(d.format(), file=sys.stderr)
            sys.exit(2)
        raise
    if (summary.get("watchdog") or {}).get("escalated"):
        from galvatron_tpu_torch.runtime.health import WATCHDOG_EXIT_CODE

        # the batcher drained after a wedged tick: "resume me", not "retry
        # blindly"; a SIGTERM drain returns normally (exit 0)
        print("serve watchdog escalated: batcher drained; exiting %d" % WATCHDOG_EXIT_CODE,
              file=sys.stderr)
        sys.exit(WATCHDOG_EXIT_CODE)
    return summary


if __name__ == "__main__":
    main()
