"""Structured runtime telemetry: a buffered, schema-versioned JSONL stream.

A copy of ``galvatron_tpu/obs/telemetry.py`` with the same v1 event schema,
so the port's serve batcher emits ``serve_request``, ``decode_batch`` and
``serve_shed`` events that either package's readers accept, and the same
sinks:

- :class:`TelemetrySink` — validate-and-record API (``emit(type, **fields)``).
  Every event gets an envelope (schema version, wall time, monotonic
  sequence number) and is checked against :data:`EVENT_SCHEMAS`: unknown
  event types and unknown keys are rejected at emit time AND at read time.
- :class:`JsonlSink` — writes on a daemon writer thread fed by a bounded
  queue; ``close()`` drains everything, and a writer-side exception is
  re-raised to the producer on the next emit/flush/close.
- :class:`MemorySink` — in-memory list backend for tests.
- a process-wide *active sink* (:func:`install` / :func:`emit`); with no sink
  installed the module-level :func:`emit` is a no-op.
- :func:`runtime_log` — prints and records the same line as a ``log`` event.

stdlib-only.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA_VERSION = 1

# Envelope keys stamped onto every event by the sink.
ENVELOPE_KEYS = ("v", "t", "seq", "type")

# type -> (required field names, optional field names). Unknown types and
# unknown keys are rejected; None-valued optional fields are dropped at emit
# so readers never see explicit nulls.
EVENT_SCHEMAS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    # one per run: identity + the constants per-step MFU is computed from
    "run_start": (
        ("model", "world_size"),
        ("strategy", "train_iters", "global_bsz", "start_iter",
         "model_flops_per_step", "peak_flops", "device_kind", "pipeline_type",
         "num_layers", "resumed_from",
         # model-shape identity: enough for the offline calibrator
         # (report --emit_profiles) to rebuild analytic base tables and the
         # profiler's file tag without the live model config
         "model_type", "hidden_size", "num_heads", "num_kv_heads",
         "ffn_hidden", "vocab_size", "seq_len", "mixed_precision",
         "activation"),
    ),
    # one-off program build cost + the compiler-reported working set the
    # MemoryCostModel prediction is checked against
    "compile": (
        (),
        ("trace_ms", "compile_ms", "compiled_memory_mb", "xla_flops_per_step",
         "cache_hit"),
    ),
    # the per-step record (emitted at drain time under the dispatch-ahead
    # loop; iter_ms is dispatch->drain latency, which overlaps across steps)
    "step": (
        ("iter",),
        ("loss", "iter_ms", "dispatch_ms", "host_blocked_ms",
         "hbm_in_use_mb", "hbm_peak_mb", "mfu", "model_flops_per_s",
         "grad_norm"),
    ),
    "eval": (("iter", "split", "loss"), ()),
    # lifecycle: checkpointing
    "checkpoint_save": (("iteration",), ("duration_ms", "emergency", "path")),
    "checkpoint_restore": (
        ("iteration",),
        ("duration_ms", "path", "torn_skipped", "cross_strategy"),
    ),
    "checkpoint_gc": (("deleted",), ("path",)),
    # lifecycle: resilience
    "anomaly_skip": (("iter", "verdict"), ("loss", "strikes")),
    "rollback": (("to_iter",), ("at_iter", "count", "stream_offset")),
    "retry": (("description", "attempt"), ("error", "delay_s")),
    "preemption": (("signal",), ("iter",)),
    # the training watchdog (runtime/health.py): a missed progress deadline
    # ("fire" -> drain-and-retry, "escalate" -> emergency save + exit 3),
    # a stalled prefetch producer, or a degraded/wedged mesh-probe verdict —
    # each with the diagnostic dump the post-mortem needs (in-flight window
    # depth, last drained step, per-thread stacks)
    "watchdog": (
        ("action",),
        ("iter", "phase", "elapsed_s", "deadline_s", "inflight_depth",
         "last_drained", "fires", "stacks", "detail", "status",
         "expected", "live", "missing_ids"),
    ),
    # lifecycle: elastic resume / re-search; action="migrate" is the LIVE
    # in-memory strategy swap (runtime/elastic.migrate) and carries the full
    # before/after strategy JSON
    "elastic": (
        ("action",),
        ("saved_world", "live_world", "reason", "iter", "from_strategy",
         "to_strategy", "duration_ms", "same_layout"),
    ),
    # per-LayerRun prediction record (obs/attribution.py): what the search
    # engine's cost models expect, so the report can lay measured numbers
    # beside it
    "layer_run": (
        ("run", "start", "stop"),
        ("strategy", "predicted_ms", "predicted_memory_mb", "flops",
         "flops_share", "tp_comm_mode", "predicted_comm_ms",
         "predicted_comm_hidden_ms", "grad_comm_dtype",
         "predicted_quant_overhead_ms", "remat_policy",
         "predicted_recompute_ms"),
    ),
    # measured compute/collective overlap of the decomposed TP path
    # (parallel/tp_shard_map.measure_comm_hidden): per TP LayerRun, the
    # wall-clock of the run under the overlapped schedule vs the serialized
    # manual schedule — comm_hidden_ms is the communication the chunked
    # ppermute pipeline moved off the critical path
    "tp_overlap": (
        ("run",),
        ("start", "stop", "mode", "overlap_ms", "serial_ms",
         "comm_hidden_ms"),
    ),
    # comm-precision axis (parallel/quant_collectives.py): the run's wire
    # dtypes (comma list per layer), the measured quantize+dequantize toll,
    # and the bytes-on-wire estimate vs an fp32 sync — `cli report` joins
    # these into the predicted-vs-measured view
    "quant_comm": (
        ("grad_comm_dtype",),
        ("param_comm_dtype", "comm_quant_block", "tp_comm_quant",
         "quant_overhead_ms", "wire_mb_fp32", "wire_mb_configured"),
    ),
    # serving (serve/engine.ContinuousBatcher): one per completed request —
    # the raw timestamps (seconds on the batcher clock) plus the derived
    # latencies, so the report can recompute percentiles from either
    "serve_request": (
        ("id",),
        ("arrival_t", "prefill_start_t", "first_token_t", "done_t",
         "prompt_len", "output_len", "ttft_ms", "tpot_ms"),
    ),
    # one per decode tick: batch occupancy + the bucket it routed to
    "decode_batch": (
        ("step",),
        ("occupancy", "slots", "step_ms", "bucket_pages", "tokens"),
    ),
    # one per shed/failed request (admission control + overload shedding):
    # reason is "oversize" | "deadline" | "predicted_ttft" | "queue_full" |
    # "drain" | "prefill_error" | "decode_error" | "migrate_infeasible" |
    # "migrate_prefill_error"; retryable is 0/1 (oversize is the only
    # non-retryable rejection today)
    "serve_shed": (
        ("id", "reason"),
        ("retryable", "prompt_len", "output_len", "waited_ms",
         "predicted_ttft_ms", "queue_depth", "error"),
    ),
    # one per graceful drain (SIGTERM/SIGINT, watchdog escalation, or an
    # explicit control-plane drain): how the in-flight + pending load was
    # disposed of
    "serve_drain": (
        ("reason",),
        ("completed", "active_completed", "active_shed", "pending_shed",
         "shed", "exit_code"),
    ),
    # one per degraded-mesh serve migration: the world transition plus how
    # many in-flight requests were journal-replayed vs shed
    "serve_migrate": (
        ("from_world", "to_world"),
        ("replayed", "shed", "duration_ms", "reason", "from_strategy",
         "to_strategy", "kv_slots", "kv_pages"),
    ),
    # silent-corruption sentinel (runtime/sdc.py). sdc_check is the
    # high-volume heartbeat — one per digested step (mode="digest"/"vote",
    # gated by --sdc_interval) or per continuity assert (mode="continuity",
    # state motion named by `where`); like serve_shed it stays OFF the
    # report timeline. sdc_mismatch is one vote round that disagreed
    # (suspects = localized device ids, action = reexecute|quarantine);
    # sdc_quarantine is the strike-ladder escalation that feeds the
    # degraded-mesh migration path, naming the lying device ids.
    "sdc_check": (
        ("mode",),
        ("iter", "fold", "sumsq", "where"),
    ),
    "sdc_mismatch": (
        ("iter", "action"),
        ("suspects", "folds", "strikes"),
    ),
    "sdc_quarantine": (
        ("iter", "device_ids"),
        ("strikes", "reason"),
    ),
    # online autotuner (runtime/autotune.py). action="plan" is one
    # measured-cost re-search decision: reason is
    # "swap" | "hysteresis" | "amortization" | "identical" | "infeasible",
    # swapped is 0/1 (observe mode never swaps — a reason of "swap" with
    # swapped=0 is the logged counterfactual); the before/after strategy
    # JSON rides along like the elastic migrate event's. action="realized"
    # follows a swap once the new strategy re-settles, closing the
    # predicted-vs-realized loop.
    "autotune": (
        ("action",),
        ("iter", "mode", "reason", "steady_step_ms", "incumbent_ms",
         "winner_ms", "predicted_saving_ms", "margin", "remaining_steps",
         "swap_cost_ms", "swapped", "from_strategy", "to_strategy",
         "step_ms_before", "step_ms_after", "realized_saving_ms"),
    ),
    # jax.profiler start/stop_trace bracketing (--xla_trace)
    "trace": (("action",), ("dir", "first_step", "last_step", "error")),
    "log": (("message",), ()),
    "run_end": ((), ("summary",)),
}


class TelemetryError(RuntimeError):
    """Schema violation or a failed/closed sink."""


def validate_event(event: Dict[str, Any]) -> None:
    """Raise TelemetryError unless `event` is a schema-valid envelope+payload
    dict (shared by emit and by the offline reader)."""
    if not isinstance(event, dict):
        raise TelemetryError("event must be a dict, got %r" % type(event))
    etype = event.get("type")
    if etype not in EVENT_SCHEMAS:
        raise TelemetryError(
            "unknown telemetry event type %r (knowns: %s)"
            % (etype, ", ".join(sorted(EVENT_SCHEMAS)))
        )
    if event.get("v") != SCHEMA_VERSION:
        raise TelemetryError(
            "telemetry schema version %r != supported %d" % (event.get("v"), SCHEMA_VERSION)
        )
    required, optional = EVENT_SCHEMAS[etype]
    allowed = set(ENVELOPE_KEYS) | set(required) | set(optional)
    unknown = sorted(set(event) - allowed)
    if unknown:
        raise TelemetryError(
            "event %r carries unknown key(s) %s (allowed: %s)"
            % (etype, unknown, sorted(allowed))
        )
    missing = sorted(k for k in required if k not in event)
    if missing:
        raise TelemetryError("event %r missing required key(s) %s" % (etype, missing))


# ------------------------------------------------------------------- sinks
class TelemetrySink:
    """Validate-and-record base: subclasses implement `_write(event_dict)`.

    Thread-safe: emit may be called from the train loop, the prefetch
    worker's retry path, or a signal-adjacent drain; the envelope sequence
    number is the total order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False

    def emit(self, etype: str, **fields) -> Dict[str, Any]:
        if self._closed:
            raise TelemetryError("emit() on a closed %s" % type(self).__name__)
        event: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "t": time.time(),
            "type": etype,
        }
        event.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            event["seq"] = self._seq
            self._seq += 1
            validate_event(event)
            self._write(event)
        return event

    # -- subclass surface --------------------------------------------------
    def _write(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False


class MemorySink(TelemetrySink):
    """In-memory backend (tests, in-process analysis)."""

    def __init__(self):
        super().__init__()
        self.events: List[Dict[str, Any]] = []

    def _write(self, event):
        self.events.append(event)


class NullSink(TelemetrySink):
    """Validates and drops (schema checking without storage)."""

    def _write(self, event):
        pass


def _json_default(obj):
    """Serialize numpy scalars/arrays (``.item()``/``.tolist()``) and other
    strays without making the emit sites care about dtypes."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                break
    if isinstance(obj, (set, frozenset, tuple)):
        return list(obj)
    return str(obj)


_FLUSH, _STOP = "flush", "stop"


class JsonlSink(TelemetrySink):
    """JSONL file backend with an off-critical-path writer thread.

    ``emit`` enqueues; the daemon worker serializes and writes. The queue is
    bounded (`depth`) so a stalled filesystem back-pressures the producer
    instead of ballooning host memory — the same containment contract as
    PrefetchIterator. `flush()` blocks until everything emitted so far is on
    disk (fsync not forced); `close()` flushes and joins. A writer exception
    is stored and re-raised on the next emit/flush/close."""

    def __init__(self, path: str, depth: int = 1024):
        super().__init__()
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # open in the producer so a bad path fails at construction, not
        # asynchronously on the first write
        self._fh = open(path, "w", encoding="utf-8")
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, name="galvatron-telemetry", daemon=True
        )
        self._thread.start()

    # -- worker ------------------------------------------------------------
    def _worker(self):
        while True:
            tag, payload = self._queue.get()
            try:
                if tag == _STOP:
                    self._fh.flush()
                    return
                if tag == _FLUSH:
                    self._fh.flush()
                    payload.set()
                    continue
                self._fh.write(json.dumps(payload, default=_json_default) + "\n")
            except BaseException as e:  # noqa: BLE001 — relayed to producer
                self._error = e
                if tag == _FLUSH:
                    payload.set()
                if tag == _STOP:
                    return
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise TelemetryError(
                "telemetry writer failed for %s: %s" % (self.path, err)
            ) from err

    # -- producer ----------------------------------------------------------
    def _write(self, event):
        self._raise_pending()
        self._queue.put(("event", event))

    def flush(self, timeout: float = 10.0) -> None:
        self._raise_pending()
        if not self._thread.is_alive():
            return
        done = threading.Event()
        self._queue.put((_FLUSH, done))
        done.wait(timeout=timeout)
        self._raise_pending()

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread.is_alive():
            self._queue.put((_STOP, None))
            self._thread.join(timeout=timeout)
        try:
            self._fh.close()
        except OSError as e:
            if self._error is None:
                self._error = e
        self._raise_pending()


# ----------------------------------------------------- process-wide routing
# The innermost installed sink receives module-level emit()s. A stack (not a
# single slot) so nested drivers (search trials calling train()) compose.
_ACTIVE: List[TelemetrySink] = []
_ACTIVE_LOCK = threading.Lock()


def install(sink: TelemetrySink) -> TelemetrySink:
    with _ACTIVE_LOCK:
        _ACTIVE.append(sink)
    return sink


def uninstall(sink: TelemetrySink) -> None:
    with _ACTIVE_LOCK:
        if sink in _ACTIVE:
            _ACTIVE.remove(sink)


def active_sink() -> Optional[TelemetrySink]:
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


def emit(etype: str, **fields) -> Optional[Dict[str, Any]]:
    """Emit to the active sink; no-op (returns None) when none is installed.
    Schema violations always propagate — they are bugs at the emit site, not
    runtime conditions."""
    sink = active_sink()
    if sink is None:
        return None
    return sink.emit(etype, **fields)


def runtime_log(message: str, print_fn=print) -> None:
    """Library-code logging: print through the injectable `print_fn` and
    mirror the line into the telemetry stream (the GLC006-sanctioned path
    for runtime/ and obs/ modules)."""
    print_fn(message)
    emit("log", message=message)


# ------------------------------------------------------------------ reading
def read_events(
    path_or_lines, strict: bool = True
) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Load and validate a telemetry JSONL. Returns (events, errors); with
    `strict`, the first malformed line raises TelemetryError instead. Events
    come back in file order (which equals emit order: single writer)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines, "r", encoding="utf-8") as fh:
            lines: Iterable[str] = fh.readlines()
    else:
        lines = path_or_lines
    events: List[Dict[str, Any]] = []
    errors: List[str] = []
    for n, line in enumerate(lines, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
            validate_event(event)
        except (ValueError, TelemetryError) as e:
            msg = "line %d: %s" % (n, e)
            if strict:
                raise TelemetryError(msg) from e
            errors.append(msg)
            continue
        events.append(event)
    return events, errors
