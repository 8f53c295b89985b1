"""Fault tolerance for long-running training: the training half of
``galvatron_tpu/runtime/resilience.py``.

- :class:`PreemptionHandler` — SIGTERM/SIGINT become a flag the train loop
  polls at step boundaries, so an emergency checkpoint is written from a
  consistent params/Adam state and the process exits cleanly.
- :class:`AnomalyGuard` — host-side accounting for the step's anomaly gate
  (``make_train_step(guard_anomalies=True)`` leaves params and Adam state
  untouched when the loss or gradient norm is non-finite or the loss passes
  the spike cap): the EMA of accepted losses that arms the cap, consecutive
  strikes, and when to roll back to the last checkpoint.
- :func:`with_retry` — exponential backoff with full jitter around
  checkpoint I/O and the dataloader for transient ``OSError``s.
- :class:`ResilienceCounters` — the counts merged into the train summary
  (the reference's keys, the silent-corruption sentinel's included).
- :class:`FaultHooks` — the deterministic fault-injection seam tests use.

The watchdog and the mesh probe are ``runtime/health.py``, the
silent-corruption sentinel ``runtime/sdc.py``. Checkpoint integrity (the
atomic manifest) lives in ``runtime/checkpoint.py``; this module decides
when to save, retry and roll back.
"""

from __future__ import annotations

import dataclasses
import random
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class TrainingAnomalyError(RuntimeError):
    """Raised when anomalies persist beyond what rollback can repair
    (no checkpoint to roll back to, or the rollback budget is exhausted)."""


# ------------------------------------------------------------------ counters
@dataclass
class ResilienceCounters:
    """Resilience event counts, merged into the profiler summary dict."""

    anomalies_skipped: int = 0
    rollbacks: int = 0
    retries: int = 0
    retries_succeeded: int = 0  # operations that failed, backed off, then made it
    retries_exhausted: int = 0  # operations that gave up (budget or elapsed cap)
    emergency_saves: int = 0
    torn_checkpoints_skipped: int = 0
    # silent-corruption sentinel (runtime/sdc.py)
    sdc_checks: int = 0  # digest observations emitted to telemetry
    sdc_mismatches: int = 0  # drain-time replica-vote disagreements
    sdc_reexecutions: int = 0  # repair-from-replica + re-execute recoveries
    sdc_quarantines: int = 0  # devices convicted by the strike ladder

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------- retry
@dataclass
class RetryPolicy:
    """Exponential backoff for transient I/O failures (filesystem flakes,
    network storage timeouts). `retries` is the number of RE-attempts after the
    first failure; delays are base * multiplier**attempt, capped per-sleep
    by `max_delay_s` and in TOTAL by `max_elapsed_s`.

    `jitter` applies full jitter (delay drawn uniformly from [0, backoff])
    — with many workers retrying the same flaky filesystem, synchronized
    exponential backoff re-creates the thundering herd every 2^k seconds;
    full jitter decorrelates them. `max_elapsed_s` bounds the whole retry
    episode (sleeps + attempts measured on `clock`) so a restore-side retry
    chain cannot outlive a preemption grace window: when the budget is
    spent, the last error propagates immediately instead of sleeping into
    the SIGKILL."""

    retries: int = 2
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 8.0
    max_elapsed_s: Optional[float] = None
    jitter: bool = True
    retryable: Tuple[type, ...] = (OSError,)


def with_retry(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    counters: Optional[ResilienceCounters] = None,
    description: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    log_fn: Callable[[str], None] = print,
    rng: Callable[[], float] = random.random,
    clock: Callable[[], float] = time.monotonic,
):
    """Run `fn()`; on a retryable exception, back off (full jitter unless
    the policy disables it) and retry up to `policy.retries` times within
    `policy.max_elapsed_s` total. Non-retryable exceptions propagate
    immediately; the last retryable one propagates after the budget. Each
    backoff is logged through `log_fn` and recorded as a ``retry`` telemetry
    event when a sink is active; `counters` distinguishes episodes that
    eventually succeeded (`retries_succeeded`) from those that gave up
    (`retries_exhausted`)."""
    from galvatron_tpu_torch.obs import telemetry

    policy = policy or RetryPolicy()
    attempt = 0
    t_start = clock()
    while True:
        try:
            out = fn()
            if attempt > 0 and counters is not None:
                counters.retries_succeeded += 1
            return out
        except policy.retryable as e:
            if attempt >= policy.retries:
                if counters is not None:
                    counters.retries_exhausted += 1
                raise
            delay = min(policy.base_delay_s * policy.multiplier**attempt, policy.max_delay_s)
            if policy.jitter and delay > 0:
                delay = rng() * delay
            if policy.max_elapsed_s is not None and (
                clock() - t_start + delay > policy.max_elapsed_s
            ):
                # sleeping would overrun the grace window — give up NOW with
                # the real error, leaving the caller time to act on it
                if counters is not None:
                    counters.retries_exhausted += 1
                log_fn(
                    "resilience: %s failed (%s: %s); retry budget elapsed "
                    "(%.2fs of %.2fs) — giving up"
                    % (description, type(e).__name__, e, clock() - t_start,
                       policy.max_elapsed_s)
                )
                raise
            if counters is not None:
                counters.retries += 1
            log_fn(
                "resilience: %s failed (%s: %s); retry %d/%d in %.2fs"
                % (description, type(e).__name__, e, attempt + 1, policy.retries, delay)
            )
            telemetry.emit(
                "retry", description=description, attempt=attempt + 1,
                error="%s: %s" % (type(e).__name__, e), delay_s=delay,
            )
            sleep(delay)
            attempt += 1


# ---------------------------------------------------------------- preemption
class PreemptionHandler:
    """SIGTERM/SIGINT -> a flag polled at step boundaries.

    A scheduler's preemption delivers SIGTERM with a grace window; a first Ctrl-C asks
    for a graceful stop the same way. The handler only records the signal —
    the train loop finishes the in-flight step, writes an emergency
    checkpoint, and returns normally (clean exit code). A second SIGINT
    raises KeyboardInterrupt so a stuck save can still be aborted."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._signum: Optional[int] = None
        self._prev: Dict[int, object] = {}
        self._installed = False

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self  # signal handlers only work on the main thread
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def _handle(self, signum, frame):
        if self._signum is not None and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._signum = signum

    @property
    def triggered(self) -> bool:
        return self._signum is not None

    @property
    def signal_name(self) -> Optional[str]:
        return signal.Signals(self._signum).name if self._signum is not None else None


# ------------------------------------------------------------- anomaly guard
@dataclass
class AnomalyGuardConfig:
    spike_factor: float = 0.0  # anomaly when loss > spike_factor * EMA; 0 = off
    ema_beta: float = 0.9
    min_history: int = 5  # accepted losses before the spike cap arms
    max_strikes: int = 3  # consecutive anomalies before rollback
    max_rollbacks: int = 3  # rollbacks before giving up (TrainingAnomalyError)


class AnomalyGuard:
    """Host-side half of the anomaly gate.

    The train step already refused to apply a non-finite / spiking update
    (make_train_step(guard_anomalies=True)); this object reads the step's
    loss, maintains the accepted-loss EMA that feeds the next step's spike
    cap, and counts consecutive strikes to decide when skipping is no longer
    enough and the loop must roll back to the last checkpoint."""

    def __init__(self, cfg: Optional[AnomalyGuardConfig] = None):
        self.cfg = cfg or AnomalyGuardConfig()
        self.ema: Optional[float] = None
        self.accepted = 0
        self.strikes = 0

    def spike_cap(self) -> float:
        """The loss ceiling the NEXT step's update must stay under; +inf
        until spike detection is configured and armed."""
        if self.cfg.spike_factor and self.accepted >= self.cfg.min_history and self.ema:
            return float(self.cfg.spike_factor * abs(self.ema))
        return float("inf")

    def observe(self, loss: float) -> str:
        """Classify one step's loss: "ok" | "nan" | "spike"."""
        if not np.isfinite(loss):
            self.strikes += 1
            return "nan"
        if loss > self.spike_cap():
            self.strikes += 1
            return "spike"
        self.strikes = 0
        self.accepted += 1
        self.ema = (
            loss
            if self.ema is None
            else self.cfg.ema_beta * self.ema + (1.0 - self.cfg.ema_beta) * loss
        )
        return "ok"

    @property
    def should_roll_back(self) -> bool:
        return self.strikes >= max(self.cfg.max_strikes, 1)

    def reset_after_rollback(self) -> None:
        """Restart accounting from the restored state: the EMA belongs to the
        discarded trajectory, and stale history must not arm a stale cap."""
        self.ema = None
        self.accepted = 0
        self.strikes = 0


# ----------------------------------------------------------- fault injection
@dataclass
class FaultHooks:
    """Deterministic fault-injection seam.

    The train loop consults `args.fault_hooks` (absent in production): the data
    iterator (global CPU batches, before placement) and the step function are
    wrapped once per (re)build — including after a rollback or a live
    migration — and `on_step(it)` fires at each step boundary before the
    batch is fetched (where a test sends its process SIGTERM or SIGUSR1).
    The step wrapper is where a test hangs a step or flips a bit of one
    rank's replica; the serve engine wraps its prefill and decode ticks
    with it (a stalled tick). `probe_devices_fn` replaces the mesh probe's
    list of live ranks."""

    wrap_data_iter: Optional[Callable[[Iterator, int], Iterator]] = None  # (iter, start_step)
    wrap_step_fn: Optional[Callable[[Callable], Callable]] = None
    on_step: Optional[Callable[[int], None]] = None
    # the mesh probe's live ranks (runtime/health.MeshHealthMonitor): a
    # simulated lost rank without killing one
    probe_devices_fn: Optional[Callable[[], list]] = None
