"""Prefill/decode inference engine with continuous batching.

Port of ``galvatron_tpu/serve/engine.py`` for one device.

Execution model
---------------
- **Prefill** (one request, compute-bound): the prompt, padded to its page
  bucket, runs through `models/base.run_layers` with `collect_kv=True`, which
  returns each layer's post-rope (k, v); the block is written into the
  request's cache slot and the first token is sampled from the last valid
  position. Prefill attention is the flash kernel: every bucket is a
  multiple of ``page_size``, and the key padding becomes segment ids.
- **Decode** (all slots, bandwidth-bound): one step embeds the last sampled
  token per slot at position `lengths`, runs `models/base.
  decode_layer_forward` per layer against the cached K/V (causality and
  slot-length masking folded into one additive `kv_cache.length_bias`),
  appends the new k/v in place, and samples.
- **Buckets**: context lengths are quantised to `page_size` pages; the
  engine keeps one step function per (kind, page count). PyTorch runs
  eagerly, so there is no compiled-executable memo as in the reference; the
  buckets still fix the prefill shapes at multiples of `page_size`.
- **Continuous batching**: slot-based admission in strict arrival (FIFO)
  order; a slot frees the moment its request hits `max_new_tokens`, and the
  next pending request is admitted at the following scheduler tick.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.obs import telemetry as T
from galvatron_tpu_torch.serve.kv_cache import (
    KVCacheConfig,
    bucket_pages,
    init_kv_cache,
    length_bias,
    request_fits,
    write_prompt_kv,
)


# ------------------------------------------------------------------- sampling
def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature sampling over (..., V). The
    sampled ids come from `generator` and cannot match ``jax.random``'s;
    parity with the reference holds for greedy decoding."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)


# ------------------------------------------------------------ step factories
def make_prefill_step(
    cfg: M.TransformerConfig,
    kv_cfg: KVCacheConfig,
    pages: int,
    temperature: float = 0.0,
) -> Callable:
    """Build the prefill function for one `pages` bucket:
    (params, cache, tokens (1, ctx_b), prompt_len, slot, generator)
      -> (first_token (1,), last_logits (1, V)), writing the cache in place.
    Padding past prompt_len is masked in attention and in the sampled
    position; its garbage K/V lands in the cache but stays behind the
    length mask until decode overwrites it."""
    ctx_b = pages * kv_cfg.page_size

    def prefill_bucket(params, cache, tokens, prompt_len: int, slot: int, generator):
        device = tokens.device
        positions = torch.arange(ctx_b, device=device).expand(1, ctx_b)
        valid = (torch.arange(ctx_b, device=device) < prompt_len)[None, :]
        bias = M.padding_attn_bias(valid)
        x = M.embed_tokens(params.embed, tokens, positions, cfg)
        x, kvs = M.run_layers(params, x, positions, cfg, attn_bias=bias, collect_kv=True)
        h_last = x[:, prompt_len - 1:prompt_len]
        logits = M.lm_logits(params, h_last, cfg)[:, 0]
        token = sample_token(logits, generator, temperature)
        write_prompt_kv(cache, kvs, slot, prompt_len)
        return token, logits

    return prefill_bucket


def make_decode_step(
    cfg: M.TransformerConfig,
    kv_cfg: KVCacheConfig,
    pages: int,
    temperature: float = 0.0,
) -> Callable:
    """Build the single-token decode function for one `pages` bucket:
    (params, cache, tokens (slots,), active (slots,) bool, generator)
      -> (next_tokens (slots,), logits (slots, V)), updating the cache in
    place. All slots step together; inactive slots compute (and write
    masked garbage k/v at their frozen length) but neither advance `lengths`
    nor change their token — their columns are overwritten at re-admission."""
    ctx_b = pages * kv_cfg.page_size

    def decode(params, cache, tokens, active, generator):
        lengths = cache["lengths"]
        positions = lengths[:, None]
        x = M.embed_tokens(params.embed, tokens[:, None], positions, cfg)
        bias = length_bias(lengths, ctx_b)
        for li, lp in enumerate(params.layers):
            x, _, _ = M.decode_layer_forward(
                lp, x, positions, cfg,
                k_cache=cache["k"][li][:, :ctx_b], v_cache=cache["v"][li][:, :ctx_b],
                write_index=lengths, attn_bias=bias,
            )
        logits = M.lm_logits(params, x, cfg)[:, 0]
        next_tok = sample_token(logits, generator, temperature)
        next_tok = torch.where(active, next_tok, tokens)
        cache["lengths"] = lengths + active.to(torch.int32)
        return next_tok, logits

    return decode


# -------------------------------------------------------------------- engine
class ServeEngine:
    """Owns the cache and the per-bucket step functions; host-level
    prefill/decode API returning numpy. The scheduler (ContinuousBatcher)
    drives it. Runs under ``torch.inference_mode``."""

    def __init__(
        self,
        cfg: M.TransformerConfig,
        params: M.TransformerLM,
        kv_cfg: KVCacheConfig,
        device=None,
        temperature: float = 0.0,
        rng_seed: int = 0,
    ):
        if cfg.head_type != "lm":
            raise ValueError("serving requires a causal LM head, got head_type=%r" % cfg.head_type)
        self.cfg, self.params, self.kv_cfg = cfg, params, kv_cfg
        self.device = torch.device(device) if device is not None else params.embed.wte.device
        self.temperature = temperature
        self.cache = init_kv_cache(cfg, kv_cfg, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(rng_seed))
        self._prefill_fns: Dict[int, Callable] = {}
        self._decode_fns: Dict[int, Callable] = {}

    def _prefill_fn(self, pages: int) -> Callable:
        if pages not in self._prefill_fns:
            self._prefill_fns[pages] = make_prefill_step(
                self.cfg, self.kv_cfg, pages, self.temperature)
        return self._prefill_fns[pages]

    def _decode_fn(self, pages: int) -> Callable:
        if pages not in self._decode_fns:
            self._decode_fns[pages] = make_decode_step(
                self.cfg, self.kv_cfg, pages, self.temperature)
        return self._decode_fns[pages]

    @torch.inference_mode()
    def prefill(self, prompt: Sequence[int], slot: int) -> Tuple[int, np.ndarray]:
        """Run one prompt into cache row `slot`; returns (first_token, logits)."""
        plen = len(prompt)
        pages = bucket_pages(plen, self.kv_cfg.page_size, self.kv_cfg.max_pages)
        ctx_b = pages * self.kv_cfg.page_size
        tokens = np.zeros((1, ctx_b), np.int64)
        tokens[0, :plen] = np.asarray(prompt, np.int64)
        tok, logits = self._prefill_fn(pages)(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device),
            plen, int(slot), self._gen,
        )
        return int(tok[0].item()), logits[0].float().cpu().numpy()

    @torch.inference_mode()
    def decode_step(
        self, tokens: np.ndarray, active: np.ndarray, pages: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One decode tick over every slot; returns (next_tokens, logits)."""
        next_tok, logits = self._decode_fn(pages)(
            self.params, self.cache,
            torch.as_tensor(np.asarray(tokens, np.int32), device=self.device),
            torch.as_tensor(np.asarray(active, bool), device=self.device),
            self._gen,
        )
        return next_tok.cpu().numpy(), logits.float().cpu().numpy()


# ------------------------------------------------------------------- requests
@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None  # absolute TTFT deadline (batcher clock)
    # runtime bookkeeping (filled by the batcher)
    slot: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    # terminal disposition: "pending" while live, then exactly one of
    # "completed" | "shed" (retryable, never started or abandoned mid-decode)
    # | "failed" (non-retryable, e.g. oversize for the cache geometry).
    status: str = "pending"
    finish_reason: Optional[str] = None
    retryable: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def ttft_ms(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return (self.first_token_t - self.arrival_s) * 1000.0

    def tpot_ms(self) -> Optional[float]:
        if self.done_t is None or self.first_token_t is None or len(self.output) < 2:
            return None
        return (self.done_t - self.first_token_t) * 1000.0 / (len(self.output) - 1)


def synthetic_requests(
    n: int,
    *,
    vocab_size: int,
    seed: int = 0,
    rate_rps: float = 0.0,
    prompt_len_range: Tuple[int, int] = (4, 16),
    max_new_tokens: int = 8,
) -> List[Request]:
    """Poisson arrivals (`rate_rps` > 0; 0 = a t=0 backlog) with uniform
    prompt lengths — the synthetic open-loop load for cli/serve and bench."""
    rnd = random.Random(seed)
    t = 0.0
    out = []
    for rid in range(n):
        if rate_rps > 0:
            t += rnd.expovariate(rate_rps)
        plen = rnd.randint(*prompt_len_range)
        prompt = [rnd.randrange(vocab_size) for _ in range(plen)]
        out.append(Request(rid=rid, arrival_s=t, prompt=prompt, max_new_tokens=max_new_tokens))
    return out


def replay_requests(path: str, *, vocab_size: int, seed: int = 0) -> List[Request]:
    """Replay a trace: JSONL of {"arrival_s", "prompt_len", "max_new_tokens"}
    (prompt token ids synthesised deterministically from `seed`)."""
    import json

    rnd = random.Random(seed)
    out = []
    with open(path) as f:
        for rid, line in enumerate(ln for ln in f if ln.strip()):
            rec = json.loads(line)
            plen = int(rec["prompt_len"])
            out.append(Request(
                rid=rid,
                arrival_s=float(rec.get("arrival_s", 0.0)),
                prompt=[rnd.randrange(vocab_size) for _ in range(plen)],
                max_new_tokens=int(rec.get("max_new_tokens", 8)),
            ))
    return out


# ----------------------------------------------------------------- scheduler
class ContinuousBatcher:
    """Slot-based continuous batching over a ServeEngine (or any object with
    the same prefill/decode_step surface — scheduler tests use a fake).

    Invariants (the reference's tests/serve/test_scheduler.py):
    - admission is strict FIFO in arrival order — a later request never
      occupies a slot while an earlier arrived one waits;
    - no slot leak: every admitted request frees its slot at completion, and
      a slot is never doubly occupied — including under exceptions in
      prefill or decode;
    - bucket routing: each decode tick runs in the smallest page bucket
      covering every active slot's next write position;
    - no request ever raises out of the batcher: oversize prompts, blown
      deadlines, and predicted-TTFT overload are structured rejections
      (`Request.status`/`finish_reason`/`retryable`) collected in
      ``self.shed``, not exceptions.

    Admission control: ``p99_ttft_ms`` arms a cheap predicted-TTFT model —
    time already waited plus queue position times the learned median prefill
    and decode-tick costs — that sheds (retryable) any pending request which
    cannot meet the bound. ``max_pending`` bounds the arrived-but-unadmitted
    queue; overflow sheds from the tail (newest arrivals). Both engage only
    after ``min_shed_samples`` prefills AND ticks have been observed, so
    compile warmup never sheds.

    Control: an optional ``control`` callback is polled once per scheduler
    iteration and may return a drain-reason string to stop admission and
    wind down. (The reference's watchdog hook and live ``migrate_to`` come
    with the robustness slice.)
    """

    def __init__(
        self,
        engine,
        kv_cfg: KVCacheConfig,
        clock: Optional[Callable[[], float]] = None,
        p99_ttft_ms: float = 0.0,
        max_pending: int = 0,
        request_timeout_s: float = 0.0,
        min_shed_samples: int = 3,
        control: Optional[Callable[["ContinuousBatcher"], Optional[str]]] = None,
    ):
        self.engine = engine
        self.kv_cfg = kv_cfg
        self._clock = clock if clock is not None else time.monotonic
        self._t0: Optional[float] = None
        self.p99_ttft_ms = float(p99_ttft_ms)
        self.max_pending = int(max_pending)
        self.request_timeout_s = float(request_timeout_s)
        self.min_shed_samples = int(min_shed_samples)
        self.control = control
        # host-side per-slot state (device lengths are never read back)
        self.slot_req: List[Optional[Request]] = [None] * kv_cfg.max_slots
        self.slot_len = np.zeros((kv_cfg.max_slots,), np.int64)
        self.slot_tok = np.zeros((kv_cfg.max_slots,), np.int32)
        self.decode_steps = 0
        self.completed: List[Request] = []
        self.shed: List[Request] = []
        self.drain_reason: Optional[str] = None
        # learned cost medians feeding the predicted-TTFT shed model
        self._prefill_ms: deque = deque(maxlen=64)
        self._tick_ms: deque = deque(maxlen=64)

    def now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def occupancy(self) -> int:
        return sum(1 for r in self.slot_req if r is not None)

    # ------------------------------------------------- rejection + shedding
    def _reject(self, req: Request, reason: str, retryable: bool,
                **extra) -> None:
        """Terminal structured rejection: mark the request, collect it, and
        emit a `serve_shed` event. Never touches slot state — callers free
        any slot the request held BEFORE rejecting."""
        req.status = "shed" if retryable else "failed"
        req.finish_reason = reason
        req.retryable = retryable
        req.done_t = self.now()
        req.slot = None
        self.shed.append(req)
        T.emit(
            "serve_shed", id=req.rid, reason=reason,
            retryable=int(retryable), prompt_len=req.prompt_len,
            output_len=len(req.output) or None,
            waited_ms=max(0.0, (self.now() - req.arrival_s) * 1000.0),
            **extra,
        )

    @staticmethod
    def _median(xs) -> float:
        if not xs:
            return 0.0
        s = sorted(xs)
        return float(s[len(s) // 2])

    def predicted_ttft_ms(self, req: Request, queue_pos: int) -> float:
        """Cheap TTFT forecast: time already waited + one prefill for this
        request + (queue depth ahead) × (median prefill + median tick) —
        every request ahead costs its own prefill and roughly one decode
        tick before a slot frees."""
        waited = max(0.0, (self.now() - req.arrival_s) * 1000.0)
        mp = self._median(self._prefill_ms)
        mt = self._median(self._tick_ms)
        return waited + mp + queue_pos * (mp + mt)

    def _shed_scan(self, pending: deque) -> None:
        """Drop pending requests that cannot be served: blown per-request
        deadlines, predicted-TTFT overload, and pending-queue overflow.
        Rebuilds the deque preserving FIFO order of the survivors."""
        if not pending:
            return
        now = self.now()
        learned = (len(self._prefill_ms) >= self.min_shed_samples
                   and len(self._tick_ms) >= self.min_shed_samples)
        keep: List[Request] = []
        arrived_kept = 0
        for req in pending:
            if req.arrival_s > now:
                keep.append(req)
                continue
            deadline = req.deadline_s
            if deadline is None and self.request_timeout_s > 0:
                deadline = req.arrival_s + self.request_timeout_s
            if deadline is not None and now > deadline:
                self._reject(req, "deadline", retryable=True)
                continue
            if self.p99_ttft_ms > 0 and learned:
                pred = self.predicted_ttft_ms(req, arrived_kept)
                if pred > self.p99_ttft_ms:
                    self._reject(req, "predicted_ttft", retryable=True,
                                 predicted_ttft_ms=pred,
                                 queue_depth=arrived_kept)
                    continue
            if self.max_pending > 0 and arrived_kept >= self.max_pending:
                self._reject(req, "queue_full", retryable=True,
                             queue_depth=arrived_kept)
                continue
            arrived_kept += 1
            keep.append(req)
        if len(keep) != len(pending):
            pending.clear()
            pending.extend(keep)

    def _admit(self, pending: deque) -> None:
        while pending:
            req = pending[0]
            if req.arrival_s > self.now():
                break
            slot = self._free_slot()
            if slot is None:
                break
            pending.popleft()
            if not request_fits(self.kv_cfg, req.prompt_len, req.max_new_tokens):
                # structured per-request refusal: the slot was never
                # occupied, the loop continues with the next arrival
                self._reject(req, "oversize", retryable=False)
                continue
            req.slot = slot
            req.prefill_start_t = self.now()
            try:
                tok, _ = self.engine.prefill(req.prompt, slot)
            except Exception as e:
                # slot never assigned (slot_req[slot] still None): contain
                # the failure to this request and keep serving
                self._reject(req, "prefill_error", retryable=True,
                             error=repr(e)[:200])
                continue
            prefill_ms = (self.now() - req.prefill_start_t) * 1000.0
            self._prefill_ms.append(prefill_ms)
            req.first_token_t = self.now()
            req.output.append(tok)
            self.slot_req[slot] = req
            self.slot_len[slot] = req.prompt_len
            self.slot_tok[slot] = tok
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None and len(req.output) >= req.max_new_tokens:
            req.done_t = self.now()
            req.status = "completed"
            req.finish_reason = "completed"
            self.completed.append(req)
            self.slot_req[slot] = None
            T.emit(
                "serve_request", id=req.rid, arrival_t=req.arrival_s,
                prefill_start_t=req.prefill_start_t,
                first_token_t=req.first_token_t, done_t=req.done_t,
                prompt_len=req.prompt_len, output_len=len(req.output),
                ttft_ms=req.ttft_ms(), tpot_ms=req.tpot_ms(),
            )

    def decode_pages(self) -> int:
        """Smallest bucket whose context covers every active slot's write
        position (= its current length)."""
        active_lens = [int(self.slot_len[i]) for i, r in enumerate(self.slot_req) if r is not None]
        return bucket_pages(max(active_lens), self.kv_cfg.page_size, self.kv_cfg.max_pages)

    def _abandon_active(self, reason: str) -> int:
        """Free every occupied slot, rejecting its request as retryable —
        the containment path for engine-wide decode failures and hard
        drains. Returns how many were abandoned."""
        n = 0
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_req[slot] = None
            self.slot_len[slot] = 0
            self.slot_tok[slot] = 0
            self._reject(req, reason, retryable=True)
            n += 1
        return n

    def _decode_tick(self) -> None:
        active = np.array([r is not None for r in self.slot_req], bool)
        pages = self.decode_pages()
        t_start = self.now()
        try:
            next_tok, _ = self.engine.decode_step(self.slot_tok, active, pages)
        except Exception:
            # an engine-wide failure, not a per-request one: free every
            # slot (no leak), park the requests as retryable, and let the
            # driver decide on the re-raised error
            self._abandon_active("decode_error")
            raise
        step_ms = (self.now() - t_start) * 1000.0
        self._tick_ms.append(step_ms)
        self.decode_steps += 1
        n_active = int(active.sum())
        tokens = 0
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(next_tok[slot])
            req.output.append(tok)
            self.slot_tok[slot] = tok
            self.slot_len[slot] += 1
            tokens += 1
            self._maybe_finish(slot)
        T.emit(
            "decode_batch", step=self.decode_steps,
            occupancy=n_active / self.kv_cfg.max_slots,
            slots=self.kv_cfg.max_slots, step_ms=step_ms, bucket_pages=pages,
            tokens=tokens,
        )

    # --------------------------------------------------------------- drain
    def drain(self, reason: str, pending: Optional[deque] = None,
              finish_active: bool = True) -> Dict[str, int]:
        """Graceful wind-down: stop admitting (every pending request sheds
        retryable), complete in-flight decodes where possible (bounded by
        the tokens they still owe), mark anything left retryable, and emit
        one `serve_drain` event. Idempotent per run()."""
        pending_shed = 0
        if pending:
            while pending:
                self._reject(pending.popleft(), "drain", retryable=True)
                pending_shed += 1
        active_before = self.occupancy()
        completed_before = len(self.completed)
        if finish_active and active_before:
            budget = sum(
                r.max_new_tokens - len(r.output)
                for r in self.slot_req if r is not None
            ) + active_before
            try:
                while self.occupancy() and budget > 0:
                    self._decode_tick()
                    budget -= 1
            except Exception:
                pass  # _decode_tick already freed slots + parked retryable
        active_shed = self._abandon_active("drain")
        self.drain_reason = reason
        T.emit(
            "serve_drain", reason=reason,
            completed=len(self.completed),
            active_completed=len(self.completed) - completed_before,
            active_shed=active_shed, pending_shed=pending_shed,
            shed=len(self.shed),
        )
        return {
            "reason": reason, "pending_shed": pending_shed,
            "active_shed": active_shed,
            "active_completed": len(self.completed) - completed_before,
        }

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Drive the load to completion; returns the completed requests in
        completion order. Shed/failed requests land in ``self.shed``."""
        pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self.now()  # start the clock
        while pending or any(r is not None for r in self.slot_req):
            if self.control is not None:
                verdict = self.control(self)
                if verdict:
                    self.drain(str(verdict), pending)
                    break
            self._shed_scan(pending)
            self._admit(pending)
            if any(r is not None for r in self.slot_req):
                self._decode_tick()
            elif pending:
                # idle: wait out the arrival gap (real clock) / spin (fake)
                gap = pending[0].arrival_s - self.now()
                if gap > 0 and self._clock is time.monotonic:
                    time.sleep(min(gap, 0.05))
        return self.completed


# -------------------------------------------------------------------- report
def percentile(values: Sequence[float], q: float) -> float:
    if not values:
        return float("nan")
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


def summarize(
    completed: Sequence[Request], wall_s: float, world_size: int = 1,
    shed: Sequence[Request] = (),
) -> Dict[str, Any]:
    """TTFT/TPOT percentiles + throughput for a finished load, plus the shed
    ledger (count, retryable count, per-reason breakdown) when given."""
    ttfts = [r.ttft_ms() for r in completed if r.ttft_ms() is not None]
    tpots = [r.tpot_ms() for r in completed if r.tpot_ms() is not None]
    out_tokens = sum(len(r.output) for r in completed)
    by_reason: Dict[str, int] = {}
    for r in shed:
        by_reason[r.finish_reason or "unknown"] = by_reason.get(r.finish_reason or "unknown", 0) + 1
    return {
        "shed": len(shed),
        "shed_retryable": sum(1 for r in shed if r.retryable),
        "shed_by_reason": by_reason,
        "requests": len(completed),
        "output_tokens": out_tokens,
        "wall_s": wall_s,
        "tokens_per_s": out_tokens / wall_s if wall_s > 0 else float("nan"),
        "tokens_per_s_per_chip": (
            out_tokens / wall_s / world_size if wall_s > 0 else float("nan")
        ),
        "ttft_ms": {
            "p50": percentile(ttfts, 50), "p90": percentile(ttfts, 90),
            "p99": percentile(ttfts, 99),
        },
        "tpot_ms": {
            "p50": percentile(tpots, 50), "p90": percentile(tpots, 90),
            "p99": percentile(tpots, 99),
        },
    }
