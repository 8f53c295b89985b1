"""Model profiler: per-layer time and memory by layer differencing.

Port of ``galvatron_tpu/profiler/model.py`` (``ModelProfiler``; the
reference's ModelProfiler, galvatron/core/profiler/model_profiler.py:
14-1051). The same layer-differencing method runs in process over the
port's own layers (``models/base.py``, attention on the hand-written flash
kernels on the card):

    per-layer quantity = (Q(layernum_max) - Q(layernum_min))
                         / (layernum_max - layernum_min) / batch_size

- time: the forward of an n-layer stack (and, for the remat fractions, its
  forward and backward), timed with CUDA events around each call on the
  card, as the original GPU Galvatron timed layers; with ``perf_counter``
  on the CPU. Mean over ``iters`` calls after ``warmup`` calls.
- memory: the forward and backward of an n-layer stack. On the card, the
  caching allocator's peak over that program (``max_memory_allocated``
  after ``reset_peak_memory_stats``) minus what was resident before it:
  the parameters, the input and the gradients, allocated before the
  program so that they count as resident wherever the peak falls (a peak
  early in the backward precedes most gradients). What is left is what the
  search's budget must hold for activations. On the CPU, which has no
  allocator peak, the bytes autograd saves for the backward
  (``torch.autograd.graph.saved_tensors_hooks``, each storage once,
  parameters excluded; under remat, the checkpointed layers' inputs). The
  card measures both and `act_records` keeps them side by side. A CPU run
  is what the caller asks for (``--device cpu``), never a fallback.

Per-tp activation rows are act/k, as the JAX package's one-process profile
writes them; its measured ``ulysses_k`` and ``cp_k`` rows need a k-rank
world to profile and are not ported yet (ROADMAP queue 1, the rest of item
8): the search prices those axes with the act/k rows.

`T5ModelProfiler` profiles T5's two layer types (layertype_0 the encoder
layer, layertype_1 the decoder layer, differenced against a fixed encoder
output so cross-attention lands in the decoder's cost); `SwinModelProfiler`
one layer type per stage, each at its stage's resolution and width, with
shifted blocks alternating as in the model. Both write the reference's file
names and keys; the other-layers tables come from the model at zero
layers (embedding, merges, norms, head).

The output files and their schema are the JAX package's:
  computation_profiling_<prec>_hidden<h>_head<nh>_seqlen<s>_<model>.json
      {"layertype_0": ms | [m, c], "other_time": ms,
       "remat_recompute_frac": {policy: fraction}}
  memory_profiling_<...>.json
      {"layertype_0": {"parameter_size": MB,
                       "tp_activation_per_bsz_dict": {tp: MB, "checkpoint": MB}},
       "other_memory_pp_off": {...}, "other_memory_pp_on": {...}}
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.runtime import distributed
from galvatron_tpu_torch.utils.jsonio import write_json_config

MB = 2.0**20


@dataclass
class ModelProfileArgs:
    """The JAX package's ModelProfileArgs (reference galvatron_profile_args,
    core/profiler/arguments.py:1-86), plus the port's ``device``, less
    ``profile_type``: one run writes both the computation and the memory
    table."""

    profile_mode: str = "static"  # static | batch | sequence
    profile_batch_size: int = 8
    profile_min_batch_size: int = 1
    profile_max_batch_size: int = 8
    batch_size_step: int = 1
    profile_seq_length: Optional[int] = None  # default: cfg.max_seq_len
    profile_min_seq_length: int = 512
    profile_max_seq_length: int = 2048
    seq_length_step: int = 512
    layernum_min: int = 1
    layernum_max: int = 3
    warmup: int = 2
    iters: int = 5
    max_tp_deg: int = 8
    mixed_precision: str = "bf16"
    config_dir: str = "configs"
    profile_remat: bool = False
    device: str = "cuda"  # cuda | cpu (no fallback from one to the other)


def _module_bytes(module: Optional[nn.Module]) -> int:
    if module is None:
        return 0
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _walltime(fn, args, warmup: int, iters: int, device: torch.device) -> float:
    """Mean seconds of one ``fn(*args)`` call: CUDA events around each call
    on the card (each call drained before the next), ``perf_counter`` on the
    CPU."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(np.mean(ts))


class SavedBytes:
    """Counts the bytes autograd saves for the backward while it is the
    active ``saved_tensors_hooks``: each storage once, the storages of
    `exclude` (the parameters: resident state, not activations) never.
    `add` counts a tensor kept alive by other means (a checkpointed
    layer's input)."""

    def __init__(self, exclude=()):
        self.exclude = {p.untyped_storage().data_ptr() for p in exclude}
        self.storages: Dict[int, int] = {}

    def add(self, t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        if st.data_ptr() and st.data_ptr() not in self.exclude:
            self.storages[st.data_ptr()] = st.nbytes()
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.add, lambda t: t)

    @property
    def total(self) -> int:
        return sum(self.storages.values())


class ModelProfiler:
    """Profiles a family of the generic transformer (llama, gpt, bert,
    vit): one layer type. Subclasses override `_stack_t`,
    `_layer_param_bytes`, `_full_model` and `_other_model_state_tables`."""

    layer_types = 1

    def __init__(self, cfg, model_name: str = "model",
                 args: Optional[ModelProfileArgs] = None):
        self._check_config(cfg)
        self.cfg = cfg
        self.model_name = model_name
        self.args = args or ModelProfileArgs()
        self._dev: Optional[torch.device] = None
        self._saving: Optional[SavedBytes] = None
        # one entry per activation measurement: both counts, MB per layer
        # per sample (allocator None on the CPU)
        self.act_records: List[Dict] = []

    @property
    def _device(self) -> torch.device:
        if self._dev is None:
            self._dev = distributed.local_device(self.args.device)
        return self._dev

    @property
    def _target_seq(self) -> int:
        return self.args.profile_seq_length or self.cfg.max_seq_len

    def _file_tag(self) -> str:
        c = self.cfg
        return "%s_hidden%d_head%d_seqlen%d" % (
            self.args.mixed_precision, c.hidden_size, c.num_heads, self._target_seq
        )

    def _check_config(self, cfg) -> None:
        if not isinstance(cfg, M.TransformerConfig):
            raise TypeError("ModelProfiler profiles the port's TransformerConfig families "
                            "(T5 and Swin have their own profilers)")

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self._device).manual_seed(0)

    # ------------------------------------------------------ stacks and models
    def _init_layers(self, layers: nn.Module, init_fn) -> nn.Module:
        gen = self._generator()
        with torch.no_grad():
            for name, p in layers.named_parameters():
                init_fn(name, p, gen)
        return layers

    def _stack(self, layers: nn.Module, x: torch.Tensor, body, policy: str):
        """(fwd, layers, (x,)): ``fwd(layers, x)`` runs ``body(j, layer, x)``
        through the layers in order, each under the remat `policy` ("none":
        plain), and sums the output."""
        def fwd(layers, x):
            for j, lp in enumerate(layers):
                def step(x_, _j=j, _lp=lp):
                    return body(_j, _lp, x_)

                if policy == "none" or not torch.is_grad_enabled():
                    x = step(x)
                else:
                    if self._saving is not None:
                        self._saving.add(x)  # what the checkpoint keeps
                    x = M._remat(step, policy)(x)
            return x.float().sum()

        return fwd, layers, (x,)

    def _stack_t(self, t: int, n: int, bsz: int, seq: int, policy: str = "none"):
        """An n-layer stack of layer type `t` (no embedding or head), its
        input, and its forward ``fwd(layers, x) -> scalar`` with every layer
        under the remat `policy` ("none": plain). Returns (fwd, layers,
        (x,))."""
        cfg = dataclasses.replace(self.cfg, num_layers=max(n, 1))
        dev = self._device
        layers = self._init_layers(nn.ModuleList(M.TransformerLayer(cfg, dev) for _ in range(n)),
                                   lambda name, p, gen: M.init_param_(name, p, cfg, gen))
        x = torch.randn((bsz, seq, cfg.hidden_size), generator=self._generator(),
                        device=dev).to(cfg.compute_dtype)
        positions = torch.arange(seq, device=dev).expand(bsz, seq)
        return self._stack(layers, x, lambda j, lp, x_: M.layer_forward(lp, x_, positions, cfg),
                           policy)

    def _layer_param_bytes(self, t: int) -> int:
        return _module_bytes(M.TransformerLayer(dataclasses.replace(self.cfg, num_layers=1),
                                                "meta"))

    def _full_model(self, n_layers: int, bsz: int, seq: int):
        """(loss_fn, params, batch) for the whole model at `n_layers` layers:
        the 'other' (embedding, head, loss) time and memory tables."""
        cfg = dataclasses.replace(
            self.cfg, num_layers=max(n_layers, 1), max_seq_len=max(seq, self.cfg.max_seq_len)
        )
        gen, dev = self._generator(), self._device
        params = M.init_model_params(cfg, gen, dev)
        params.layers = params.layers[:n_layers]
        if cfg.input_type == "patches":
            batch = {
                "pixels": torch.randn((bsz, cfg.image_size, cfg.image_size, cfg.num_channels),
                                      generator=gen, device=dev),
                "labels": torch.randint(0, max(cfg.num_classes, 1), (bsz,), generator=gen,
                                        device=dev),
            }
        else:
            tokens = torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen, device=dev)
            batch = {
                "tokens": tokens,
                "positions": torch.arange(seq, device=dev).expand(bsz, seq),
                "labels": torch.roll(tokens, -1, 1),
            }
        return (lambda p, b: M.loss_fn(p, b, cfg)), params, batch

    # ---------------------------------------------------------- measurements
    def _time(self, fn, args) -> float:
        return _walltime(fn, args, self.args.warmup, self.args.iters, self._device)

    def _grad_bytes(self, loss_fn, params: nn.Module, inputs) -> Dict[str, Optional[float]]:
        """One forward and backward of ``loss_fn(params, *inputs)``: the
        allocator's peak above the resident bytes (card only, else None),
        and the bytes saved for the backward. The gradients are allocated
        (zeroed) before the program, so the resident bytes hold them, the
        parameters and the input wherever the peak falls: the backward
        accumulates into them in place."""
        dev = self._device
        plist = list(params.parameters())
        for p in plist:
            p.grad = torch.zeros_like(p)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self._saving = SavedBytes(plist)
        try:
            with self._saving.hooks():
                loss = loss_fn(params, *inputs)
            loss.backward()
            saved = float(self._saving.total)
        finally:
            self._saving = None
        allocator = None
        if cuda:
            torch.cuda.synchronize(dev)
            allocator = float(torch.cuda.max_memory_allocated(dev) - base)
        for p in plist:
            p.grad = None
        return {"allocator": allocator, "saved": saved}

    def _measured(self, rec: Dict[str, Optional[float]]) -> float:
        return rec["allocator"] if rec["allocator"] is not None else rec["saved"]

    def _fwd_ms(self, t: int, bsz: int, seq: int) -> float:
        a = self.args
        lo, hi = a.layernum_min, a.layernum_max
        with torch.no_grad():
            f_lo, l_lo, xs = self._stack_t(t, lo, bsz, seq)
            t_lo = self._time(f_lo, (l_lo,) + xs)
            del l_lo, xs
            f_hi, l_hi, xs = self._stack_t(t, hi, bsz, seq)
            t_hi = self._time(f_hi, (l_hi,) + xs)
        return max((t_hi - t_lo) / (hi - lo) / bsz * 1e3, 1e-6)

    def _act_bytes(self, t: int, bsz: int, seq: int, remat: bool) -> float:
        """Layer-differenced forward+backward activation bytes per layer per
        sample (records both counts in `act_records`)."""
        a = self.args
        lo, hi = a.layernum_min, a.layernum_max
        recs = []
        for n in (lo, hi):
            fwd, layers, xs = self._stack_t(t, n, bsz, seq, "full" if remat else "none")
            recs.append(self._grad_bytes(fwd, layers, xs))
            del layers, xs

        def per_sample(key):
            if recs[0][key] is None:
                return None
            return max((recs[1][key] - recs[0][key]) / (hi - lo) / bsz, 1024.0)

        rec = {"remat": remat, "allocator": per_sample("allocator"), "saved": per_sample("saved")}
        self.act_records.append({k: (v / MB if isinstance(v, float) else v)
                                 for k, v in rec.items()})
        return self._measured(rec)

    def _grad_ms(self, t: int, bsz: int, seq: int, policy: Optional[str]) -> float:
        """Per-layer forward+backward time (layer-differenced), every layer
        under the remat `policy` when given."""
        a = self.args
        lo, hi = a.layernum_min, a.layernum_max

        def grad_prog(n):
            fwd, layers, xs = self._stack_t(t, n, bsz, seq, policy or "none")
            plist = list(layers.parameters())

            def step(layers, *xx):
                for p in plist:
                    p.grad = None
                fwd(layers, *xx).backward()

            return step, (layers,) + tuple(xs)

        g_lo, args_lo = grad_prog(lo)
        t_lo = self._time(g_lo, args_lo)
        del args_lo
        g_hi, args_hi = grad_prog(hi)
        t_hi = self._time(g_hi, args_hi)
        return max((t_hi - t_lo) / (hi - lo) * 1e3, 1e-9)

    def profile_remat(self, t: int = 0) -> Dict[str, float]:
        """Measured backward recompute toll per remat policy, as a fraction
        of the forward: frac(policy) = (grad_ms(policy) - grad_ms(no-remat))
        / fwd_ms, clamped to [0, 1.5]; dots_saveable never above full."""
        a = self.args
        seq = self._target_seq
        bsz = a.profile_batch_size
        fwd_ms = self._fwd_ms(t, bsz, seq) * bsz  # un-normalise to per-layer ms
        base = self._grad_ms(t, bsz, seq, None)
        out: Dict[str, float] = {"none": 0.0}
        for pol in ("full", "nothing_saveable", "dots_saveable"):
            frac = (self._grad_ms(t, bsz, seq, pol) - base) / max(fwd_ms, 1e-9)
            out[pol] = round(float(min(max(frac, 0.0), 1.5)), 4)
        out["dots_saveable"] = min(out["dots_saveable"], out["full"])
        return out

    def _other_ms_per_sample(self, bsz: int, seq: int, per_layer_ms_sum: float) -> float:
        """Embedding + head + loss time: the model at layernum_min layers
        minus its layers' share."""
        a = self.args
        loss, params, batch = self._full_model(a.layernum_min, bsz, seq)
        with torch.no_grad():
            t = self._time(loss, (params, batch))
        return max(t / bsz * 1e3 - a.layernum_min * per_layer_ms_sum, 1e-6)

    def _other_model_state_tables(self, bsz: int, seq: int, tps: Sequence[int]):
        """(embed_mb, head_mb, rest_mb, act_total_mb) for the 'other' tables."""
        loss, params, batch = self._full_model(0, bsz, seq)
        embed_mb = _module_bytes(params.embed) / MB
        heads = _module_bytes(params.lm_head) + _module_bytes(params.head)
        if self.cfg.head_type in ("lm", "mlm") and self.cfg.tie_embeddings:
            head_mb = embed_mb + _module_bytes(params.head) / MB
        else:
            head_mb = heads / MB
        rest_mb = _module_bytes(params.final_norm) / MB
        act_total = self._measured(self._grad_bytes(loss, params, (batch,)))
        return embed_mb, head_mb, rest_mb, max(act_total, 1024.0) / MB

    # ------------------------------------------------------------ computation
    def profile_computation(self) -> Dict:
        """The time table for the search engine. profile_mode:
        - static: one scalar at (profile_batch_size, seq);
        - batch: linear fit [m, c] of per-layer total ms vs batch size;
        - sequence: quadratic sweep over seq, stored under "seqlen%d" keys plus
          the fit evaluated at the target seq as the headline scalar."""
        a = self.args
        seq = self._target_seq
        out: Dict = {}
        headline = []
        for t in range(self.layer_types):
            key = "layertype_%d" % t
            if a.profile_mode == "batch":
                bszs = list(range(a.profile_min_batch_size, a.profile_max_batch_size + 1, a.batch_size_step))
                totals = [self._fwd_ms(t, b, seq) * b for b in bszs]
                m, c = np.polyfit(np.asarray(bszs, np.float64), np.asarray(totals, np.float64), 1)
                out[key] = [float(max(m, 0.0)), float(max(c, 0.0))]
                headline.append(totals[-1] / bszs[-1])
            elif a.profile_mode == "sequence":
                seqs = list(range(a.profile_min_seq_length, a.profile_max_seq_length + 1, a.seq_length_step))
                per_seq = {s: self._fwd_ms(t, a.profile_batch_size, s) for s in seqs}
                for s, v in per_seq.items():
                    out["%s_seqlen%d" % (key, s)] = v
                coef = np.polyfit(np.asarray(seqs, np.float64), np.asarray(list(per_seq.values())), 2)
                out["%s_seq_popt" % key] = [float(v) for v in coef]
                out[key] = float(np.polyval(coef, seq))
                headline.append(out[key])
            else:
                out[key] = self._fwd_ms(t, a.profile_batch_size, seq)
                headline.append(out[key])
        bsz_for_other = a.profile_max_batch_size if a.profile_mode == "batch" else a.profile_batch_size
        out["other_time"] = self._other_ms_per_sample(bsz_for_other, seq, sum(headline))
        if a.profile_remat:
            out["remat_recompute_frac"] = self.profile_remat()
        return out

    # ----------------------------------------------------------------- memory
    def profile_memory(self) -> Dict:
        a = self.args
        seq = self._target_seq
        bsz = a.profile_batch_size
        tps = []
        t = 1
        while t <= a.max_tp_deg:
            tps.append(t)
            t *= 2
        out: Dict = {}
        for lt in range(self.layer_types):
            param_mb = self._layer_param_bytes(lt) / MB
            act1 = self._act_bytes(lt, bsz, seq, remat=False) / MB
            act_ckpt = self._act_bytes(lt, bsz, seq, remat=True) / MB
            tp_act = {k: round(act1 / k, 3) for k in tps}
            tp_act["checkpoint"] = round(min(act_ckpt, act1), 3)
            out["layertype_%d" % lt] = {
                "parameter_size": round(param_mb, 3),
                "tp_activation_per_bsz_dict": tp_act,
            }
        embed_mb, head_mb, rest_mb, act_total = self._other_model_state_tables(bsz, seq, tps)

        def per_tp(x):
            return {k: round(x / k, 3) for k in tps}

        # model_states = 4x params (param + grad + two Adam moments, fp32),
        # the convention MemoryCostModel applies to parameter_size
        out["other_memory_pp_off"] = {
            "model_states": per_tp(4 * (embed_mb + head_mb + rest_mb)),
            "activation": {k: round(act_total / bsz / k, 3) for k in tps},
        }
        out["other_memory_pp_on"] = {
            "first_stage": {
                "model_states": per_tp(4 * embed_mb),
                "activation": {k: round(0.5 * act_total / bsz / k, 3) for k in tps},
            },
            "last_stage": {
                "model_states": per_tp(4 * (head_mb + rest_mb)),
                "activation": {k: round(0.5 * act_total / bsz / k, 3) for k in tps},
            },
        }
        return out

    # ------------------------------------------------------------------- files
    def config_paths(self) -> Dict[str, str]:
        tag = self._file_tag()
        return {
            "computation": os.path.join(
                self.args.config_dir, "computation_profiling_%s_%s.json" % (tag, self.model_name)
            ),
            "memory": os.path.join(
                self.args.config_dir, "memory_profiling_%s_%s.json" % (tag, self.model_name)
            ),
        }

    def profile_all(self, write: bool = True) -> Dict[str, Dict]:
        results = {
            "computation": self.profile_computation(),
            "memory": self.profile_memory(),
        }
        if write:
            os.makedirs(self.args.config_dir, exist_ok=True)
            paths = self.config_paths()
            for k, v in results.items():
                write_json_config(v, paths[k])
        return results


class T5ModelProfiler(ModelProfiler):
    """T5's two layer types: layertype_0 the encoder layer, layertype_1 the
    decoder layer, differenced against a FIXED encoder output so the
    cross-attention cost lands in the decoder's type."""

    layer_types = 2

    def _check_config(self, cfg) -> None:
        from galvatron_tpu_torch.models.t5 import T5Config

        if not isinstance(cfg, T5Config):
            raise TypeError("T5ModelProfiler needs a T5Config")

    def _stack_t(self, t: int, n: int, bsz: int, seq: int, policy: str = "none"):
        from galvatron_tpu_torch.models import t5 as T5

        cfg, dev = self.cfg, self._device
        layers = self._init_layers(
            nn.ModuleList(T5.T5Layer(cfg, dev, decoder=t == 1) for _ in range(n)),
            lambda name, p, gen: T5.init_param_(name, p, cfg, gen))
        gen = self._generator()
        x = torch.randn((bsz, seq, cfg.hidden_size), generator=gen, device=dev)
        table = torch.randn((cfg.rel_buckets, cfg.num_heads), generator=gen, device=dev) * 0.02
        bias = T5.rel_bias(table, seq, seq, cfg, bidirectional=t == 0)
        if t == 0:
            body = lambda j, lp, x_: T5.enc_layer_forward(lp, x_, cfg, bias)
        else:
            mem = torch.randn((bsz, seq, cfg.hidden_size), generator=gen,
                              device=dev).to(cfg.compute_dtype)
            body = lambda j, lp, x_: T5.dec_layer_forward(lp, x_, mem, cfg, bias)
        return self._stack(layers, x.to(cfg.compute_dtype), body, policy)

    def _layer_param_bytes(self, t: int) -> int:
        from galvatron_tpu_torch.models.t5 import T5Layer

        return _module_bytes(T5Layer(self.cfg, "meta", decoder=t == 1))

    def _full_model(self, n_layers: int, bsz: int, seq: int):
        from galvatron_tpu_torch.models import t5 as T5

        cfg = dataclasses.replace(self.cfg, num_enc_layers=n_layers, num_dec_layers=n_layers)
        gen, dev = self._generator(), self._device
        params = T5.init_t5_params(cfg, gen, dev)
        dec = torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen,
                                         device=dev),
                 "dec_tokens": dec, "labels": dec}
        return (lambda p, b: T5.t5_loss_fn(p, b, cfg)), params, batch

    def _other_model_state_tables(self, bsz: int, seq: int, tps: Sequence[int]):
        loss, params, batch = self._full_model(0, bsz, seq)
        embed_mb = _module_bytes(params.embed) / MB
        rest_mb = _module_bytes(params) / MB - embed_mb
        head_mb = embed_mb if self.cfg.tie_embeddings else _module_bytes(params.lm_head) / MB
        act_total = self._measured(self._grad_bytes(loss, params, (batch,)))
        return embed_mb, head_mb, rest_mb, max(act_total, 1024.0) / MB


class SwinModelProfiler(ModelProfiler):
    """One layer type per Swin stage: layertype_s is stage s's block at its
    own resolution and width (the headline sequence is the stage-0 patch
    grid's token count)."""

    def _check_config(self, cfg) -> None:
        from galvatron_tpu_torch.models.swin import SwinConfig

        if not isinstance(cfg, SwinConfig):
            raise TypeError("SwinModelProfiler needs a SwinConfig")

    @property
    def layer_types(self):  # type: ignore[override]
        return self.cfg.num_stages

    @property
    def _target_seq(self) -> int:
        return self.args.profile_seq_length or self.cfg.stage_resolution(0) ** 2

    def _file_tag(self) -> str:
        c = self.cfg
        return "%s_hidden%d_head%d_seqlen%d" % (
            self.args.mixed_precision, c.embed_dim, c.num_heads[0], self._target_seq)

    def _stack_t(self, t: int, n: int, bsz: int, seq: int, policy: str = "none"):
        # `seq` is unused: each stage has its resolution from the config
        from galvatron_tpu_torch.models import swin as W

        cfg, dev = self.cfg, self._device
        layers = self._init_layers(nn.ModuleList(W.SwinBlock(cfg, t, dev) for _ in range(n)),
                                   lambda name, p, gen: W.init_param_(name, p, cfg, gen))
        res = cfg.stage_resolution(t)
        x = torch.randn((bsz, res, res, cfg.stage_dim(t)), generator=self._generator(),
                        device=dev).to(cfg.compute_dtype)
        return self._stack(layers, x, lambda j, lp, x_: W.block_forward(lp, x_, cfg, t,
                                                                         j % 2 == 1), policy)

    def _layer_param_bytes(self, t: int) -> int:
        from galvatron_tpu_torch.models.swin import SwinBlock

        return _module_bytes(SwinBlock(self.cfg, t, "meta"))

    def _full_model(self, n_layers: int, bsz: int, seq: int):
        """The model at `n_layers` blocks per stage; at zero, the embedding,
        the merges and the head alone."""
        from galvatron_tpu_torch.models import swin as W

        cfg = dataclasses.replace(self.cfg, depths=tuple(max(n_layers, 1) for _ in
                                                         self.cfg.depths))
        gen, dev = self._generator(), self._device
        params = W.init_swin_params(cfg, gen, dev)
        batch = {"pixels": torch.randn((bsz, cfg.image_size, cfg.image_size, cfg.num_channels),
                                       generator=gen, device=dev),
                 "labels": torch.randint(0, max(cfg.num_classes, 1), (bsz,), generator=gen,
                                         device=dev)}
        if n_layers:
            return (lambda p, b: W.swin_loss_fn(p, b, cfg)), params, batch
        params.blocks = nn.ModuleDict()

        def loss(p, b):
            dtype, res = cfg.compute_dtype, cfg.stage_resolution(0)
            x = W._ln(M._proj(M.patchify(b["pixels"].to(dtype), cfg.patch_size), p.embed.patch,
                              dtype), p.embed.norm, cfg).reshape(bsz, res, res, cfg.embed_dim)
            for s in range(cfg.num_stages - 1):
                x = W.patch_merge(p.merges[str(s)], x, cfg)
            x = W._ln(x.reshape(bsz, -1, x.shape[-1]), p.final_norm, cfg)
            return M.classification_loss(M._proj(x.mean(dim=1), p.head, dtype), b["labels"])
        return loss, params, batch

    def _other_model_state_tables(self, bsz: int, seq: int, tps: Sequence[int]):
        loss, params, batch = self._full_model(0, bsz, seq)
        embed_mb = _module_bytes(params.embed) / MB
        head_mb = _module_bytes(params.head) / MB
        rest_mb = (_module_bytes(params.merges) + _module_bytes(params.final_norm)) / MB
        act_total = self._measured(self._grad_bytes(loss, params, (batch,)))
        return embed_mb, head_mb, rest_mb, max(act_total, 1024.0) / MB
