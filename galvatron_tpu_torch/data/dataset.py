"""Indexed GPT dataset: memmapped token binaries + native sample-index helper.

Port of the language-model half of ``galvatron_tpu/data/dataset.py``
(Megatron's IndexedDataset / GPTDataset / blended-dataset design). Three
indices, each a pure function of (corpus, seq_len, seed, epoch count), so a
resumed run rebuilds them and the stream continues byte for byte:

  doc_idx    — document ids repeated per epoch, shuffled (epoch-wise);
  sample_idx — per sample, the (doc_idx position, token offset) where its
               seq_len+1 window starts (native: ``data/csrc/index_helpers.cpp``);
  shuffle_idx— permutation of samples.

The on-disk format is the reference's, so both packages read one corpus:

  <path>.bin     — flat int32 token stream
  <path>.idx.npy — int64 document boundary offsets [n_docs + 1]

The native helper (the port's own copy of the reference's C++ source) is
built with ``g++`` at first use into ``build/galvatron_tpu_torch/``, keyed
by a hash of the source and flags, and loaded with ``ctypes``; a failed
build raises — there is no quiet numpy fallback on the data path.
`_build_sample_idx_py` and `_build_blending_indices_py` are the plain
versions the tests hold the native ones against.

Vision shards (the reference's format): ``<path>.images.npy`` (NHWC uint8
or float32) + ``<path>.labels.npy`` (int32), written by
`write_vision_dataset` and read memmapped by `vision_data_iterator`.

T5's span corruption (`t5_span_corrupt`, `t5_data_iterator`) reads the same
corpora and blends: each raw window is corrupted with a generator seeded by
its global sample index, so the stream is the reference's batch for batch.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.runtime.dataloader import prepare_batch
from galvatron_tpu_torch.utils import native

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "data", "csrc", "index_helpers.cpp")
BUILD_DIR = native.BUILD_DIR
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the build of the helper goes: keyed by its source and flags."""
    return native.keyed_path(SOURCE, "index_helpers", CXX_FLAGS, BUILD_DIR)


def build() -> str:
    """Compile the helper if it has no build yet; returns the library path.
    Raises RuntimeError when the compiler is missing or fails."""
    return native.compile_shared(SOURCE, library_path(), CXX_FLAGS)


def _load_helpers():
    """The native helper, built at first use (raises if it cannot be)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.build_sample_idx.restype = ctypes.c_int64
            lib.build_sample_idx.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib.build_blending_indices.restype = None
            lib.build_blending_indices.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
        return _lib


def _build_sample_idx_py(doc_lens, doc_idx, seq_len, n_samples) -> np.ndarray:
    """Plain version of the native helper, same contract."""
    out = np.zeros((n_samples + 1, 2), np.int64)
    pos, offset, sample = 0, 0, 0
    n = len(doc_idx)
    while sample < n_samples and pos < n:
        remaining = seq_len
        while remaining > 0 and pos < n:
            doc_left = int(doc_lens[doc_idx[pos]]) - offset
            if doc_left > remaining:
                offset += remaining
                remaining = 0
            else:
                remaining -= doc_left
                pos += 1
                offset = 0
        if remaining > 0:
            break
        sample += 1
        out[sample] = (pos, offset)
    return out[: sample + 1]


def build_sample_idx(doc_lens: np.ndarray, doc_idx: np.ndarray, seq_len: int,
                     n_samples: int) -> np.ndarray:
    """(n_emitted+1, 2) array of (doc_idx position, offset) boundaries."""
    lib = _load_helpers()
    doc_lens = np.ascontiguousarray(doc_lens, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    out = np.zeros((n_samples + 1, 2), np.int64)
    emitted = lib.build_sample_idx(
        doc_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        doc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(doc_idx), seq_len, n_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[: emitted + 1]


# ------------------------------------------------------------------ on disk
def write_indexed_dataset(path: str, documents: Iterable[Sequence[int]]) -> int:
    """Write documents (token id lists or arrays; any iterable, streamed one
    document at a time) as <path>.bin + <path>.idx.npy; returns the
    document count. A stale index goes first and the .bin is written under
    a temporary name, moved into place once every document is in: a
    failure midway (the iterable raising included) never leaves a new or
    partial .bin paired with an old index."""
    idx_path = path + ".idx.npy"
    if os.path.exists(idx_path):
        os.remove(idx_path)
    tmp = path + ".bin.tmp"
    offsets = [0]
    try:
        with open(tmp, "wb") as f:
            for d in documents:
                tokens = np.asarray(d, np.int32)
                tokens.tofile(f)
                offsets.append(offsets[-1] + len(tokens))
        os.replace(tmp, path + ".bin")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    np.save(idx_path, np.asarray(offsets, np.int64))
    return len(offsets) - 1


class IndexedDataset:
    """Memmapped flat token stream with document boundaries."""

    def __init__(self, path: str):
        bin_path, idx_path = path + ".bin", path + ".idx.npy"
        if not os.path.exists(bin_path) or not os.path.exists(idx_path):
            raise FileNotFoundError(
                "indexed dataset %r needs %s and %s (write_indexed_dataset builds them)"
                % (path, bin_path, idx_path))
        self.tokens = np.memmap(bin_path, dtype=np.int32, mode="r")
        self.offsets = np.load(idx_path)

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    @property
    def doc_lens(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    def doc(self, i: int) -> np.ndarray:
        return self.tokens[self.offsets[i]: self.offsets[i + 1]]


def split_doc_ids(n_docs: int, split: str) -> Dict[str, np.ndarray]:
    """Contiguous train/valid/test document ranges from a weight string like
    "969,30,1" (Megatron --split semantics); a pure function of (n_docs,
    split), so a resumed run sees identical splits."""
    weights = [float(w) for w in split.split(",")]
    if len(weights) != 3 or any(w < 0 for w in weights) or sum(weights) <= 0:
        raise ValueError("--split needs three non-negative weights, got %r" % split)
    total = sum(weights)
    bounds = np.cumsum([0.0] + [w / total for w in weights])
    edges = np.round(bounds * n_docs).astype(np.int64)
    edges[-1] = n_docs
    return {name: np.arange(edges[i], edges[i + 1], dtype=np.int32)
            for i, name in enumerate(("train", "valid", "test"))}


class GPTDataset:
    """Sampled LM windows over an IndexedDataset (Megatron GPTDataset
    semantics: epoch-shuffled documents, overlapping seq_len+1 windows,
    sample-level shuffle). `documents` restricts the dataset to a doc-id
    subset (a range of `split_doc_ids`)."""

    def __init__(self, indexed: IndexedDataset, seq_len: int, n_samples: int,
                 seed: int = 1234, documents: Optional[np.ndarray] = None):
        self.indexed = indexed
        self.seq_len = seq_len
        self.seed = seed
        self.documents = (np.arange(indexed.n_docs, dtype=np.int32) if documents is None
                          else np.asarray(documents, np.int32))
        if len(self.documents) == 0:
            raise ValueError("empty document subset (check the --split weights)")
        doc_lens = indexed.doc_lens[self.documents]
        total_tokens = int(doc_lens.sum())
        if total_tokens <= seq_len:
            raise ValueError("split has %d tokens; need > seq_len=%d" % (total_tokens, seq_len))
        samples_per_epoch = max((total_tokens - 1) // seq_len, 1)
        n_epochs = (n_samples + samples_per_epoch - 1) // samples_per_epoch + 1
        rng = np.random.RandomState(seed)
        doc_idx = np.concatenate([rng.permutation(len(self.documents)).astype(np.int32)
                                  for _ in range(n_epochs)])
        self.sample_idx = build_sample_idx(doc_lens, doc_idx, seq_len, n_samples)
        self.doc_idx = doc_idx
        n_avail = len(self.sample_idx) - 1
        self.shuffle_idx = np.random.RandomState(seed + 1).permutation(n_avail)
        self.n_samples = n_avail

    def __len__(self) -> int:
        return self.n_samples

    def _doc(self, pos: int) -> np.ndarray:
        return self.indexed.doc(int(self.documents[self.doc_idx[pos]]))

    def __getitem__(self, i: int) -> np.ndarray:
        """seq_len+1 tokens (inputs + shifted target)."""
        i = int(self.shuffle_idx[i % self.n_samples])
        (p0, o0), (p1, o1) = self.sample_idx[i], self.sample_idx[i + 1]
        if p0 == p1:
            parts = [self._doc(p0)[o0: o1 + 1]]
        else:
            parts = [self._doc(p0)[o0:]]
            for p in range(p0 + 1, p1):
                parts.append(self._doc(p))
            parts.append(self._doc(p1)[: o1 + 1])
        out = np.concatenate(parts)
        # the +1 target token may fall past the end of the walk: pad
        # deterministically, as the reference does
        if len(out) < self.seq_len + 1:
            out = np.concatenate([out, np.zeros(self.seq_len + 1 - len(out), np.int32)])
        return out[: self.seq_len + 1]


def gpt_data_iterator(
    data_path: str,
    hp: HybridParallelConfig,
    seq_len: int,
    seed: int = 1234,
    n_samples: Optional[int] = None,
    start_step: int = 0,
    split: str = "train",
    split_weights: str = "969,30,1",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic global-batch stream (CPU tensors) over one split of the
    indexed dataset. `data_path` is one prefix or a Megatron-style blend
    "W1 PREFIX1 W2 PREFIX2 ...". Batch content is a pure function of the
    step index, so resume passes `start_step` (O(1) skip)."""
    ds = _build_lm_dataset(data_path, seq_len, n_samples or 1_000_000, seed, split,
                           split_weights)
    step = start_step
    while True:
        window = np.stack([ds[step * hp.global_bsz + b] for b in range(hp.global_bsz)])
        yield prepare_batch(hp, window[:, :-1], labels=window[:, 1:])
        step += 1


def gpt_train_iterator(data_path, hp, seq_len, seed=1234, n_samples=None, start_step=0):
    """A train stream over the FULL corpus (no held-out splits)."""
    return gpt_data_iterator(data_path, hp, seq_len, seed=seed, n_samples=n_samples,
                             start_step=start_step, split="train", split_weights="1,0,0")


# ---------------------------------------------------------- corpus blending
def _blend_weights(weights: Sequence[float]) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    if (w <= 0).any():
        raise ValueError("blend weights must be positive, got %r" % (list(weights),))
    return np.ascontiguousarray(w / w.sum())


def _build_blending_indices_py(weights: Sequence[float], n_samples: int):
    """Plain version of the native blend schedule: the greedy pick (argmin_k
    (count_k+1)/w_k, first index on ties) is a merge of the per-dataset key
    sequences (j+1)/w_k, so one lexsort over the same doubles gives the
    same schedule, ties included."""
    w = _blend_weights(weights)
    caps = np.minimum(np.ceil(w * n_samples).astype(np.int64) + len(w) + 2, n_samples)
    ks = np.repeat(np.arange(len(w), dtype=np.int32), caps)
    js = np.concatenate([np.arange(c, dtype=np.int64) for c in caps])
    prio = (js + 1).astype(np.float64) / w[ks]
    order = np.lexsort((ks, prio))[:n_samples]
    return ks[order].astype(np.int32), js[order].astype(np.int64)


def build_blending_indices(weights: Sequence[float], n_samples: int):
    """Greedy blend schedule (native): sample i draws from the dataset whose
    running count lags its weight most, so every prefix of the stream tracks
    the requested proportions. Returns (dataset_index, dataset_sample_index)."""
    w = _blend_weights(weights)
    ds_index = np.zeros(n_samples, np.int32)
    ds_sample = np.zeros(n_samples, np.int64)
    _load_helpers().build_blending_indices(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(w), n_samples,
        ds_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ds_sample.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return ds_index, ds_sample


def parse_blend(data_path: str):
    """Megatron --data-path blend syntax: "W1 PREFIX1 W2 PREFIX2 ..." (or a
    single prefix). Returns (weights, prefixes). A multi-token string whose
    first token is not a number is ONE path containing whitespace."""
    parts = data_path.split()
    if len(parts) <= 1:
        return [1.0], [data_path.strip() or data_path]
    try:
        float(parts[0])
    except ValueError:
        return [1.0], [data_path]
    if len(parts) % 2 != 0:
        raise ValueError("blended --data_path must alternate WEIGHT PREFIX pairs, got %r"
                         % data_path)
    weights = [float(parts[i]) for i in range(0, len(parts), 2)]
    prefixes = [parts[i] for i in range(1, len(parts), 2)]
    if any(not np.isfinite(w) or w <= 0 for w in weights):
        raise ValueError("blend weights must be positive, got %r" % weights)
    return weights, prefixes


def _build_lm_dataset(data_path: str, seq_len: int, total: int, seed: int, split: str,
                      split_weights: str):
    """Single-corpus GPTDataset or weighted blend, per the --data_path form;
    each blended corpus is sized to its weight share of `total` plus the
    schedule's slack."""
    weights, prefixes = parse_blend(data_path)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    per_corpus = []
    for k, prefix in enumerate(prefixes):
        indexed = IndexedDataset(prefix)
        docs = split_doc_ids(indexed.n_docs, split_weights)[split]
        n_k = total if len(prefixes) == 1 else int(np.ceil(w[k] * total)) + len(w) + 2
        per_corpus.append(GPTDataset(indexed, seq_len, n_k, seed=seed + k, documents=docs))
    return (per_corpus[0] if len(per_corpus) == 1
            else BlendedGPTDataset(per_corpus, weights, total))


class BlendedGPTDataset:
    """Weighted blend of per-corpus GPTDatasets (each already restricted to
    the requested split)."""

    def __init__(self, datasets: List[GPTDataset], weights: Sequence[float], n_samples: int):
        if len(datasets) != len(weights):
            raise ValueError("need one weight per dataset")
        self.datasets = datasets
        self.ds_index, self.ds_sample = build_blending_indices(weights, n_samples)
        self.n_samples = n_samples

    def __len__(self):
        return self.n_samples

    def __getitem__(self, i: int) -> np.ndarray:
        i = i % self.n_samples
        return self.datasets[int(self.ds_index[i])][int(self.ds_sample[i])]


# ------------------------------------------------------- T5 span corruption
def t5_span_corrupt(tokens: np.ndarray, rng: np.random.RandomState, *, vocab_size: int,
                    noise_density: float = 0.15, mean_span_len: float = 3.0,
                    n_sentinels: int = 100):
    """T5 span corruption of one token window (the reference's
    T5MaskedWordPieceDataset objective, from the T5 paper's denoising
    recipe): contiguous spans covering ~`noise_density` of the window are
    each replaced by ONE sentinel id in the encoder stream; the decoder
    target is [sentinel_i, span_i...] for every span, closed by a final
    sentinel. Sentinels count down from vocab_size-1 (HF T5 extra_ids).
    The draws from `rng` are the reference's, in its order.

    Returns (enc_tokens, dec_target) as int32 arrays (variable length)."""
    if not 0.0 < noise_density < 1.0:
        raise ValueError("noise_density must be in (0, 1), got %r" % noise_density)
    if mean_span_len <= 0:
        raise ValueError("mean_span_len must be positive, got %r" % mean_span_len)
    length = len(tokens)
    n_noise = min(max(int(round(length * noise_density)), 1), max(length - 1, 1))
    n_spans = max(int(round(n_noise / mean_span_len)), 1)
    # feasibility: n_spans - 1 distinct cut points inside (0, n_noise) and
    # n_spans distinct starts over the length - n_noise + 1 gap slots
    n_spans = min(n_spans, n_noise, length - n_noise + 1)
    cuts = (np.sort(rng.choice(np.arange(1, n_noise), size=n_spans - 1, replace=False))
            if n_noise > n_spans else np.arange(1, n_spans))
    span_lens = np.diff(np.concatenate([[0], cuts, [n_noise]]))
    span_lens = span_lens[span_lens > 0]
    n_gap = length - int(span_lens.sum())
    starts_gap = np.sort(rng.choice(np.arange(n_gap + 1), size=len(span_lens), replace=False))
    enc_parts, dec_parts = [], []
    pos = gap_consumed = 0
    for i, (g, sl) in enumerate(zip(starts_gap, span_lens)):
        keep = g - gap_consumed
        sentinel = np.asarray([vocab_size - 1 - (i % n_sentinels)], np.int32)
        enc_parts += [tokens[pos:pos + keep], sentinel]
        dec_parts += [sentinel, tokens[pos + keep:pos + keep + sl]]
        pos += keep + sl
        gap_consumed = g
    enc_parts.append(tokens[pos:])
    dec_parts.append(np.asarray([vocab_size - 1 - (len(span_lens) % n_sentinels)], np.int32))
    return (np.concatenate(enc_parts).astype(np.int32),
            np.concatenate(dec_parts).astype(np.int32))


def t5_data_iterator(
    data_path: str,
    hp: HybridParallelConfig,
    enc_seq_len: int,
    dec_seq_len: int,
    seed: int = 1234,
    n_samples: Optional[int] = None,
    start_step: int = 0,
    split: str = "train",
    split_weights: str = "969,30,1",
    vocab_size: int = 32128,
    noise_density: float = 0.15,
    mean_span_len: float = 3.0,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Span-corruption global batches (CPU tensors) over one split of an
    indexed corpus or blend: the T5 contract (tokens, attn_mask,
    dec_tokens, labels, loss_mask) at the fixed shapes (enc_seq_len,
    dec_seq_len), truncated or padded. The decoder input is the target
    shifted right behind the start id 0 (HF T5 ``_shift_right``). A pure
    function of (corpus, weights, seed, step)."""
    ds = _build_lm_dataset(data_path, enc_seq_len, n_samples or 1_000_000, seed, split,
                           split_weights)
    b_size = hp.global_bsz
    step = start_step
    while True:
        enc = np.zeros((b_size, enc_seq_len), np.int64)
        attn = np.zeros((b_size, enc_seq_len), np.float32)
        dec_in = np.zeros((b_size, dec_seq_len), np.int64)
        labels = np.zeros((b_size, dec_seq_len), np.int64)
        lmask = np.zeros((b_size, dec_seq_len), np.float32)
        for b in range(b_size):
            i = step * b_size + b
            rng = np.random.RandomState((seed * 1_000_003 + i) % (2**31 - 1))
            e, d = t5_span_corrupt(ds[i][:enc_seq_len], rng, vocab_size=vocab_size,
                                   noise_density=noise_density, mean_span_len=mean_span_len)
            e, d = e[:enc_seq_len], d[:dec_seq_len]
            enc[b, :len(e)] = e
            attn[b, :len(e)] = 1.0
            dec_in[b, 1:len(d)] = d[:len(d) - 1]
            labels[b, :len(d)] = d
            lmask[b, :len(d)] = 1.0
        yield {k: torch.from_numpy(v) for k, v in (
            ("tokens", enc), ("attn_mask", attn), ("dec_tokens", dec_in), ("labels", labels),
            ("loss_mask", lmask))}
        step += 1


# ------------------------------------------------------------- vision shards
def write_vision_dataset(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """Write <path>.images.npy + <path>.labels.npy shards (uint8 or float32
    NHWC images)."""
    if len(images) != len(labels):
        raise ValueError("images/labels length mismatch: %d vs %d" % (len(images), len(labels)))
    np.save(path + ".images.npy", images)
    np.save(path + ".labels.npy", np.asarray(labels, np.int32))


def vision_data_iterator(
    data_path: str,
    hp: HybridParallelConfig,
    image_size: int,
    num_channels: int,
    seed: int = 1234,
    start_step: int = 0,
    split: str = "train",
    split_weights: str = "969,30,1",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Global batches ({pixels (B, H, W, C) fp32 in [0, 1] for uint8
    shards, labels (B,)}) over one split of a vision shard, memmapped; the
    sample order is a per-epoch permutation of the split seeded by `seed` +
    epoch, a pure function of the step, as in the reference."""
    _, prefixes = parse_blend(data_path)
    if len(prefixes) > 1:
        raise ValueError("corpus blending (\"W1 PREFIX1 W2 PREFIX2 ...\") is not supported "
                         "for vision datasets; got --data_path %r" % data_path)
    data_path = prefixes[0]
    img_path, lab_path = data_path + ".images.npy", data_path + ".labels.npy"
    if not os.path.exists(img_path) or not os.path.exists(lab_path):
        raise FileNotFoundError("vision dataset %r needs %s and %s (write_vision_dataset "
                                "builds them)" % (data_path, img_path, lab_path))
    images = np.load(img_path, mmap_mode="r")
    labels = np.load(lab_path)
    if images.shape[1:] != (image_size, image_size, num_channels):
        raise ValueError("dataset images are %s; model expects (%d, %d, %d)"
                         % (images.shape[1:], image_size, image_size, num_channels))
    ids = split_doc_ids(len(images), split_weights)[split]
    if len(ids) == 0:
        raise ValueError("empty %s split over %d samples" % (split, len(images)))
    n = len(ids)
    step = start_step
    cur_epoch, perm = -1, None
    while True:
        batch_ids = []
        for b in range(hp.global_bsz):
            epoch, off = divmod(step * hp.global_bsz + b, n)
            if epoch != cur_epoch:  # a pure function of the epoch: resume-safe
                perm = np.random.RandomState(seed + epoch).permutation(n)
                cur_epoch = epoch
            batch_ids.append(ids[perm[off]])
        px = np.stack([images[int(j)] for j in batch_ids])
        if px.dtype == np.uint8:
            px = px.astype(np.float32) / 255.0
        yield {"pixels": torch.from_numpy(np.ascontiguousarray(px, np.float32)),
               "labels": torch.from_numpy(labels[np.asarray(batch_ids)].astype(np.int64))}
        step += 1
