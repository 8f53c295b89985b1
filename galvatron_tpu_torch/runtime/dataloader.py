"""Input pipeline: batch preparation, the synthetic token stream and the
choice between it and an indexed corpus.

Port of ``galvatron_tpu/runtime/dataloader.py`` for the token-stream
(``lm``), encoder-decoder (``seq2seq``) and image (``vision``) families.
`RandomTextDataset`, `get_seq2seq_train_iterator` and
`get_vision_train_iterator` draw from the same ``np.random.RandomState``
streams as the reference, so both packages see identical batches for one
seed; `build_data_iterator` (the function of that name in the reference's
``cli/train.py``) picks the indexed corpus (span-corrupted for
``seq2seq``) or the vision shard of ``--data_path`` (``data/dataset.py``)
or the synthetic stream, per split.

`prepare_batch` applies the zigzag context-parallel layout, as the
reference does: under ``cp_mode="zigzag"`` with any cp > 1 (a layer's or
vocab cp) it permutes every field of the batch along the sequence once
(``ops.ring_attention.zigzag_permutation`` at ``max_cp``), so cp rank r
holds chunks r and 2cp-1-r and every ring step does equal work. The model
is permutation-equivariant given the per-token positions; the attention
outside the ring follows the permuted sequence's true causal structure
(``models.base._attention``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.ops.ring_attention import zigzag_permutation


def prepare_batch(
    hp: Optional[HybridParallelConfig],
    tokens: np.ndarray,
    labels: Optional[np.ndarray] = None,
    loss_mask: Optional[np.ndarray] = None,
    attn_mask: Optional[np.ndarray] = None,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """tokens (B, S) -> model batch dict on `device`: tokens, positions,
    labels (the tokens rolled by one, the last position masked out of the
    loss) and the optional masks, zigzag-permuted along the sequence when
    the strategy uses zigzag context parallelism. Key-padding masks
    (`attn_mask`) must come through here under zigzag cp, so that their
    order matches the permuted tokens."""
    tokens = np.asarray(tokens)
    b, s = tokens.shape
    if labels is None:
        labels = np.roll(tokens, -1, axis=1)
        if loss_mask is None:
            loss_mask = np.ones((b, s), np.float32)
            loss_mask[:, -1] = 0.0  # rolled last token has no target
    batch = {
        "tokens": torch.from_numpy(tokens.astype(np.int64)),
        "positions": torch.arange(s, dtype=torch.int64).expand(b, s),
        "labels": torch.from_numpy(np.asarray(labels).astype(np.int64)),
    }
    if loss_mask is not None:
        batch["loss_mask"] = torch.from_numpy(np.asarray(loss_mask, np.float32))
    if attn_mask is not None:
        batch["attn_mask"] = torch.from_numpy(np.asarray(attn_mask, np.float32))
    if hp is not None and hp.cp_mode == "zigzag" and hp.max_cp > 1:
        idx = torch.from_numpy(zigzag_permutation(s, hp.max_cp))
        batch = {k: v[:, idx] for k, v in batch.items()}
    return {k: v.to(device) for k, v in batch.items()}


class RandomTextDataset:
    """Deterministic synthetic token stream (the reference models' random-data
    fallback path)."""

    def __init__(self, vocab_size: int, seq_len: int, size: int = 1024, seed: int = 1234):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.size = size
        self.seed = seed

    def batch(self, step: int, batch_size: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + step % max(self.size, 1))
        return rng.randint(0, self.vocab_size, (batch_size, self.seq_len))

    def iterator(self, hp: HybridParallelConfig, start_step: int = 0,
                 device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield prepare_batch(hp, self.batch(step, hp.global_bsz), device=device)
            step += 1


def get_train_iterator(
    hp: HybridParallelConfig, vocab_size: int, seq_len: int, seed: int = 1234,
    start_step: int = 0, device="cpu",
) -> Iterator[Dict[str, torch.Tensor]]:
    """The stream is a pure function of the step index: `start_step` skips
    ahead in O(1)."""
    return RandomTextDataset(vocab_size, seq_len, seed=seed).iterator(hp, start_step, device)


def get_vision_train_iterator(
    hp: HybridParallelConfig, image_size: int, num_channels: int, num_classes: int,
    seed: int = 1234, start_step: int = 0, device="cpu",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Synthetic image-classification stream: {pixels (B, H, W, C) standard
    normal fp32, labels (B,)}, a pure function of the step."""
    step = start_step
    while True:
        rng = np.random.RandomState(seed + step)
        pixels = rng.randn(hp.global_bsz, image_size, image_size, num_channels).astype(np.float32)
        labels = rng.randint(0, num_classes, (hp.global_bsz,))
        yield {"pixels": torch.from_numpy(pixels).to(device),
               "labels": torch.from_numpy(labels.astype(np.int64)).to(device)}
        step += 1


def get_seq2seq_train_iterator(
    hp: HybridParallelConfig, vocab_size: int, enc_seq_len: int, dec_seq_len: int,
    seed: int = 1234, start_step: int = 0, device="cpu",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Synthetic encoder-decoder stream: {tokens, dec_tokens, labels (the
    decoder tokens rolled by one), loss_mask (the rolled last position
    out)}, a pure function of the step."""
    step = start_step
    while True:
        rng = np.random.RandomState(seed + step)
        dec = rng.randint(0, vocab_size, (hp.global_bsz, dec_seq_len))
        loss_mask = np.ones((hp.global_bsz, dec_seq_len), np.float32)
        loss_mask[:, -1] = 0.0
        tokens = rng.randint(0, vocab_size, (hp.global_bsz, enc_seq_len))
        batch = {"tokens": tokens, "dec_tokens": dec, "labels": np.roll(dec, -1, axis=1),
                 "loss_mask": loss_mask}
        yield {k: torch.from_numpy(v if v.dtype == np.float32 else v.astype(np.int64)).to(device)
               for k, v in batch.items()}
        step += 1


# synthetic streams have no documents to split: each split is a disjoint,
# deterministic stream of its own seed (the reference's offsets)
SPLIT_SEED_OFFSETS = {"train": 0, "valid": 7919, "test": 15838}


def build_data_iterator(args, fam, cfg, hp: HybridParallelConfig, start_step: int = 0,
                        split: str = "train", device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
    """The global-batch stream of one split: the indexed corpus of
    ``args.data_path`` (``--split`` document weights) when given, else the
    synthetic stream of the family's data kind (``lm``: tokens; ``seq2seq``:
    encoder and decoder tokens, both ``max_seq_len`` long; ``vision``:
    pixels and labels). Both are pure functions of the step index, so
    `start_step` resumes in O(1)."""
    if fam.data_kind not in ("lm", "seq2seq", "vision"):
        raise ValueError("unknown data_kind %r" % fam.data_kind)
    split_seed = args.seed + SPLIT_SEED_OFFSETS.get(split, 0)
    if getattr(args, "data_path", None):
        from galvatron_tpu_torch.data import dataset

        kw = dict(seed=args.seed, start_step=start_step, split=split,
                  split_weights=getattr(args, "split", "969,30,1"))
        if fam.data_kind == "vision":
            it = dataset.vision_data_iterator(args.data_path, hp, image_size=cfg.image_size,
                                              num_channels=cfg.num_channels, **kw)
        elif fam.data_kind == "seq2seq":
            it = dataset.t5_data_iterator(args.data_path, hp, enc_seq_len=cfg.max_seq_len,
                                          dec_seq_len=cfg.max_seq_len,
                                          vocab_size=cfg.vocab_size, **kw)
        else:
            it = dataset.gpt_data_iterator(args.data_path, hp, seq_len=cfg.max_seq_len, **kw)
        if torch.device(device).type == "cpu":
            return it
        return ({k: v.to(device) for k, v in b.items()} for b in it)
    if fam.data_kind == "vision":
        return get_vision_train_iterator(hp, cfg.image_size, cfg.num_channels, cfg.num_classes,
                                         seed=split_seed, start_step=start_step, device=device)
    if fam.data_kind == "seq2seq":
        return get_seq2seq_train_iterator(hp, cfg.vocab_size, cfg.max_seq_len, cfg.max_seq_len,
                                          seed=split_seed, start_step=start_step, device=device)
    return get_train_iterator(hp, cfg.vocab_size, cfg.max_seq_len, seed=split_seed,
                              start_step=start_step, device=device)
