"""Input pipeline: batch preparation and the synthetic token stream.

Port of ``galvatron_tpu/runtime/dataloader.py`` for the token-stream (``lm``)
families. `RandomTextDataset` draws from the same ``np.random.RandomState``
stream as the reference, so both packages see identical token batches for
one seed. The zigzag context-parallel layout is refused until the CP slice
of the port; the indexed datasets come with the ``--data_path`` slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig


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
    loss) and the optional masks."""
    if hp is not None and hp.cp_mode == "zigzag" and hp.max_cp > 1:
        raise ValueError("zigzag context parallelism (cp=%d) is not ported yet: it comes "
                         "with the CP slice of galvatron_tpu_torch" % hp.max_cp)
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
