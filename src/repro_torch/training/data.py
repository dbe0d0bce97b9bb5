"""Deterministic synthetic LM streams — the port's own copy of
``repro.training.data``, numpy only: for a seed its batches are bit-equal
to the reference's.

A Zipf-distributed unigram stream with a fixed bigram successor table
followed at 60% of positions: learnable by a small model in a few hundred
steps. Batches are the ``Model.loss`` batch dict of numpy arrays for the
config's family (audio / vision stubs filled with seeded pseudo-
embeddings); the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    zipf_a: float = 1.3


class TokenStream:
    """Infinite deterministic batch iterator."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self._rng = np.random.default_rng(data.seed)
        V = cfg.vocab_size
        # fixed random bigram successor table => learnable structure
        table_rng = np.random.default_rng(12345)
        self._succ = table_rng.integers(0, V, V)

    def _sample_tokens(self, B: int, T: int) -> np.ndarray:
        V = self.cfg.vocab_size
        z = self._rng.zipf(self.data.zipf_a, (B, T)) % V
        out = z.astype(np.int64)
        # 60% of positions follow the bigram table (signal); rest noise
        follow = self._rng.random((B, T)) < 0.6
        for t in range(1, T):
            out[:, t] = np.where(follow[:, t], self._succ[out[:, t - 1]],
                                 out[:, t])
        return out.astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, T = self.data.batch_size, self.data.seq_len
        batch: Dict[str, np.ndarray] = {"tokens": self._sample_tokens(B, T)}
        cfg = self.cfg
        if cfg.family == "encdec":
            e_rng = np.random.default_rng(self.data.seed + 7)
            batch["audio_embeds"] = e_rng.normal(
                0, 1, (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            n_patch = max(1, T // 8)
            vm = np.zeros((B, T), bool)
            vm[:, :n_patch] = True
            e_rng = np.random.default_rng(self.data.seed + 13)
            batch["vision_embeds"] = e_rng.normal(
                0, 1, (B, n_patch, cfg.d_model)).astype(np.float32)
            batch["vision_mask"] = vm
        return batch
