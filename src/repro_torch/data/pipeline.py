"""Deterministic synthetic data pipeline: document sampling, sequence
packing, shuffle buffer, and batch iteration.

A copy of ``repro/data/pipeline.py`` (numpy only), so that the port and
the reference draw the same token batches from one seed.  The corpus is a
seeded Zipf-ish token stream with document structure (BOS/EOS markers,
length distribution), packed into fixed-length sequences the way a
production text pipeline would (no padding waste).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    mean_doc_len: int = 180
    bos_id: int = 1
    eos_id: int = 2
    shuffle_buffer: int = 64


class SyntheticCorpus:
    """Seeded document stream with a Zipf unigram distribution and a small
    amount of bigram structure (so models have something learnable)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # learnable structure: each token prefers a fixed successor
        self.successor = self.rng.permutation(v)

    def documents(self) -> Iterator[np.ndarray]:
        cfg = self.cfg
        while True:
            n = max(4, int(self.rng.exponential(cfg.mean_doc_len)))
            toks = self.rng.choice(cfg.vocab_size, size=n, p=self.unigram)
            # 50% of positions follow the bigram successor rule
            follow = self.rng.random(n) < 0.5
            toks[1:] = np.where(follow[1:], self.successor[toks[:-1]],
                                toks[1:])
            toks[0] = cfg.bos_id
            toks[-1] = cfg.eos_id
            yield toks.astype(np.int32)


class PackedBatches:
    """Greedy sequence packing into (batch, seq_len) token blocks."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.rng = np.random.default_rng(cfg.seed + 1)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        docs = self.corpus.documents()
        buf: list[np.ndarray] = []
        stream = np.zeros((0,), np.int32)
        while True:
            need = cfg.batch_size * cfg.seq_len
            while stream.size < need + cfg.shuffle_buffer * cfg.mean_doc_len:
                buf.append(next(docs))
                if len(buf) >= cfg.shuffle_buffer:
                    self.rng.shuffle(buf)
                    stream = np.concatenate([stream, *buf])
                    buf = []
            block, stream = stream[:need], stream[need:]
            toks = block.reshape(cfg.batch_size, cfg.seq_len)
            yield {"tokens": toks, "labels": toks.copy()}


def make_batch_iterator(vocab_size: int, seq_len: int, batch_size: int,
                        seed: int = 0) -> Iterator[dict]:
    return iter(PackedBatches(PipelineConfig(
        vocab_size=vocab_size, seq_len=seq_len, batch_size=batch_size,
        seed=seed)))
