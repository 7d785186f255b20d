"""Deterministic synthetic data pipeline: document sampling, sequence
packing, shuffle buffer, and batch iteration.

A copy of ``repro/data/pipeline.py`` (numpy only), so that the port and
the reference draw the same token batches from one seed.  The corpus is a
seeded Zipf-ish token stream with document structure (BOS/EOS markers,
length distribution), packed into fixed-length sequences the way a
production text pipeline would (no padding waste).  ``synthesize_batch``
draws one batch of an architecture's input kind: token ids, frame
embeddings (audio) or image patch embeddings ahead of text tokens (the
vision-language model), the reference's stubs of those frontends.
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


def synthesize_batch(cfg, batch_size: int, seq_len: int, seed: int = 0):
    """One batch of ``cfg.input_kind``, numpy from ``seed``, as the
    reference draws it: ``tokens`` (B, S) and ``labels``; for frames
    ``features`` (B, S, d) float32 and ``labels`` (B, S); for mixed
    ``image_embeds`` (B, min(num_image_tokens, S // 2), d) float32, then
    ``tokens`` and ``labels`` for the remaining text positions."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (batch_size, seq_len),
                            dtype=np.int32)
        return {"tokens": toks, "labels": toks.copy()}
    if cfg.input_kind == "frames":
        return {
            "features": rng.standard_normal(
                (batch_size, seq_len, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (batch_size, seq_len), dtype=np.int32),
        }
    if cfg.input_kind == "mixed":
        n_img = min(cfg.num_image_tokens, seq_len // 2)
        n_txt = seq_len - n_img
        toks = rng.integers(0, cfg.vocab_size, (batch_size, n_txt),
                            dtype=np.int32)
        return {
            "image_embeds": rng.standard_normal(
                (batch_size, n_img, cfg.d_model)).astype(np.float32),
            "tokens": toks, "labels": toks.copy(),
        }
    raise ValueError(cfg.input_kind)
