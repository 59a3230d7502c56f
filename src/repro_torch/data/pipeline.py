"""Deterministic, resumable data pipeline (a copy of
``repro/data/pipeline.py``, numpy only: the port imports nothing of the
JAX package). Every batch is the reference's integer arrays to the bit.

Every batch is a pure function of (seed, step): a restarted or elastic-
rescaled worker reproduces exactly the stream it would have seen, which is
the straggler/fault-tolerance fencing mechanism (no torn batches, no
skipped/duplicated data after restore). Three sources:

* ``SyntheticLM``    — random tokens (throughput + dry-run shapes)
* ``MemmapTokens``   — binary token file, strided windows (real corpora)
* ``TaskMixture``    — the synthetic SFT task used by the paper-fidelity
                       benchmarks: prompts of digits, target = sorted digits
                       (an exact-match-scoreable "downstream task" so the
                       Table 1/2/3 reproductions have a real accuracy axis)
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq_len), dtype=np.int32)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class MemmapTokens:
    """Strided windows over a flat binary int32 token file."""
    path: str
    seq_len: int
    batch: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n_windows = max(len(self._data) - self.seq_len - 1, 1)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        starts = rng.integers(0, self._n_windows, self.batch)
        toks = np.stack([self._data[s:s + self.seq_len] for s in starts]).astype(np.int32)
        labels = np.stack([self._data[s + 1:s + self.seq_len + 1] for s in starts]).astype(np.int32)
        return {"tokens": toks, "labels": labels}


# ---------------------------------------------------------------------------
# Synthetic SFT task: sort digit sequences.
# vocab layout: 0..9 digits, 10 = SEP, 11 = EOS, 12 = PAD, 13+ = filler noise
# ---------------------------------------------------------------------------
SEP, EOS, PAD = 10, 11, 12


@dataclasses.dataclass
class SortTask:
    """Prompt: d_1..d_n SEP ; completion: sorted(d) EOS. Exact-match scoreable."""
    vocab: int
    seq_len: int
    batch: int
    n_digits: int = 8
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 7]))
        n = self.n_digits
        B, S = self.batch, self.seq_len
        if S < 2 * n + 2:
            raise ValueError(
                f"seq_len={S} too short for n_digits={n} addition prompts "
                f"(needs >= {2 * n + 2})")
        toks = np.full((B, S), PAD, np.int32)
        labels = np.full((B, S), PAD, np.int32)
        mask = np.zeros((B, S), np.float32)
        for b in range(B):
            d = rng.integers(0, 10, n)
            seq = np.concatenate([d, [SEP], np.sort(d), [EOS]])
            toks[b, :len(seq)] = seq
            labels[b, :len(seq) - 1] = seq[1:]
            mask[b, n:len(seq) - 1] = 1.0   # loss only on the completion
        return {"tokens": toks, "labels": labels, "loss_mask": mask}

    def prompts_at(self, step: int):
        """(prompt tokens [B, n+1], target digits [B, n]) for generation eval."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 7]))
        n = self.n_digits
        prompts, targets = [], []
        for b in range(self.batch):
            d = rng.integers(0, 10, n)
            prompts.append(np.concatenate([d, [SEP]]))
            targets.append(np.sort(d))
        return np.stack(prompts).astype(np.int32), np.stack(targets).astype(np.int32)


@dataclasses.dataclass
class FormatOnlyTask:
    """Sort-task FORMAT with random-permutation completions.

    Pretraining on this teaches the base model the prompt structure and
    token statistics but NOT the sorting skill — so the subsequent SFT
    delta is small (structure already known) yet decisive (the capability),
    matching the paper's setting where deltas are tiny relative to W_base.
    """
    vocab: int
    seq_len: int
    batch: int
    n_digits: int = 8
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 11]))
        n, B, S = self.n_digits, self.batch, self.seq_len
        toks = np.full((B, S), PAD, np.int32)
        labels = np.full((B, S), PAD, np.int32)
        mask = np.zeros((B, S), np.float32)
        for b in range(B):
            d = rng.integers(0, 10, n)
            completion = rng.permutation(d)     # format yes, skill no
            seq = np.concatenate([d, [SEP], completion, [EOS]])
            toks[b, :len(seq)] = seq
            labels[b, :len(seq) - 1] = seq[1:]
            mask[b, n:len(seq) - 1] = 1.0
        return {"tokens": toks, "labels": labels, "loss_mask": mask}


@dataclasses.dataclass
class PretrainMixture:
    """Base-model data: mostly noise with a little task structure, so the
    base model is distinct from the fine-tuned one (delta is meaningful)."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, 3]))
        B, S = self.batch, self.seq_len
        # Markov-ish token stream: next token = (prev * a + b) % vocab with noise
        toks = np.zeros((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        a = 31
        for t in range(1, S):
            noise = rng.random(B) < 0.15
            nxt = (toks[:, t - 1] * a + 7) % self.vocab
            toks[:, t] = np.where(noise, rng.integers(0, self.vocab, B), nxt)
        return {"tokens": toks.astype(np.int32)}
