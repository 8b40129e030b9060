"""Synthetic token corpora for the end-to-end examples and tests.

Port of ``repro/data/synthetic.py`` (a copy: numpy only, the same tokens
to the bit). A Zipf-ish unigram mixture with short-range repetition so a
small LM has learnable structure (loss decreases visibly within a few
hundred steps).
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(num_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=num_tokens, p=probs).astype(np.int32)
    # inject copy structure: token[i] = token[i-k] for random runs
    n_runs = num_tokens // 64
    starts = rng.integers(8, max(num_tokens - 16, 9), size=n_runs)
    for s in starts:
        L = int(rng.integers(4, 12))
        k = int(rng.integers(1, 8))
        e = min(s + L, num_tokens)
        toks[s:e] = toks[s - k:e - k]
    return toks
