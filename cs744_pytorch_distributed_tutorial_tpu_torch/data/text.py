"""Token streams for the LM path: the synthetic cyclic stream and a
byte-level corpus.

The port's own copy of the JAX package's ``data/text.py`` (numpy only):
the same seed gives the same tokens, byte for byte.
"""

from __future__ import annotations

import numpy as np


def synthetic_tokens(
    num_seqs: int,
    seq_len: int,
    vocab_size: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
) -> np.ndarray:
    """[num_seqs, seq_len + 1] int32 tokens (callers split input/target).

    Each sequence walks the vocab with a fixed per-sequence stride, so the
    next token is a deterministic function of the current one, with
    ``noise`` fraction of positions replaced by uniform random tokens.
    """
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab_size, size=num_seqs)
    strides = rng.integers(1, max(vocab_size // 4, 2), size=num_seqs)
    pos = np.arange(seq_len + 1)
    tokens = (starts[:, None] + strides[:, None] * pos[None, :]) % vocab_size
    corrupt = rng.random(tokens.shape) < noise
    tokens = np.where(
        corrupt, rng.integers(0, vocab_size, size=tokens.shape), tokens
    )
    return tokens.astype(np.int32)


BYTE_VOCAB = 256


def byte_corpus(
    path: str,
    seq_len: int,
    *,
    stride: int | None = None,
    max_seqs: int | None = None,
    shuffle: bool = True,
    seed: int = 0,
) -> np.ndarray:
    """Byte-level tokenization of a local file -> [N, seq_len + 1] int32:
    windows of ``seq_len + 1`` bytes every ``stride`` positions (default
    non-overlapping), shuffled with ``seed``. Vocab 256."""
    data = np.fromfile(path, dtype=np.uint8)
    window = seq_len + 1
    if len(data) < window:
        raise ValueError(
            f"corpus {path!r} has {len(data)} bytes < seq_len + 1 = {window}"
        )
    stride = stride or window
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    windows = np.lib.stride_tricks.sliding_window_view(data, window)[::stride]
    tokens = windows.astype(np.int32)
    if shuffle:
        rng = np.random.default_rng(seed)
        tokens = tokens[rng.permutation(len(tokens))]
    else:
        tokens = tokens.copy()
    if max_seqs is not None:
        tokens = tokens[:max_seqs]
    return tokens
