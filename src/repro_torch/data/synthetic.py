"""Synthetic serving workloads, drawn with numpy from an integer seed.

Counterpart of `repro.data.synthetic.make_lm_stream` and
`make_ragged_lm_stream`. The JAX versions use a JAX key only to draw the
numpy seed; these take the seed directly (an int, or a sequence of ints as
`numpy.random.default_rng` accepts), so the same seed gives the same
tokens on every machine. The classification, QA and caption generators
serve training and are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

from typing import List

import numpy as np


def make_lm_stream(seed, n_seqs: int, seq_len: int, vocab: int) -> np.ndarray:
    """Zipf-initialized Markov-chain token stream [n_seqs, seq_len] int32:
    cheap to sample, non-trivial to model (a small hidden state machine
    emitting tokens, plus a Zipf unigram mix)."""
    rng = np.random.default_rng(seed)
    V = vocab
    zipf = 1.0 / np.arange(1, V + 1)
    zipf /= zipf.sum()
    n_states = 64
    state_next = rng.integers(0, n_states, size=(n_states, 8))
    state_emit = rng.permutation(V)[:n_states * 8].reshape(n_states, 8) \
        if V >= n_states * 8 else rng.integers(0, V, size=(n_states, 8))
    out = np.empty((n_seqs, seq_len), np.int32)
    state = rng.integers(0, n_states, size=n_seqs)
    for t in range(seq_len):
        branch = rng.integers(0, 8, size=n_seqs)
        zipf_mask = rng.random(n_seqs) < 0.15
        tok = state_emit[state, branch]
        tok[zipf_mask] = rng.choice(V, size=zipf_mask.sum(), p=zipf)
        out[:, t] = tok
        state = state_next[state, branch]
    return out


def make_ragged_lm_stream(seed, n_seqs: int, len_min: int, len_max: int,
                          vocab: int) -> List[np.ndarray]:
    """`n_seqs` prompts with lengths uniform in [len_min, len_max]
    (inclusive), token content from `make_lm_stream`. Returns a list of
    1-D int32 arrays (feed to `serving.make_requests`)."""
    if not 1 <= len_min <= len_max:
        raise ValueError("need 1 <= len_min <= len_max")
    base = make_lm_stream(seed, n_seqs, len_max, vocab)
    lens = np.random.default_rng([*np.atleast_1d(seed), 1]).integers(
        len_min, len_max + 1, size=n_seqs)
    return [base[i, :lens[i]].astype(np.int32) for i in range(n_seqs)]
