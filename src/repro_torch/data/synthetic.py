"""Synthetic workloads, drawn with numpy from an integer seed.

Counterpart of `repro.data.synthetic.make_classification`,
`make_lm_stream`, `make_ragged_lm_stream`, `make_qa`, `make_captions` and
`caption_factuality`. The JAX stream
generators use a JAX key only to draw the numpy seed; these take the seed
directly (an int, or a sequence of ints as `numpy.random.default_rng`
accepts), so the same seed gives the same tokens on every machine.
`make_classification`, `make_qa` and `make_captions` keep the JAX
layout, constants and construction but draw their bits with numpy, so
their arrays differ from JAX's for any key; where JAX folds an integer
into a key (``fold_in(key, 5)``), pass the seed ``[seed, 5]``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# Reserved token ids shared by all synthetic vocabularies
PAD, TOK_REDUCE_CONF, TOK_ANSWER_N, TOK_N, BOS, SEP = 0, 1, 2, 3, 4, 5
SYMBOL_BASE = 6


@dataclasses.dataclass
class ClassificationData:
    x: np.ndarray          # [N, d] fp32
    y: np.ndarray          # [N] int32
    is_hard: np.ndarray    # [N] bool — ground-truth difficulty (diagnostics)


def make_classification(seed, n: int, n_classes: int = 16,
                        d_easy: int = 16, factors_per_bit: int = 3,
                        hard_frac: float = 0.45,
                        easy_margin: float = 3.0,
                        noise: float = 1.0,
                        task_seed: int = 1234) -> ClassificationData:
    """C-class task with an easy linear subspace and a hard parity one.

    Easy rows: the class mean, separated by `easy_margin`, plus noise in
    the first `d_easy` dims. Hard rows: those dims are pure noise, and bit
    j of the class is the sign of the product of `factors_per_bit` hard
    dims (magnitudes |N(0, 1)| + 0.5). Rows are ``[x_easy | x_hard]``; on
    easy rows the hard dims are plain N(0, 1). Small MLPs learn the easy
    tier, larger ones on more data the parity tier too.

    The class means come from `task_seed` alone and the samples from
    `seed`, so splits drawn with different seeds share one task."""
    n_bits = int(np.ceil(np.log2(n_classes)))
    d_hard = n_bits * factors_per_bit
    means = np.random.default_rng(task_seed).standard_normal(
        (n_classes, d_easy)) * easy_margin

    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    hard = rng.random(n) < hard_frac
    x_easy = means[y] + rng.standard_normal((n, d_easy)) * noise
    x_easy = np.where(hard[:, None], rng.standard_normal((n, d_easy)) * noise,
                      x_easy)
    bits = (y[:, None] >> np.arange(n_bits)[None, :]) & 1        # [n, bits]
    s = np.sign(rng.standard_normal((n, n_bits, factors_per_bit)))
    s = s + (s == 0)                                             # no zeros
    s[:, :, -1] = np.prod(s[:, :, :-1], axis=-1) * (2 * bits - 1)
    mag = np.abs(rng.standard_normal((n, n_bits, factors_per_bit))) + 0.5
    x_hard = (s * mag).reshape(n, d_hard)
    x_hard = np.where(hard[:, None], x_hard,
                      rng.standard_normal((n, d_hard)))
    x = np.concatenate([x_easy, x_hard], axis=-1)
    return ClassificationData(x.astype(np.float32), y.astype(np.int32), hard)


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


@dataclasses.dataclass
class QAData:
    tokens: np.ndarray       # [N, T] int32, next-token targets = tokens[:,1:]
    answer_pos: int          # index of the answer token
    loss_mask: np.ndarray    # [N, T-1] — 1 where next-token loss applies
    op: np.ndarray           # [N] 0=copy 1=add 2=mul (difficulty)
    n_symbols: int
    vocab: int

    @property
    def inputs(self):
        return self.tokens[:, :-1]

    @property
    def targets(self):
        return self.tokens[:, 1:]


def make_qa(seed, n: int, n_symbols: int = 16,
            op_probs=(0.4, 0.3, 0.3)) -> QAData:
    """Closed-form QA sequences [BOS, op_tok, a, b, c, SEP, ans, PAD]:
    copy -> ans=a; add -> ans=(a+b) mod K; mul -> ans=(a*b+c) mod K.
    The loss applies only where SEP predicts the answer."""
    K = n_symbols
    rng = np.random.default_rng(seed)
    op = rng.choice(3, size=n, p=np.asarray(op_probs, np.float64))
    abc = rng.integers(0, K, size=(n, 3))
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    ans = np.where(op == 0, a, np.where(op == 1, (a + b) % K, (a * b + c) % K))
    toks = np.stack([
        np.full(n, BOS), SYMBOL_BASE + K + op, SYMBOL_BASE + a,
        SYMBOL_BASE + b, SYMBOL_BASE + c, np.full(n, SEP), SYMBOL_BASE + ans,
        np.full(n, PAD)], axis=1).astype(np.int32)
    answer_pos = 6
    mask = np.zeros((n, toks.shape[1] - 1), np.float32)
    mask[:, answer_pos - 1] = 1.0                  # predict ans from SEP
    return QAData(toks, answer_pos, mask, op, K, SYMBOL_BASE + K + 3)


@dataclasses.dataclass
class CaptionData:
    patches: np.ndarray      # [N, P, d_model] fp32 stub vision-frontend output
    tokens: np.ndarray       # [N, T] int32 caption sequence (BOS ...)
    classes: np.ndarray      # [N] latent scene class
    attrs: np.ndarray        # [N] latent attribute
    vocab: int

    @property
    def inputs(self):
        return self.tokens[:, :-1]

    @property
    def targets(self):
        return self.tokens[:, 1:]


def make_captions(seed, n: int, n_patches: int = 8, d_model: int = 64,
                  n_classes: int = 12, n_attrs: int = 6,
                  hard_frac: float = 0.4,
                  task_seed: int = 1234) -> CaptionData:
    """VLM-style captions: patch embeddings = class embedding + 0.5 x
    attribute embedding + noise (std 5.0 on "hard" scenes, which make the
    attribute ambiguous for low-capacity decoders, 0.3 otherwise); the
    caption is ``[BOS, class_tok, attr_tok, SEP]``.

    The class and attribute embeddings come from `task_seed` alone (the
    attributes' from ``[task_seed, 1]``, JAX's ``fold_in(tkey, 1)``) and
    the samples from `seed`, so splits drawn with different seeds share
    one task."""
    cls_emb = np.random.default_rng(task_seed).standard_normal(
        (n_classes, d_model))
    attr_emb = np.random.default_rng([task_seed, 1]).standard_normal(
        (n_attrs, d_model))
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, size=n)
    attr = rng.integers(0, n_attrs, size=n)
    hard = rng.random(n) < hard_frac
    noise_scale = np.where(hard, 5.0, 0.3)[:, None, None]
    patches = (cls_emb[cls][:, None, :] + 0.5 * attr_emb[attr][:, None, :]
               + rng.standard_normal((n, n_patches, d_model)) * noise_scale)
    toks = np.stack([np.full(n, BOS), SYMBOL_BASE + cls,
                     SYMBOL_BASE + n_classes + attr, np.full(n, SEP)],
                    axis=1).astype(np.int32)
    return CaptionData(patches.astype(np.float32), toks, cls.astype(np.int32),
                       attr.astype(np.int32), SYMBOL_BASE + n_classes + n_attrs)


def caption_factuality(pred_tokens: np.ndarray,
                       data: CaptionData) -> np.ndarray:
    """Programmatic stand-in for the paper's factuality judge: a graded
    score in [0, 1] per caption, 0.7 for the right class token
    (``pred_tokens[:, 0]``) plus 0.3 for the right attribute token
    (``pred_tokens[:, 1]``). As in JAX, the attribute tokens' base counts
    the classes as ``data.classes.max() + 1``, so on a split that lacks
    the top class it is shifted; the formula is kept so that both
    packages score the same arrays alike."""
    cls_ok = pred_tokens[:, 0] == SYMBOL_BASE + data.classes
    n_classes = int(data.classes.max()) + 1
    attr_ok = pred_tokens[:, 1] == SYMBOL_BASE + n_classes + data.attrs
    return 0.7 * cls_ok.astype(np.float64) + 0.3 * attr_ok.astype(np.float64)
