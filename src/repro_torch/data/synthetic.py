"""Synthetic data, copied from ``repro/data/synthetic.py``: the
procedural MNIST/CIFAR stand-in, the role-partitioned character corpus
(the Shakespeare stand-in) and the word-level corpus that ``word_lstm`` and
``launch/train.py`` read their tokens from.

The port keeps its own copy rather than importing ``repro``; for the same
seed its output is byte-identical to the reference (tested).

Images: each class c has a smooth random template T_c; a sample is a
randomly shifted, scaled copy of its template plus Gaussian noise.
Characters: a first-order Markov chain per role, each role's transitions
half a shared base and half one of a few styles, role sizes log-normal (the
paper's unbalanced, non-IID Shakespeare roles). Words: a Zipf vocabulary
and a per-author mixture of topics.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)


def make_image_classification(
    n_train: int = 60_000,
    n_test: int = 10_000,
    *,
    image_shape=(28, 28, 1),
    n_classes: int = 10,
    seed: int = 0,
    difficulty: float = 1.0,
):
    """MNIST-like synthetic image classification: (train, test, templates)
    with NHWC float32 images and int32 labels."""
    rng = np.random.default_rng(seed)
    h, w, ch = image_shape
    low = rng.normal(size=(n_classes, 7, 7, ch)).astype(np.float32)
    templates = np.stack(
        [_upsample(low[c], (h, w)) for c in range(n_classes)], axis=0
    )
    templates /= np.maximum(np.abs(templates).max(axis=(1, 2, 3), keepdims=True), 1e-6)

    def gen(n, rng):
        y = rng.integers(0, n_classes, size=n)
        shifts = rng.integers(-3, 4, size=(n, 2))
        scale = rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        noise = rng.normal(0, 0.35 * difficulty, size=(n, h, w, ch)).astype(np.float32)
        x = np.empty((n, h, w, ch), np.float32)
        for i in range(n):
            x[i] = np.roll(templates[y[i]], tuple(shifts[i]), axis=(0, 1))
        x = x * scale + noise
        return ArrayDataset(x=x, y=y.astype(np.int32))

    return gen(n_train, rng), gen(n_test, rng), templates


def _upsample(img: np.ndarray, hw) -> np.ndarray:
    """Bilinear upsample (h0,w0,c) -> (h,w,c) with numpy only."""
    h0, w0, c = img.shape
    h, w = hw
    yi = np.linspace(0, h0 - 1, h)
    xi = np.linspace(0, w0 - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h0 - 1)
    x1 = np.minimum(x0 + 1, w0 - 1)
    wy = (yi - y0)[:, None, None]
    wx = (xi - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


# The character corpus's alphabet (the Shakespeare stand-in); its size is
# the ``char_lstm`` spec's vocab.
CHAR_VOCAB = (
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ .,;:!?'-\n0123456789"
)
CHAR_VOCAB_SIZE = len(CHAR_VOCAB)  # 72


def make_char_corpus(
    n_roles: int = 1146,
    *,
    mean_chars_per_role: int = 3_110,
    seed: int = 0,
    n_styles: int = 8,
):
    """Per-role int32 character sequences (train, test) and the vocab size.

    Role r draws its text from ``0.5 * base + 0.5 * styles[r % n_styles]``;
    sizes are log-normal around ``mean_chars_per_role`` (at least 64), and
    each role's last 20% is its test text."""
    rng = np.random.default_rng(seed)
    V = CHAR_VOCAB_SIZE
    base = rng.dirichlet(np.full(V, 0.02), size=V).astype(np.float32)
    styles = [
        rng.dirichlet(np.full(V, 0.02), size=V).astype(np.float32)
        for _ in range(n_styles)
    ]

    sizes = rng.lognormal(mean=np.log(mean_chars_per_role), sigma=1.0, size=n_roles)
    sizes = np.maximum(sizes.astype(int), 64)

    train, test = [], []
    for r in range(n_roles):
        style = styles[r % n_styles]
        trans = 0.5 * base + 0.5 * style
        n = int(sizes[r])
        seq = _markov_sample(trans, n, rng)
        split = max(int(0.8 * n), 1)
        train.append(seq[:split])
        test.append(seq[split:] if split < n else seq[-16:])
    return train, test, V


def _markov_sample(trans: np.ndarray, n: int, rng) -> np.ndarray:
    """First-order chain: ``trans`` is (V, V) rows P(next | prev). Each step
    is the reference's ``np.searchsorted(row, u * row[-1])``, walked with
    ``bisect`` on the rows as fp64 lists (the values searchsorted compares
    against its fp64 key), an order of magnitude faster than a numpy call a
    character and the same draws."""
    V = trans.shape[-1]
    out = np.empty(n, np.int32)
    out[0] = rng.integers(V)
    cdf = np.cumsum(trans, axis=-1)
    u = rng.random(n)
    rows = cdf.astype(np.float64).tolist()
    prev, seq = int(out[0]), []
    for ui in u[1:].tolist():
        row = rows[prev]
        prev = bisect.bisect_left(row, ui * row[-1])
        seq.append(prev)
    out[1:] = seq
    return np.minimum(out, V - 1)


def make_word_corpus(
    n_authors: int = 512,
    *,
    vocab_size: int = 10_000,
    mean_words_per_author: int = 1_000,
    n_topics: int = 16,
    seed: int = 0,
):
    """Zipf vocabulary + per-author topic mixture; returns per-author int32
    arrays (train, test) and the vocab size."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
    topics = []
    for _ in range(n_topics):
        boost = np.zeros(vocab_size)
        idx = rng.integers(0, vocab_size, size=vocab_size // 20)
        boost[idx] = rng.uniform(5, 50, size=len(idx))
        p = zipf * (1 + boost)
        topics.append(p / p.sum())
    topics = np.stack(topics)

    sizes = np.maximum(
        rng.lognormal(np.log(mean_words_per_author), 0.8, n_authors).astype(int), 32
    )
    train, test = [], []
    for a in range(n_authors):
        mix = rng.dirichlet(np.full(n_topics, 0.3))
        p = mix @ topics
        seq = rng.choice(vocab_size, size=int(sizes[a]), p=p).astype(np.int32)
        split = max(int(0.8 * len(seq)), 1)
        train.append(seq[:split])
        test.append(seq[split:] if split < len(seq) else seq[-8:])
    return train, test, vocab_size
