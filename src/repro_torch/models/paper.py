"""The five model families of the paper (counterpart of
``repro/models/paper.py``).

1. MNIST 2NN — MLP, 2 hidden layers x 200 ReLU units; 199,210 params.
2. MNIST CNN — 2 conv (32, 64 ch, 5x5, SAME, 2x2 maxpool), FC 512, softmax;
   1,663,370 params.
3. CIFAR CNN — conv64-pool-conv64-pool-FC384-FC192-linear10 on 24x24x3
   crops; 1,068,298 params.
4. Char-LSTM — embed 8, 2 x LSTM 256, softmax over the characters;
   796,672 + 265 * V params (211,592 at the Shakespeare spec's hidden 128,
   V 72).
5. Word-LSTM — embed 192, LSTM 256, projection to 192, output through a
   second (V, 192) embedding; 4,359,120 params at V = 10,000.

Each constructor returns a ``Model(init, apply, loss)``; ``init(seed)``
draws the weights from a CPU ``torch.Generator`` and puts them on the
model's device. Parameter keys, shapes and layouts are the reference's, so
``convert.params_from_numpy`` carries the reference's weights across.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.losses import classification_loss, lm_loss
from repro_torch.models import nn
from repro_torch.utils.device import resolve_device


class Model(NamedTuple):
    init: Callable
    apply: Callable
    loss: Callable


def mnist_2nn(n_classes: int = 10, d_in: int = 784, device="cuda") -> Model:
    dev = resolve_device(device)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        return {
            "fc1": nn.dense_init(g, d_in, 200, dev),
            "fc2": nn.dense_init(g, 200, 200, dev),
            "out": nn.dense_init(g, 200, n_classes, dev),
        }

    def apply(p, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(nn.dense(p["fc1"], x))
        x = torch.relu(nn.dense(p["fc2"], x))
        return nn.dense(p["out"], x)

    return Model(init, apply, classification_loss(apply))


def mnist_cnn(n_classes: int = 10, device="cuda") -> Model:
    dev = resolve_device(device)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        return {
            "conv1": nn.conv2d_init(g, 5, 5, 1, 32, dev),
            "conv2": nn.conv2d_init(g, 5, 5, 32, 64, dev),
            "fc": nn.dense_init(g, 7 * 7 * 64, 512, dev),
            "out": nn.dense_init(g, 512, n_classes, dev),
        }

    def apply(p, x):
        if x.ndim == 2:
            x = x.reshape(-1, 28, 28, 1)
        x = nn.max_pool(torch.relu(nn.conv2d(p["conv1"], x)))
        x = nn.max_pool(torch.relu(nn.conv2d(p["conv2"], x)))
        # NHWC flatten, as the reference's: fc.w rows are (h, w, c)-ordered.
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(nn.dense(p["fc"], x))
        return nn.dense(p["out"], x)

    return Model(init, apply, classification_loss(apply))


def cifar_cnn(n_classes: int = 10, device="cuda") -> Model:
    """The TF deep_cnn tutorial model on 24x24x3 (the paper's crops)."""
    dev = resolve_device(device)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        return {
            "conv1": nn.conv2d_init(g, 5, 5, 3, 64, dev),
            "conv2": nn.conv2d_init(g, 5, 5, 64, 64, dev),
            "fc1": nn.dense_init(g, 6 * 6 * 64, 384, dev),
            "fc2": nn.dense_init(g, 384, 192, dev),
            "out": nn.dense_init(g, 192, n_classes, dev),
        }

    def apply(p, x):
        x = nn.max_pool(torch.relu(nn.conv2d(p["conv1"], x)))
        x = nn.max_pool(torch.relu(nn.conv2d(p["conv2"], x)))
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(nn.dense(p["fc1"], x))
        x = torch.relu(nn.dense(p["fc2"], x))
        return nn.dense(p["out"], x)

    return Model(init, apply, classification_loss(apply))


def _embed(table, tokens):
    """Rows of ``table`` for int ``tokens``: (B, T) -> (B, T, d)."""
    return table[tokens.long()]


def char_lstm(vocab_size: int, embed_dim: int = 8, hidden: int = 256,
              device="cuda") -> Model:
    """Stacked 2-layer character LSTM; tokens (B, T) -> logits (B, T, V)."""
    dev = resolve_device(device)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        return {
            "embed": nn.normal_init(g, (vocab_size, embed_dim), 0.1, dev),
            "lstm1": nn.lstm_init(g, embed_dim, hidden, dev),
            "lstm2": nn.lstm_init(g, hidden, hidden, dev),
            "out": nn.dense_init(g, hidden, vocab_size, dev),
        }

    def apply(p, tokens):
        x = _embed(p["embed"], tokens)
        x = nn.lstm_apply(p["lstm1"], x)
        x = nn.lstm_apply(p["lstm2"], x)
        return nn.dense(p["out"], x)

    return Model(init, apply, lm_loss(apply))


def word_lstm(vocab_size: int = 10_000, embed_dim: int = 192, hidden: int = 256,
              device="cuda") -> Model:
    """Next-word model: separate input and output embeddings of dim 192
    around a 256-unit LSTM and a projection back to 192."""
    dev = resolve_device(device)

    def init(seed: int):
        g = torch.Generator().manual_seed(int(seed))
        return {
            "embed_in": nn.normal_init(g, (vocab_size, embed_dim), 0.05, dev),
            "lstm": nn.lstm_init(g, embed_dim, hidden, dev),
            "proj": nn.dense_init(g, hidden, embed_dim, dev),
            "embed_out": nn.normal_init(g, (vocab_size, embed_dim), 0.05, dev),
            "out_b": torch.zeros((vocab_size,), device=dev),
        }

    def apply(p, tokens):
        x = _embed(p["embed_in"], tokens)
        x = nn.lstm_apply(p["lstm"], x)
        x = nn.dense(p["proj"], x)
        return x @ p["embed_out"].T + p["out_b"]

    return Model(init, apply, lm_loss(apply))
