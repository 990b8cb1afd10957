"""The paper's MNIST models (counterpart of ``repro/models/paper.py``).

1. MNIST 2NN — MLP, 2 hidden layers x 200 ReLU units; 199,210 params.
2. MNIST CNN — 2 conv (32, 64 ch, 5x5, SAME, 2x2 maxpool), FC 512, softmax;
   1,663,370 params.

Each constructor returns a ``Model(init, apply, loss)``; ``init(seed)``
draws the weights from a CPU ``torch.Generator`` and puts them on the
model's device. Parameter keys, shapes and layouts are the reference's, so
``convert.params_from_numpy`` carries the reference's weights across.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.losses import classification_loss
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
