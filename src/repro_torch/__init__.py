"""PyTorch port of the FedAvg reproduction, for an NVIDIA H100.

A second package beside the JAX reference ``repro``: same public layouts
(dense ``w`` is (d_in, d_out), conv ``w`` is HWIO, images are NHWC,
parameters are nested dicts with the same keys), same numpy data and
cohort streams, and the server average through a CUDA kernel written by
hand for ``sm_90a`` (``kernels/csrc/fedavg_agg.cu``).

The package imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``; it keeps its own copies of what it needs. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when the card is
missing — the tests pass ``device="cpu"``.

Layout mirrors ``repro`` so each counterpart is easy to find::

    utils/   tree ravel/unravel in jax.tree leaf order, device resolution
    data/    synthetic MNIST stand-in, partitions, client packing
    models/  dense/conv/max-pool primitives, the paper's 2NN and CNN
    core/    losses, FedAvg pieces, strategies, RoundEngine, evaluation
    kernels/ the hand-written CUDA fedavg_aggregate, its build and wrapper
"""
