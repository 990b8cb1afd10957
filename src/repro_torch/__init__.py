"""PyTorch port of the FedAvg reproduction, for an NVIDIA H100.

A second package beside the JAX reference ``repro``: same public layouts
(dense ``w`` is (d_in, d_out), conv ``w`` is HWIO, images are NHWC,
parameters are nested dicts with the same keys), same numpy data and
cohort streams, and every TPU kernel on a ported path as a CUDA kernel
written by hand for ``sm_90a`` (``kernels/csrc/*.cu``).

The package imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``; it keeps its own copies of what it needs. Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when the card is
missing — the tests pass ``device="cpu"``.

Layout mirrors ``repro`` so each counterpart is easy to find::

    utils/   tree ravel/unravel in jax.tree leaf order, the weighted tree
             mean, device resolution
    data/    synthetic MNIST stand-in and word corpus, partitions, client
             packing
    configs/ the LM archs' ModelConfigs (a copy of the reference's)
    models/  dense/conv/max-pool primitives, the paper's 2NN and CNN, the
             LM substrate (attention, Mamba, MLP/MoE, TransformerLM)
    core/    losses, FedAvg pieces, codecs, topologies, RoundEngine, evaluation,
             the LM's FedAvg rounds (local_sgd)
    optim/   optimizers and learning-rate schedules
    kernels/ the hand-written CUDA kernels, their build, wrappers, plain
             versions, grad guard and autograd Functions
    launch/  the LM serving and training entry points
"""
