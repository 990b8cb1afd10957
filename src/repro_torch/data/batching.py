"""Client batching, copied from ``repro/data/batching.py``: the static
packing of a client population (``pool_metadata`` .. ``pad_cohort``), one
client's E-epoch batch schedule (``client_epoch_batches``, the host round
assembly of ``core.simulation.build_round_batch_host``), an endless
shuffled iterator and the LM windows of a token sequence.

``pack_clients`` turns per-client ``(x, y)`` arrays into one
``(K, n_pad, ...)`` pool, tiled as ``x[i % n_k]``; ``RoundEngine`` uploads
it to the device once and gathers cohorts from it every round. Counts and
the per-client step schedule ride along for weighting and masking. Every
output is byte-identical to the reference's for the same inputs and seeds
(tested).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


def client_epoch_batches(
    x: np.ndarray,
    y: Optional[np.ndarray],
    batch_size: Optional[int],
    epochs: int,
    seed: int,
):
    """(bx, by) of shapes (n_steps, B, ...) covering E epochs of
    ClientUpdate: ceil(n / B) steps an epoch, each epoch a fresh
    permutation, the ragged final batch filled by resampling within the
    client. ``batch_size=None`` is B = inf: one full batch an epoch."""
    rng = np.random.default_rng(seed)
    n = len(x)
    b = n if batch_size is None else min(batch_size, n)
    steps_per_epoch = -(-n // b) if batch_size is not None else 1
    xs, ys = [], []
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(steps_per_epoch):
            idx = perm[s * b : (s + 1) * b]
            if len(idx) < b:  # ragged tail: resample within client
                extra = rng.integers(0, n, b - len(idx))
                idx = np.concatenate([idx, extra])
            xs.append(x[idx])
            if y is not None:
                ys.append(y[idx])
    bx = np.stack(xs)
    by = np.stack(ys) if y is not None else None
    return bx, by


class PackedClients(NamedTuple):
    """Statically-shaped packing of a whole client population.

    x / y:            (K, n_pad, ...) every client's examples, tiled to the
                      common row budget ``n_pad``.
    counts:           (K,) float32 RAW example counts n_k (server weights).
    steps_per_epoch:  (K,) int32 REAL optimizer steps per epoch,
                      ceil(n_k / B); later steps are masked no-ops.
    batch_size:       static per-step batch size B (== n_pad for B=None).
    max_steps_per_epoch: n_pad // batch_size.
    bucket_sizes:     sorted distinct power-of-two row budgets (diagnostic).
    bucket_of:        (K,) bucket index per client.
    """

    x: Optional[np.ndarray]
    y: Optional[np.ndarray]
    counts: np.ndarray
    steps_per_epoch: np.ndarray
    batch_size: int
    max_steps_per_epoch: int
    bucket_sizes: Tuple[int, ...]
    bucket_of: np.ndarray

    @property
    def num_clients(self) -> int:
        return len(self.counts)

    @property
    def max_real_steps_per_epoch(self) -> int:
        """Largest per-client REAL step count — the engine's step-loop
        length per epoch."""
        return int(self.steps_per_epoch.max())

    def overhead(self) -> float:
        """Padded rows stored per real example (1.0 == no padding)."""
        n_pad = self.max_steps_per_epoch * self.batch_size
        return float(self.num_clients * n_pad / self.counts.sum())


def _next_pow2(v: int) -> int:
    return 1 << (int(v) - 1).bit_length() if v > 0 else 1


def pool_metadata(counts: np.ndarray, batch_size: Optional[int]) -> PackedClients:
    """The data-less half of :func:`pack_clients`: counts, the per-client
    step schedule and the diagnostic shape buckets, with ``x = y = None``."""
    counts = np.asarray(counts, np.int64)
    if not len(counts):
        raise ValueError("need at least one client")
    if batch_size is None:
        steps = np.ones(len(counts), np.int32)
        B = int(counts.max())
        buckets = np.zeros(len(counts), np.int64)
        bucket_sizes = (B,)
        n_pad = B
    else:
        B = int(batch_size)
        # Ceil: the ragged final step is a real (tail + resample-fill) step.
        steps = np.maximum(-(-counts // B), 1).astype(np.int32)
        step_buckets = np.asarray([_next_pow2(int(s)) for s in steps], np.int64)
        bucket_sizes = tuple(sorted(set(int(b) * B for b in step_buckets)))
        buckets = np.searchsorted(np.asarray(bucket_sizes), step_buckets * B)
        n_pad = int(np.ceil(counts.max() / B)) * B
    return PackedClients(
        x=None,
        y=None,
        counts=counts.astype(np.float32),
        steps_per_epoch=steps,
        batch_size=B,
        max_steps_per_epoch=n_pad // B,
        bucket_sizes=bucket_sizes,
        bucket_of=buckets.astype(np.int64),
    )


def estimate_pool_nbytes(
    counts: np.ndarray,
    batch_size: Optional[int],
    x_tail: Tuple[int, ...],
    x_itemsize: int,
    y_tail: Optional[Tuple[int, ...]] = None,
    y_itemsize: int = 0,
) -> int:
    """Bytes the (K, n_pad, ...) pack would allocate, from counts and
    per-example shapes alone, before any array exists."""
    meta = pool_metadata(counts, batch_size)
    n_pad = meta.max_steps_per_epoch * meta.batch_size
    per_row = int(np.prod(x_tail, dtype=np.int64)) * int(x_itemsize)
    if y_tail is not None:
        per_row += int(np.prod(y_tail, dtype=np.int64)) * int(y_itemsize)
    return meta.num_clients * n_pad * per_row


def pack_clients(
    client_data: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
    batch_size: Optional[int],
    *,
    max_bytes: Optional[int] = None,
) -> PackedClients:
    """Pack per-client (x, y) arrays into one statically-shaped population
    of ceil(max n_k / B) * B rows per client.

    ``max_bytes``: refuse populations whose padded pool would exceed this
    budget, before allocating anything."""
    if not len(client_data):
        raise ValueError("pack_clients needs at least one client")
    counts = np.asarray([len(x) for x, _ in client_data], np.int64)
    meta = pool_metadata(counts, batch_size)
    n_pad = meta.max_steps_per_epoch * meta.batch_size
    x0, y0 = client_data[0]
    if max_bytes is not None:
        est = estimate_pool_nbytes(
            counts, batch_size, x0.shape[1:], x0.dtype.itemsize,
            y0.shape[1:] if y0 is not None else None,
            y0.dtype.itemsize if y0 is not None else 0,
        )
        if est > max_bytes:
            raise ValueError(
                f"population exceeds device budget: packing {len(counts)} "
                f"clients at n_pad={n_pad} rows would allocate ~"
                f"{est / 1e6:.0f} MB (> budget {max_bytes / 1e6:.0f} MB). "
                "Use pool='streamed' (RoundEngine(pool='streamed') / "
                "ExecutionSpec(pool='streamed')) to keep the population on "
                "host disk, or raise REPRO_DEVICE_POOL_BUDGET."
            )
    K = len(client_data)
    xs = np.zeros((K, n_pad) + x0.shape[1:], x0.dtype)
    ys = np.zeros((K, n_pad) + y0.shape[1:], y0.dtype) if y0 is not None else None
    for k, (x, y) in enumerate(client_data):
        idx = np.arange(n_pad) % len(x)
        xs[k] = x[idx]
        if ys is not None:
            ys[k] = y[idx]
    return meta._replace(x=xs, y=ys)


def pad_cohort(ids: np.ndarray, multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a cohort to a multiple of ``multiple`` with GHOST clients (id 0,
    validity 0), which carry zero weight in the aggregate and the loss.
    Returns ``(ids_padded, valid)`` with ``valid`` float32 0/1."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    ids = np.asarray(ids)
    pad = (-len(ids)) % multiple
    padded = np.concatenate([ids, np.zeros(pad, ids.dtype)])
    valid = np.ones(len(ids) + pad, np.float32)
    if pad:
        valid[-pad:] = 0.0
    return padded, valid


def batch_iterator(x, y, batch_size, seed=0, drop_last=True):
    """Endless minibatches of (x, y), a fresh permutation every pass."""
    rng = np.random.default_rng(seed)
    n = len(x)
    while True:
        perm = rng.permutation(n)
        for s in range(n // batch_size if drop_last else (n + batch_size - 1) // batch_size):
            idx = perm[s * batch_size : (s + 1) * batch_size]
            yield (x[idx], y[idx] if y is not None else None)


def windows_from_sequence(seq: np.ndarray, unroll: int):
    """Cut a 1-D token array into (n, unroll + 1) windows: inputs
    ``w[:, :-1]``, labels ``w[:, 1:]``, int32 (the paper's unroll is 80 for
    characters, 10 for words). A sequence shorter than one window is tiled
    first."""
    n = (len(seq) - 1) // unroll
    if n <= 0:
        reps = int(np.ceil((unroll + 1) / max(len(seq), 1)))
        seq = np.tile(seq, reps + 1)
        n = (len(seq) - 1) // unroll
    w = np.stack([seq[i * unroll : i * unroll + unroll + 1] for i in range(n)])
    return w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)
