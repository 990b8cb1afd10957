"""The client population stores (counterpart of ``repro/data/pool.py``).

``pack_clients`` holds the whole population as one ``(K, n_pad, ...)``
array on the device: right at MNIST scale, and capped by device memory.
``StreamedClientPool`` bounds K by host disk instead:

- it writes the clients once into sharded ``.npy`` files
  (``np.lib.format.open_memmap``, ``shard_clients`` clients a shard, each
  shard padded to its own widest client), and ``gather(ids)`` reads a
  cohort back by client id, tiling each client's n_k real rows to the
  global ``n_pad`` with ``pack_clients``' rule ``rows[i % n_k]``: a
  gathered cohort is byte-identical to the device pool's ``x[ids]``, which
  is what makes a streamed round equal a device-pool round bit for bit;
- ``DeviceClientPool`` wraps a ``PackedClients`` under the same ``gather``;
- ``device_pool_budget(device)`` is the threshold ``pool="auto"`` compares
  the packed estimate with.

The metadata (counts, the step schedule, the shape buckets) comes from
``batching.pool_metadata``, the function ``pack_clients`` uses, as a
data-less ``PackedClients``. The builder holds at most one shard of clients
in RAM (``from_generator`` never materializes the population), flushes and
unmaps each shard once written, and ``gather`` reads each client's rows
with one ``os.pread`` through a small LRU of open shard files, so host
memory stays O(shard + cohort). (The reference reads through an LRU of
read-only memmaps. On the H100 machine a mapped shard counted whole in the
process's RSS: 10 rounds of m = 20 over 25 mapped shards of 17 MB grew it
by 397 MB. A read takes only the bytes it asks for.) The stores are numpy
only; ``device_pool_budget`` asks torch for the card's memory.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from collections import OrderedDict
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.batching import (
    PackedClients,
    estimate_pool_nbytes,
    pack_clients,
    pool_metadata,
)

__all__ = [
    "ClientPool",
    "DeviceClientPool",
    "StreamedClientPool",
    "device_pool_budget",
]

# Shard files kept open a pool: bounded, because a population of a million
# clients is ~1000 shard files and holding them all open would exceed the
# default fd limit; an evicted file is reopened on demand, and the page
# cache keeps the hot bytes either way.
_OPEN_SHARD_SLOTS = 64


def device_pool_budget(device: torch.device) -> int:
    """Bytes the packed ``(K, n_pad, ...)`` pool may take on ``device``.

    ``REPRO_DEVICE_POOL_BUDGET`` (bytes) overrides; otherwise 60% of the
    card's total memory as ``torch.cuda.mem_get_info`` reports it, or
    2 GiB on the CPU, which reports no limit."""
    env = os.environ.get("REPRO_DEVICE_POOL_BUDGET", "")
    if env:
        return int(env)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.6)
    return 2 * 1024**3


class ClientPool:
    """Population metadata plus a cohort gather by client id.

    ``meta`` is a data-less ``PackedClients`` (x = y = None); ``gather(ids)``
    returns the cohort's ``(x, y)`` host arrays of shape ``(m, n_pad, ...)``,
    tiled as the device pool stores them."""

    kind: str = "abstract"
    meta: PackedClients
    requested_batch_size: Optional[int]

    @property
    def num_clients(self) -> int:
        return self.meta.num_clients

    @property
    def n_pad(self) -> int:
        return self.meta.max_steps_per_epoch * self.meta.batch_size

    @property
    def counts(self) -> np.ndarray:
        return self.meta.counts

    @property
    def steps_per_epoch(self) -> np.ndarray:
        return self.meta.steps_per_epoch

    @property
    def has_labels(self) -> bool:
        raise NotImplementedError

    def gather(self, ids) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        raise NotImplementedError


class DeviceClientPool(ClientPool):
    """One resident ``pack_clients`` array under the pool interface; ``gather``
    is a numpy take. The engine's device pool gathers on the device; this
    wrapper lets tools compare the two stores through one API."""

    kind = "device"

    def __init__(self, packed: PackedClients, requested_batch_size: Optional[int]):
        self._x = packed.x
        self._y = packed.y
        self.meta = packed._replace(x=None, y=None)
        self.requested_batch_size = requested_batch_size

    @classmethod
    def build(cls, client_data, batch_size,
              max_bytes: Optional[int] = None) -> "DeviceClientPool":
        return cls(pack_clients(client_data, batch_size, max_bytes=max_bytes), batch_size)

    @property
    def has_labels(self) -> bool:
        return self._y is not None

    def gather(self, ids):
        ids = np.asarray(ids)
        return self._x[ids], (self._y[ids] if self._y is not None else None)


class StreamedClientPool(ClientPool):
    """The population in sharded ``.npy`` files on the host's disk (module
    docstring). Build it with :meth:`build` (a list of clients) or
    :meth:`from_generator` (an iterator: the population never exists in host
    RAM at once). ``root=None`` writes to a temporary directory removed with
    the pool; a given ``root`` is kept."""

    kind = "streamed"

    def __init__(self, root: str, meta: PackedClients, shard_clients: int,
                 requested_batch_size: Optional[int],
                 x_dtype, x_tail, y_dtype, y_tail,
                 shard_rows: Sequence[int], owns_root: bool):
        self.root = root
        self.meta = meta
        self.shard_clients = int(shard_clients)
        self.requested_batch_size = requested_batch_size
        self._x_dtype, self._x_tail = np.dtype(x_dtype), tuple(x_tail)
        self._y_dtype = np.dtype(y_dtype) if y_dtype is not None else None
        self._y_tail = tuple(y_tail) if y_tail is not None else None
        self._shard_rows = list(shard_rows)
        self._counts_i = meta.counts.astype(np.int64)
        self._tile = np.arange(self.n_pad)
        self._files: "OrderedDict[str, Tuple[object, int]]" = OrderedDict()
        if owns_root:
            self._cleanup = weakref.finalize(self, shutil.rmtree, root, ignore_errors=True)

    @classmethod
    def build(cls, client_data, batch_size, *, shard_clients: int = 1024,
              root: Optional[str] = None) -> "StreamedClientPool":
        return cls.from_generator(iter(client_data), batch_size,
                                  shard_clients=shard_clients, root=root)

    @classmethod
    def from_generator(
        cls,
        clients: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
        batch_size,
        *,
        shard_clients: int = 1024,
        root: Optional[str] = None,
    ) -> "StreamedClientPool":
        """Write clients into shards, at most ``shard_clients`` of them in RAM
        at once. Each shard pads to its own widest client (the global
        ``n_pad`` exists only once every count is known; ``gather`` tiles to
        it on read) and is flushed and unmapped as soon as it is written."""
        if shard_clients < 1:
            raise ValueError(f"shard_clients must be >= 1, got {shard_clients}")
        owns_root = root is None
        if root is None:
            root = tempfile.mkdtemp(prefix="repro-pool-")
        root = str(root)
        os.makedirs(root, exist_ok=True)

        counts: list = []
        shard_rows: list = []
        buf: list = []
        x_dtype = x_tail = y_dtype = y_tail = None
        shard_idx = 0

        def flush():
            nonlocal shard_idx, buf
            rows = max(len(x) for x, _ in buf)
            mx = np.lib.format.open_memmap(
                os.path.join(root, f"x{shard_idx:05d}.npy"), mode="w+",
                dtype=x_dtype, shape=(len(buf), rows) + x_tail)
            my = None
            if y_dtype is not None:
                my = np.lib.format.open_memmap(
                    os.path.join(root, f"y{shard_idx:05d}.npy"), mode="w+",
                    dtype=y_dtype, shape=(len(buf), rows) + y_tail)
            for j, (x, y) in enumerate(buf):
                mx[j, : len(x)] = x
                if my is not None:
                    my[j, : len(y)] = y
            # Flush and unmap now: the dirty pages go to the page cache
            # instead of staying in this process's RSS for the whole build.
            mx.flush()
            del mx
            if my is not None:
                my.flush()
                del my
            shard_rows.append(rows)
            shard_idx += 1
            buf = []

        for x, y in clients:
            if x_dtype is None:
                x_dtype, x_tail = x.dtype, x.shape[1:]
                y_dtype = y.dtype if y is not None else None
                y_tail = y.shape[1:] if y is not None else None
            if (y is None) != (y_dtype is None):
                raise ValueError("streamed pool: every client must consistently have "
                                 "(or not have) labels")
            counts.append(len(x))
            buf.append((x, y))
            if len(buf) == shard_clients:
                flush()
        if buf:
            flush()
        if not counts:
            raise ValueError("streamed pool needs at least one client")
        meta = pool_metadata(np.asarray(counts, np.int64), batch_size)
        return cls(root, meta, shard_clients, batch_size,
                   x_dtype, x_tail, y_dtype, y_tail, shard_rows, owns_root)

    @property
    def has_labels(self) -> bool:
        return self._y_dtype is not None

    @property
    def num_shards(self) -> int:
        return len(self._shard_rows)

    def row_shapes(self):
        """((x tail, x dtype), (y tail, y dtype) or None): one example's
        shapes and dtypes, what a cohort buffer is allocated from."""
        y = (self._y_tail, self._y_dtype) if self.has_labels else None
        return (self._x_tail, self._x_dtype), y

    def nbytes_on_disk(self) -> int:
        return sum(os.path.getsize(os.path.join(self.root, f)) for f in os.listdir(self.root))

    def estimated_device_nbytes(self) -> int:
        """What the device-resident pack of this population would allocate:
        the number the ``pack_clients`` budget guard compares."""
        return estimate_pool_nbytes(
            self._counts_i, self.requested_batch_size,
            self._x_tail, self._x_dtype.itemsize,
            self._y_tail, self._y_dtype.itemsize if self._y_dtype is not None else 0)

    def _open(self, prefix: str, shard: int):
        """(open file, byte offset of its data) of a shard, through the LRU."""
        name = f"{prefix}{shard:05d}.npy"
        entry = self._files.get(name)
        if entry is None:
            f = open(os.path.join(self.root, name), "rb")
            major, _ = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0 if major == 1
                           else np.lib.format.read_array_header_2_0)
            read_header(f)
            entry = (f, f.tell())
            self._files[name] = entry
            while len(self._files) > _OPEN_SHARD_SLOTS:
                self._files.popitem(last=False)[1][0].close()
        else:
            self._files.move_to_end(name)
        return entry

    def close(self) -> None:
        """Close the shard files the reads hold open (a later read reopens
        them)."""
        while self._files:
            self._files.popitem()[1][0].close()

    def _rows(self, prefix: str, cid: int) -> np.ndarray:
        """Client ``cid``'s n_k real rows of the ``x`` or ``y`` shards, read
        with one ``os.pread`` of exactly their bytes."""
        shard, local = divmod(cid, self.shard_clients)
        tail, dtype = ((self._x_tail, self._x_dtype) if prefix == "x"
                       else (self._y_tail, self._y_dtype))
        row = int(np.prod(tail, dtype=np.int64)) * dtype.itemsize
        n_k = int(self._counts_i[cid])
        f, data = self._open(prefix, shard)
        offset = data + local * self._shard_rows[shard] * row
        buf = os.pread(f.fileno(), n_k * row, offset)
        return np.frombuffer(buf, dtype).reshape((n_k,) + tail)

    def gather(self, ids, out=None) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Cohort rows by client id, tiled to the global ``n_pad`` with
        ``pack_clients``' rule (``rows[i % n_k]``), so the result is
        byte-identical to the device pool's ``x[ids]``. ``out``: an
        ``(x, y)`` pair of arrays of the cohort's shape to fill (a staging
        buffer) instead of fresh ones."""
        ids = np.asarray(ids, np.int64)
        shape = (len(ids), self.n_pad)
        if out is None:
            x = np.empty(shape + self._x_tail, self._x_dtype)
            y = np.empty(shape + self._y_tail, self._y_dtype) if self.has_labels else None
        else:
            x, y = out
            if x.shape != shape + self._x_tail or (y is not None and y.shape[:2] != shape):
                raise ValueError(f"gather's out buffers have shape {x.shape}, the cohort "
                                 f"{shape + self._x_tail}")
        for j, cid in enumerate(ids):
            cid = int(cid)
            if not 0 <= cid < self.num_clients:
                raise IndexError(f"client id {cid} out of range [0, {self.num_clients})")
            tile = self._tile % int(self._counts_i[cid])
            x[j] = self._rows("x", cid)[tile]
            if y is not None:
                y[j] = self._rows("y", cid)[tile]
        return x, y

    def iter_clients(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """The clients back out (real rows only, in order), for tools that
        re-pack or re-shard."""
        for cid in range(self.num_clients):
            yield (self._rows("x", cid).copy(),
                   self._rows("y", cid).copy() if self.has_labels else None)
