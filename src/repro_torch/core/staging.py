"""Host-to-device staging of a streamed cohort (the streamed pool's half of
``RoundEngine``; the reference stages through ``jax.device_put``).

On a card, ``CohortStager`` holds page-locked host slots, two of each
kind, and a side ``torch.cuda.Stream``. ``stage`` fills the next round slot
(``StreamedClientPool.gather`` writes into it) and copies it to the card
with ``non_blocking=True`` on the side stream, recording an event; ``ready``
makes the compute stream wait on that event and marks the staged tensors as
used there (``record_stream``), so their memory is not handed back to the
side stream while a round still reads it. A slot is refilled only once its
last copy's event has completed, so a copy in flight never sees its source
rewritten. The engine stages round R+1 right after it has dispatched round
R, so the copy runs beside R's kernels; with two slots, a prefetched cohort
and the one being staged never share a buffer. Every step sits inside
``sanctioned_staging``; no ``torch.cuda.synchronize`` is called.

The superstep lane stages a whole chunk at once (``stage_chunk``, the
reference's ``_prepare_chunk``): the rows of its r cohorts in one
(r, m, n_pad, ...) block, from a chunk slot of r rounds' rows (allocated at
the first chunk's r, and again only for a larger r), so a chunk of R pins
``2 * R * rows_nbytes`` host bytes. The round slots are allocated at their
first use, so an engine pins only the kind it stages.

On the CPU the gathered arrays are the staged tensors as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.guards import sanctioned_staging


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One page-locked copy of a cohort's (x, y, n_real, mask), or of a
    chunk's (x, y), with numpy views for the host to fill, and the event of
    its last copy."""

    def __init__(self, shapes):
        self.host = tuple(
            None if s is None else torch.empty(s[0], dtype=_torch_dtype(s[1]), pin_memory=True)
            for s in shapes)
        self.views = tuple(None if t is None else t.numpy() for t in self.host)
        self.event: Optional[torch.cuda.Event] = None
        self.nbytes = sum(t.numel() * t.element_size() for t in self.host if t is not None)

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()      # the slot's last copy has run


class CohortStager:
    """Stages cohorts of ``m`` clients of ``pool`` (a ``StreamedClientPool``)
    onto ``device`` (module docstring). ``n_steps`` is the step mask's
    width, E times the steps of an epoch. ``nbytes`` is what ``stage``
    copies a round, ``rows_nbytes`` a cohort's rows alone (a chunk of r
    copies r of them), ``pinned_nbytes`` the page-locked bytes held now."""

    def __init__(self, pool, m: int, n_steps: int, device: torch.device):
        self.pool = pool
        self.device = device
        (x_tail, x_dtype), y = pool.row_shapes()
        rows = (m, pool.n_pad)
        self.shapes = ((rows + x_tail, x_dtype),
                       None if y is None else (rows + y[0], y[1]),
                       ((m,), np.int64),
                       ((m, n_steps), np.float32))
        self.nbytes = sum(int(np.prod(s[0])) * np.dtype(s[1]).itemsize
                          for s in self.shapes if s is not None)
        self.rows_nbytes = sum(int(np.prod(s[0])) * np.dtype(s[1]).itemsize
                               for s in self.shapes[:2] if s is not None)
        self.stream = self.slots = self.chunk_slots = None
        self._next = self._next_chunk = 0
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)

    @property
    def pinned_nbytes(self) -> int:
        return sum(s.nbytes for s in (self.slots or []) + (self.chunk_slots or []))

    def _copy_up(self, slot: _Slot, host) -> Tuple:
        """``host`` (the slot's tensors, or views of them) on the device,
        copied on the side stream; the slot's event records the copy."""
        with torch.cuda.stream(self.stream):
            dev = tuple(None if t is None else t.to(self.device, non_blocking=True)
                        for t in host)
            slot.event = torch.cuda.Event()
            slot.event.record(self.stream)
        return dev

    def stage(self, ids, n_real: np.ndarray, mask: np.ndarray):
        """The cohort ``ids``' rows, real-row counts and step mask on the
        device: a tuple of tensors and the event their copy records (None on
        the CPU). Hand both to :meth:`ready` before the round reads them."""
        if self.stream is None:
            x, y = self.pool.gather(ids)
            return (torch.from_numpy(x), None if y is None else torch.from_numpy(y),
                    torch.from_numpy(n_real.astype(np.int64)), torch.from_numpy(mask)), None
        if self.slots is None:
            self.slots = [_Slot(self.shapes) for _ in range(2)]
        slot = self.slots[self._next]
        self._next ^= 1
        with sanctioned_staging():
            slot.wait()
            x, y, nr, mk = slot.views
            self.pool.gather(ids, out=(x, y))
            nr[:] = n_real
            mk[:] = mask
            dev = self._copy_up(slot, slot.host)
        return dev, slot.event

    def stage_chunk(self, ids: np.ndarray):
        """The rows of a chunk's cohorts ``ids`` (r, m) on the device: an
        (xs, ys) pair of (r, m, n_pad, ...) tensors and the event their copy
        records (None on the CPU), for :meth:`ready`."""
        r = len(ids)
        if self.stream is None:
            rows = [self.pool.gather(row) for row in ids]
            return tuple(None if rows[0][k] is None else
                         torch.from_numpy(np.stack([g[k] for g in rows]))
                         for k in range(2)), None
        with sanctioned_staging():
            if self.chunk_slots is None or self.chunk_slots[0].host[0].shape[0] < r:
                for s in self.chunk_slots or []:
                    s.wait()
                shapes = tuple(None if s is None else ((r,) + s[0], s[1])
                               for s in self.shapes[:2])
                self.chunk_slots = [_Slot(shapes) for _ in range(2)]
            slot = self.chunk_slots[self._next_chunk]
            self._next_chunk ^= 1
            slot.wait()
            x, y = slot.views
            for j, row in enumerate(ids):
                self.pool.gather(row, out=(x[j], None if y is None else y[j]))
            dev = self._copy_up(slot, tuple(None if t is None else t[:r] for t in slot.host))
        return dev, slot.event

    def ready(self, dev: Tuple, event) -> Tuple:
        """``dev`` for the current stream: it waits on the copy's event, and
        the staged tensors are recorded as used on it."""
        if event is None:
            return dev
        with sanctioned_staging():
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in dev:
                if t is not None:
                    t.record_stream(cur)
        return dev
