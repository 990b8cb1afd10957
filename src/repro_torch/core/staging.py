"""Host-to-device staging of a streamed cohort (the streamed pool's half of
``RoundEngine``; the reference stages through ``jax.device_put``).

On a card, ``CohortStager`` holds two page-locked host slots, allocated
once at the cohort's shape, and a side ``torch.cuda.Stream``. ``stage``
fills the next slot (``StreamedClientPool.gather`` writes into it) and
copies it to the card with ``non_blocking=True`` on the side stream,
recording an event; ``ready`` makes the compute stream wait on that event
and marks the staged tensors as used there (``record_stream``), so their
memory is not handed back to the side stream while a round still reads
it. A slot is refilled only once its last copy's event has completed, so a
copy in flight never sees its source rewritten. The engine stages round
R+1 right after it has dispatched round R, so the copy runs beside R's
kernels; with two slots, a prefetched cohort and the one being staged
never share a buffer. Every step sits inside ``sanctioned_staging``; no
``torch.cuda.synchronize`` is called.

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
    """One page-locked copy of a cohort's (x, y, n_real, mask), with numpy
    views for the host to fill, and the event of its last copy."""

    def __init__(self, shapes):
        self.host = tuple(
            None if s is None else torch.empty(s[0], dtype=_torch_dtype(s[1]), pin_memory=True)
            for s in shapes)
        self.views = tuple(None if t is None else t.numpy() for t in self.host)
        self.event: Optional[torch.cuda.Event] = None


class CohortStager:
    """Stages cohorts of ``m`` clients of ``pool`` (a ``StreamedClientPool``)
    onto ``device`` (module docstring). ``n_steps`` is the step mask's
    width, E times the steps of an epoch."""

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
        self.stream = self.slots = None
        self._next = 0
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.slots = [_Slot(self.shapes) for _ in range(2)]

    def stage(self, ids, n_real: np.ndarray, mask: np.ndarray):
        """The cohort ``ids``' rows, real-row counts and step mask on the
        device: a tuple of tensors and the event their copy records (None on
        the CPU). Hand both to :meth:`ready` before the round reads them."""
        if self.slots is None:
            x, y = self.pool.gather(ids)
            return (torch.from_numpy(x), None if y is None else torch.from_numpy(y),
                    torch.from_numpy(n_real.astype(np.int64)), torch.from_numpy(mask)), None
        slot = self.slots[self._next]
        self._next ^= 1
        with sanctioned_staging():
            if slot.event is not None:
                slot.event.synchronize()      # the slot's last copy has run
            x, y, nr, mk = slot.views
            self.pool.gather(ids, out=(x, y))
            nr[:] = n_real
            mk[:] = mask
            with torch.cuda.stream(self.stream):
                dev = tuple(None if t is None else t.to(self.device, non_blocking=True)
                            for t in slot.host)
                slot.event = torch.cuda.Event()
                slot.event.record(self.stream)
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
