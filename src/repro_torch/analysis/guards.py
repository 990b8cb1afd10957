"""Runtime guard rails over the round loop (counterpart of
``repro/analysis/guards.py``).

- :func:`retrace_guard`: a region builds at most ``max_new`` new round
  programs, read from a counter such as ``RoundEngine.num_compilations``
  (captured CUDA graphs on a card).
- :func:`transfer_guard`: on a card, ``torch.cuda.set_sync_debug_mode`` for
  the block, so that an operation that makes the host wait for the device
  (``.item()``, ``float(t)``, ``.tolist()``, a copy from a CUDA tensor to
  the host, ``nonzero``) raises under ``"disallow"``; the previous mode is
  restored on exit. It sees syncs, not transfers: an asynchronous copy from
  pinned host memory passes unseen. On the CPU there is no device to wait
  for and it guards nothing, as the reference's guard admits that device to
  host reads on its CPU backend are never guarded.
- :func:`sanctioned_staging`: the engine's marker for its deliberate host
  and device exchanges (the learning rates a chunk uploads, the losses it
  reads back). Inside the block syncs are allowed, whatever guard is
  around it.

The reference's ``tracer_leak_checks`` and ``tracer_leak_lane_enabled`` have
no counterpart: PyTorch runs eagerly and has no tracers to leak. Its linter
(``repro/analysis/core.py`` and its ``rules_*``) reads JAX code and is not
ported.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

__all__ = ["RetraceError", "retrace_guard", "transfer_guard", "sanctioned_staging"]

# jax.transfer_guard's levels -> torch.cuda.set_sync_debug_mode's.
_SYNC_MODES = {"allow": "default", "log": "warn", "disallow": "error"}


class RetraceError(AssertionError):
    """A guarded region built more round programs than its budget."""


@contextlib.contextmanager
def retrace_guard(counter: Callable[[], int], max_new: int = 0,
                  what: str = "guarded region"):
    """Raise if the region builds more than ``max_new`` NEW round programs.

    ``counter`` is a zero-argument callable returning a count, e.g.
    ``lambda: engine.num_compilations``. ``max_new=0`` is the steady-state
    contract: a warm loop captures nothing new.

        eng.run(2)  # warm-up: the first capture is legitimate
        with retrace_guard(lambda: eng.num_compilations):
            eng.run(20)
    """
    before = counter()
    yield
    after = counter()
    if after - before > max_new:
        raise RetraceError(
            f"{what}: {after - before} new round program(s) "
            f"(budget {max_new}; {before} -> {after}): a shape, dtype or lane is "
            "varying per call")


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    if not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@contextlib.contextmanager
def transfer_guard(mode: str = "disallow"):
    """Scoped ``torch.cuda.set_sync_debug_mode``: ``"disallow"`` (default)
    makes every sync outside a :func:`sanctioned_staging` block raise,
    ``"log"`` warns, ``"allow"`` does nothing. On the CPU it guards
    nothing (module docstring)."""
    if mode not in _SYNC_MODES:
        raise ValueError(f"transfer_guard mode must be one of {sorted(_SYNC_MODES)}, "
                         f"got {mode!r}")
    with _sync_debug_mode(_SYNC_MODES[mode]):
        yield


@contextlib.contextmanager
def sanctioned_staging():
    """Mark a deliberate host and device exchange, and allow it under an
    ambient :func:`transfer_guard`. Keep these blocks tiny: the guard
    proves there are no syncs outside them."""
    with _sync_debug_mode("default"):
        yield
