"""One round body, captured once as a CUDA graph and replayed once a round:
the port's counterpart of the reference's superstep scans
(``repro/core/engine.py:1668`` ``_engine_superstep`` and ``:1759``
``_engine_gossip_superstep``).

The body is ``body(params, outer_state, *inputs) -> (params, outer_state,
metrics)``: one round of an engine's lane (the star lanes' cohort round,
the staged round of the streamed pool, the gossip round), every random
number drawn from the one ``torch.Generator`` the engine holds. ``inputs``
are the round's per-replay tensors (its 0-d fp32 ``lr``, its (m,) cohort
ids, its staged rows) and ``metrics`` a tuple of 0-d tensors (the loss, and
on the gossip lane the consensus distance). :class:`RoundGraph` runs r such
rounds from a chunk's inputs, each with a leading (r,) axis. The body is an
argument of each call, so a graph holds no reference back to its engine,
and an engine and its graph are freed as soon as the engine is dropped,
never by the cyclic collector in the middle of another capture, which would
invalidate it:

- on the CPU, eagerly, r calls of the body (:func:`run_eager`);
- on a card, the first call warms the body up and captures it, and every
  round is one ``CUDAGraph.replay()``. The graph owns static buffers (the
  params, the strategy state, one per input, one per metric); the captured
  body ends by copying each output leaf into its input buffer, so each
  replay starts from the last one's result. The host copies round j's
  inputs in (device to device), replays, and copies the metrics out: it
  reads no value, so r rounds make no sync.

Warm-up: cuBLAS and cuDNN set up their handles and pick their algorithms,
and the kernel libraries load, on clones of the buffers and on a side
stream; the generator's state is saved before and restored after, so the
first captured round draws what an eager first round would. The static
inputs start as the first call's round 0, so the warm-up and the capture
index with real cohort ids. The generator is registered with the graph, and
each replay advances it by the round's draws, as an eager round does. The
cyclic collector is off during the capture (``torch.cuda.graph`` runs it
just before), so no other dead graph is destroyed inside it. A capture or
replay that fails raises: there is no eager fallback on a card.

The kernel wrappers' launch counters count the warm-up's launches, which
run; the capture only records launches and the replays run on the card
without the wrappers, so neither adds to a counter. A profiler's kernel
records count the replays' launches.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _copy_into(dst_tree, src_tree) -> None:
    for dst, src in zip(tree_leaves(dst_tree), tree_leaves(src_tree)):
        if dst is not src:
            dst.copy_(src)


def run_eager(body: Callable, params, outer_state, inputs: Sequence[torch.Tensor]):
    """r = len(inputs[0]) eager calls of ``body``, round j on row j of each
    input: (params, outer_state, metrics), each metric stacked to (r,)."""
    rounds = []
    for j in range(inputs[0].shape[0]):
        params, outer_state, metrics = body(params, outer_state, *(x[j] for x in inputs))
        rounds.append(metrics)
    return params, outer_state, tuple(torch.stack(m) for m in zip(*rounds))


class RoundGraph:
    """r rounds of a round body from a (params, outer_state) pair: eager on
    the CPU, one replay a round of a captured graph on a card (module
    docstring). ``gen`` is the generator the body draws from; its device
    decides the path.

    ``programs`` counts the round programs built: the one captured graph on
    a card, the eager body's first run on the CPU; a later call of any r
    adds none. ``warmup_s`` and ``capture_s`` (capture and instantiation)
    are the host seconds of the first call on a card, None before it or on
    the CPU."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.programs = 0
        self.graph = None
        self.warmup_s = None
        self.capture_s = None

    def run(self, body: Callable, params, outer_state,
            inputs: Sequence[torch.Tensor]) -> Tuple:
        """(params, outer_state, metrics) after r = len(inputs[0]) rounds of
        ``body``, all on the generator's device, each metric an (r,) tensor
        that is not read back. On a card ``body`` is called only by the
        first call, which captures it; every later call brings inputs of
        the captured shapes (the engine's are fixed by its cohort size)."""
        if self.gen.device.type != "cuda":
            self.programs = max(self.programs, 1)
            return run_eager(body, params, outer_state, inputs)
        if self.graph is None:
            self._capture(body, params, outer_state, inputs)
        _copy_into(self._params, params)
        _copy_into(self._outer, outer_state)
        r = inputs[0].shape[0]
        out = tuple(torch.empty(r, dtype=m.dtype, device=m.device) for m in self._metrics)
        for j in range(r):
            for static, x in zip(self._inputs, inputs):
                static.copy_(x[j])
            self.graph.replay()
            for o, m in zip(out, self._metrics):
                o[j].copy_(m)
        return _clone(self._params), _clone(self._outer), out

    def _capture(self, body: Callable, params, outer_state, inputs) -> None:
        device = self.gen.device
        self._params = _clone(params)
        self._outer = _clone(outer_state)
        self._inputs = tuple(x[0].clone() for x in inputs)
        t0 = time.perf_counter()
        state = self.gen.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                body(_clone(self._params), _clone(self._outer), *self._inputs)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
        finally:
            self.gen.set_state(state)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                params_out, outer_out, self._metrics = body(self._params, self._outer,
                                                            *self._inputs)
                _copy_into(self._params, params_out)
                _copy_into(self._outer, outer_out)
        finally:
            if collecting:
                gc.enable()
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        self.graph = graph
        self.programs += 1
