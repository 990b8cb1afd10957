"""The round schedules of the star lanes: sync, straggler-simulated sync and
buffered-async (counterpart of ``repro/core/scheduler.py``; its names).

``RoundEngine.run`` hands the host-sampled star lanes to ``RoundScheduler``:

- **sync** (no latency model): a cohort a round, wait for all of it,
  apply. The engine's round as it was, the same numpy draws.
- **sync with a ``LatencyModel``**: the same barrier, but each round is
  charged the slowest observed arrival (``RoundRecord.sim_s``), and the
  clients that drop or miss the deadline are ghosts: their host weight is
  multiplied by 0, so they vanish from the aggregate and the loss.
- **buffered-async** (``AsyncConfig``): FedBuff (Nguyen et al. 2021) with
  FedAsync's staleness discount (Xie et al. 2019) through
  ``ServerStrategy.staleness_scale``. The server keeps ``concurrency``
  updates in flight; whenever ``buffer_k`` of them have arrived it applies
  their aggregate and refills. ``n_rounds`` counts applies.

The async lane splits the round in two engine phases, because a buffer may
mix updates of different dispatches: ``RoundEngine._client_phase`` (batches,
``client_update``, raveled fp32 deltas, per-client losses, raw host weights)
and ``RoundEngine._apply_buffer`` (staleness scale and normalize on the
host, ``fedavg_aggregate``, ``strategy.apply``). The split keeps the sync
round's operations, so the degenerate schedule (``buffer_k == concurrency
== m``, zero latency) gives the sync lane's params bit for bit and its
numpy stream draw for draw; the loss metric is the same weighted sum with
the weights normalized on the host instead of the device (within 3e-7).

An event heap of ``(t_arrival, seq, gid, row, ok)`` orders arrivals; ``seq``
(dispatch order) breaks ties, so simultaneous arrivals resolve the same way
every run. The clock is host bookkeeping: the device work is issued at
dispatch, and the apply's loss read is the one host sync of an apply. The
latency draws come from the ``LatencyModel``'s own stream, never the
engine's, so turning the simulation on leaves the cohorts as they were.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fedavg import sample_clients
from repro_torch.core.latency import LatencyModel


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """The buffered-async lane's two knobs.

    buffer_k:    apply whenever this many updates have arrived (FedBuff's
                 K). ``buffer_k == concurrency`` with a zero
                 ``LatencyModel`` is the degenerate sync schedule.
    concurrency: updates kept in flight. ``None`` takes the engine's cohort
                 size ``max(round(C*K), 1)``: the sync lane's client budget
                 a unit of time, without the barrier.
    """

    buffer_k: int
    concurrency: Optional[int] = None

    def __post_init__(self):
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        if self.concurrency is not None and self.concurrency < self.buffer_k:
            raise ValueError(
                f"concurrency ({self.concurrency}) must be >= buffer_k "
                f"({self.buffer_k}): the buffer could never fill")


class RoundScheduler:
    """Drives one ``run()`` call of a star engine. It holds no state across
    runs: the engine owns params, streams and history; the scheduler the
    event clock."""

    def __init__(self, engine):
        # Behind the engine's own guards: an engine's attributes can be
        # changed after construction, and the async client phase has no
        # codec path, so a codec would be silently dropped.
        if engine.async_config is not None and engine.codec is not None:
            raise ValueError(
                "RoundScheduler cannot run a codec= engine on the buffered-async "
                "schedule: the async client phase ships dense fp32 deltas, so the codec "
                "would be silently ignored; drop codec= or async_config=")
        if engine.topology is not None:
            raise ValueError(
                "RoundScheduler drives the star lanes only: gossip engines (topology=) "
                "run their own mixing schedule; use RoundEngine.run() directly")
        self.engine = engine
        self.model: Optional[LatencyModel] = engine.latency
        self.acfg: Optional[AsyncConfig] = engine.async_config

    # -- sync, with the straggler model when there is one -------------------

    def run_sync(self, n_rounds, eval_every, target_acc, verbose):
        """The per-round barrier loop; with a ``LatencyModel``, each round's
        simulated time and the dropouts' ghost mask as well."""
        from repro_torch.core.engine import RoundRecord

        eng = self.engine
        lat_rng = self.model.init_rng() if self.model is not None else None
        speed = self.model.client_speed(eng.num_clients) if self.model is not None else None
        for i in range(n_rounds):
            t0 = time.perf_counter()
            sim_s = 0.0
            if self.model is None:
                loss = eng._read_loss(eng.round()["loss"])
            else:
                loss, sim_s = self._latency_round(lat_rng, speed)
            rec = RoundRecord(round=eng.round_idx, train_loss=loss,
                              wall_s=time.perf_counter() - t0, sim_s=sim_s)
            # i, not round_idx, for the last round: round_idx counts across
            # run() calls.
            if eng._log(rec, eng.round_idx % eval_every == 0 or i == n_rounds - 1,
                        target_acc, verbose):
                break
        return eng.history

    def _latency_round(self, lat_rng, speed) -> Tuple[float, float]:
        """One barriered round under the straggler model: observed arrival
        times for the cohort, the failures ghost-masked into the host
        weights, the round charged the slowest observed arrival."""
        eng = self.engine
        ids, seed, lr = eng._next_round_inputs()
        t_obs, ok = self.model.draw(lat_rng, np.asarray(ids), speed)
        sim_s = float(t_obs.max()) if len(t_obs) else 0.0
        if not ok.any():
            # Every client failed: no update (an all-zero weight vector would
            # divide 0 by 0). The round happened all the same: it cost sim_s
            # and its draws are spent, so the cohort stream stays in step.
            eng.round_idx += 1
            return float("nan"), sim_s
        arrival = None if ok.all() else ok.astype(np.float32)
        metrics = eng._host_round(ids, seed, lr, arrival=arrival)
        return eng._read_loss(metrics["loss"]), sim_s

    # -- buffered-async -----------------------------------------------------

    def run_async(self, n_rounds, eval_every, target_acc, verbose):
        """FedBuff's loop: ``n_rounds`` server applies, each set off by the
        ``buffer_k``-th arrival among ``concurrency`` updates in flight."""
        from repro_torch.core.engine import RoundRecord

        eng = self.engine
        model = self.model if self.model is not None else LatencyModel()
        K = self.acfg.buffer_k
        m = self.acfg.concurrency or eng._m
        if m > eng.num_clients:
            raise ValueError(
                f"async concurrency {m} exceeds the population ({eng.num_clients} clients)")
        lat_rng = model.init_rng()
        speed = model.client_speed(eng.num_clients)

        heap: List[Tuple[float, int, int, int, bool]] = []
        groups = {}   # gid -> {flat, loss, w, version, live}
        buffer: List[Tuple[int, int]] = []
        state = {"seq": 0, "gid": 0, "in_flight": 0, "now": 0.0}

        def dispatch(width: int):
            """Sample ``width`` fresh clients, run their client phase now on
            the current params, and schedule their arrivals. At the engine's
            cohort width the draw is the sync lane's ``sample_clients``, so
            the degenerate schedule, which dispatches at no other width,
            consumes the numpy stream as the sync lane does."""
            if width <= 0:
                return
            if width == eng._m:
                ids = sample_clients(eng.rng, eng.num_clients, eng.cfg.C)
            else:
                ids = eng.rng.choice(eng.num_clients, size=width, replace=False)
            ids = np.asarray(ids)
            seed = int(eng.rng.integers(2**31))
            flat, per_loss, w = eng._client_phase(ids, seed, eng.lr_at(eng.round_idx))
            t_obs, ok = model.draw(lat_rng, ids, speed)
            gid = state["gid"]
            state["gid"] += 1
            groups[gid] = {"flat": flat, "loss": per_loss, "w": w,
                           "version": eng.round_idx, "live": width}
            for r in range(width):
                heapq.heappush(heap, (state["now"] + float(t_obs[r]), state["seq"], gid, r,
                                      bool(ok[r])))
                state["seq"] += 1
            state["in_flight"] += width

        def release(gid: int):
            groups[gid]["live"] -= 1
            if groups[gid]["live"] == 0:
                del groups[gid]

        def apply_buffer(entries) -> float:
            """Aggregate up to K buffered updates (zero-weight ghost rows pad a
            forced partial apply to K) and step the server; returns the
            buffer's weighted train loss, read back: the apply's one sync."""
            flat = torch.stack([groups[g]["flat"][r] for g, r in entries])
            per_loss = torch.stack([groups[g]["loss"][r] for g, r in entries])
            w = torch.stack([groups[g]["w"][r] for g, r in entries])
            stale = torch.tensor([float(eng.round_idx - groups[g]["version"])
                                  for g, r in entries], dtype=torch.float32)
            pad = K - len(entries)
            if pad:
                flat = torch.cat([flat, flat.new_zeros((pad,) + tuple(flat.shape[1:]))])
                per_loss = torch.cat([per_loss, per_loss.new_zeros(pad)])
                w = torch.cat([w, w.new_zeros(pad)])
                stale = torch.cat([stale, stale.new_zeros(pad)])
            loss = eng._apply_buffer(flat, per_loss, w, stale)
            for g, r in entries:
                release(g)
            eng.round_idx += 1
            return eng._read_loss(loss)

        applies = 0
        last_sim = 0.0
        t0 = time.perf_counter()
        dispatch(m)
        while applies < n_rounds:
            forced_partial = False
            if not heap:
                if buffer:
                    # Everyone else failed and the buffer can never fill:
                    # apply what arrived rather than wait for ever.
                    forced_partial = True
                else:
                    dispatch(m - state["in_flight"])
                    continue
            if not forced_partial:
                t, _, gid, row, ok = heapq.heappop(heap)
                state["now"] = t
                state["in_flight"] -= 1
                if ok:
                    buffer.append((gid, row))
                else:
                    release(gid)
                if len(buffer) < K:
                    continue
            entries, buffer = buffer[:K], []
            loss = apply_buffer(entries)
            applies += 1
            rec = RoundRecord(round=eng.round_idx, train_loss=loss,
                              wall_s=time.perf_counter() - t0, sim_s=state["now"] - last_sim)
            t0 = time.perf_counter()
            last_sim = state["now"]
            if eng._log(rec, eng.round_idx % eval_every == 0 or applies == n_rounds,
                        target_acc, verbose):
                break
            # Refill only while applies remain: a dispatch after the last
            # apply would spend the engine's numpy draws (and a client phase)
            # on a group no one aggregates, and a later run() would leave
            # the degenerate lane out of step with the sync lane.
            if applies < n_rounds:
                dispatch(m - state["in_flight"] - len(buffer))
        return eng.history

