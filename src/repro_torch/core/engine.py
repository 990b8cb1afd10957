"""RoundEngine: Algorithm 1 over a client population (counterpart of
``repro/core/engine.py``: its plain lane, with ``codec=`` its
compressed-upload lane, and with ``topology=`` its decentralized gossip
lane; ``strategy=`` swaps the server step on the star lanes, ``mesh=``
shards each cohort across a ``torch.distributed`` client group,
``latency=`` simulates stragglers and ``async_config=`` runs the
buffered-async schedule (``core.scheduler``), ``pool=`` keeps the
population on the device or streams it from the host's disk, ``from_spec``
builds an engine from an ``ExperimentSpec``, and ``save``/``restore``
checkpoint it in the reference's layout, so that either package resumes the
other's checkpoints).

One round::

    host                                  device
    rng.choice -> cohort ids (m,)         gather rows        x[ids] -> (m, n_pad, ..)
    rng.integers -> generator seed        per-(client, epoch) sort keys -> permutation
    counts[ids] -> raw weights (m,)       batches            -> (m, E*spe, B, ..)
                                          vmapped ClientUpdate (masked SGD steps)
                                          fp32 deltas -> fedavg_aggregate (CUDA kernel)
                                            or, with a codec: encode -> fused
                                            decode + average (codec's kernel)
                                          strategy.apply -> new global params

The cohort is drawn on the host with the reference's numpy stream, in the
reference's order (``rng.choice`` then ``rng.integers(2**31)``), so the
same seed gives the same cohort ids every round. The integer seeds a
``torch.Generator`` on the engine's device, which draws the batch
permutations: their keys are not the reference's bits (threefry and
Philox differ), so whole runs are compared by accuracy, never bitwise, and
exact checks inject the reference's batches through
``build_simulation_round_step``.

With a codec, the codec's generator is seeded with ``seed ^ 0x5EED``, the
same per-round integer decorrelated from the batch generator (the
reference folds ``0x5EED`` into its round key, ``engine.py:1613``). No
further number is drawn from the host stream, so a codec leaves the cohort
ids unchanged.

Weights come from the host counts, so normalizing them costs no device
sync, and every host array a round needs reaches the card from page-locked
memory without a sync (``ops.host_to_device``); the loop's only per-round
sync is the loss read in ``run``.

The streamed pool (``pool="streamed"``, or ``"auto"`` over the device
budget) keeps the population in ``data.pool.StreamedClientPool``'s shards
on the host's disk. Each round the host draws the cohort as above, reads
its rows from the shards into a page-locked buffer and copies them to the
device on a side stream (``core.staging``); the round then runs the same
permutation and round step on those rows as the device pool runs on its
gathered ones, so the two pools give the same rounds bit for bit. Round
R+1's cohort is drawn and staged right after round R is dispatched
(``prefetch=1``): ``save``, ``restore`` and a round out of turn discard it
and rewind the numpy stream to before its draw. On the superstep lane the
streamed pool stages a whole chunk at once (the reference's
``_prepare_chunk``): the chunk's R cohorts are drawn from the ids
generator (below), their rows read and copied up as one (R, m, n_pad, ...)
block, and the captured round reads round j's rows from it; with
``prefetch`` the next chunk is staged while this one replays, and a ragged
last chunk, ``save`` and ``restore`` discard it and rewind the ids
generator.

The buffered-async schedule splits a round into ``_client_phase`` (a
cohort's batches and ClientUpdate against the current params: raveled fp32
deltas, per-client losses, raw host weights) and ``_apply_buffer`` (the
buffer's weights scaled for staleness and normalized on the host,
``fedavg_aggregate``, ``strategy.apply``); ``core.scheduler`` decides when
each runs.

The gossip lane (``topology=``) has no server and no cohort draw: every
node trains its own packed client (node k is client k) from its own
replica, then one Metropolis-Hastings mixing step through ``gossip_mix``
(CUDA kernel) replaces the aggregate. ``self.params`` is then the
(n_nodes, ...) replica stack; ``consensus_params()`` is their mean. The
reference takes each gossip round's data key off a device PRNG key chain;
here each gossip round draws its (n_nodes, E, n_pad) batch uniforms from
the engine's device generator (seeded with ``cfg.seed``, as on the
superstep lane) and assembles the batches on the device
(``assemble_round_batch``), so a round reads no host value. ``round()`` is
one eager round; ``run(n, rounds_per_step=R)`` with R > 1 runs chunks of R
through the captured round (``core.graphs``), whose replays draw what R
eager rounds draw, so superstep(R) == R x ``round()``. Threefry's bits
cannot be reproduced here, so whole gossip runs are compared with the
reference in a band, and exact checks inject the reference's batches
through ``build_gossip_round_step``. ``run`` reads the loss and the
consensus distance back in one sync a round, or a chunk.

Supersteps (the reference's ``device_sampling=True`` and ``run(...,
rounds_per_step=R)``): the engine holds one ``torch.Generator`` on its
device, seeded with ``cfg.seed``, and a CPU ``torch.Generator`` of the
cohort ids' own, seeded with ``cfg.seed ^ IDS_SEED_SALT``. The host draws a
chunk's R cohorts from the ids generator (``sample_clients_device``) and
uploads them once, beside the R learning rates, without a sync; each round
then draws from the device generator in a fixed order: the batch uniforms
(m, E, n_pad), then the codec's noise (low-rank's sketch seeds included:
the sketch is a pure function of its seed on the device). The counts and
steps per epoch moved to the device at construction, so the weights, the
step mask and the real-row counts come from the device ids, and the round
reads no host value. That round is captured once as a CUDA graph
(``core.graphs``) and replayed once a round, its ids and learning rate
copied into the graph's buffers device to device; the host reads the
chunk's R losses back once. On the CPU the same body runs eagerly. The
cohorts and batches are torch's streams, not threefry's: the same
distributions as the reference's, other realizations.

Cohort sharding (the reference's ``mesh=``, ``engine.py:333-345``): ``mesh``
is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over a client group of
D ranks (``launch.mesh.make_client_mesh``), each holding the whole population
and the replicated params. Every rank draws the whole cohort from the same
stream (the numpy draws on the host-sampled lane, the ids generator's on
the superstep lane), pads it with ghost clients (id 0, weight 0) to a
multiple of D and takes its m/D slots ``[r*m/D, (r+1)*m/D)``
(``core.fedavg.CohortSlice``). Per-client randomness (the batch uniforms,
the codec's noise) is drawn at the whole cohort's shape and sliced
(``core.fedavg.shard_rows``), so each slot gets the numbers the unsharded
round gives it. Each rank launches the lane's aggregation kernel once on its
slice in partial-sum mode, its weights divided by the whole cohort's total
(from the counts of the whole cohort, which every rank drew), and one
``all_reduce(SUM)`` of the fp32 partial sum and the loss's terms finishes
the round. The strategy applies after it, so every rank steps the same
params. On a card, under NCCL, the superstep's captured round holds the
all-reduce; a gloo group cannot be captured. Sharded runs equal unsharded
ones up to fp32 reassociation of the server sum, and a world of one is the
unsharded run bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.guards import sanctioned_staging
from repro_torch.checkpoint.io import (
    latest_step,
    peek_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.compression import (
    Codec,
    build_compressed_round_step,
    codec_generator,
)
from repro_torch.core.fedavg import (
    CohortSlice,
    FedAvgConfig,
    client_update,
    client_update_stacked,
    cohort_size,
    loss_of_terms,
    loss_terms,
    masked_weighted_loss,
    sample_clients,
    sample_clients_device,
    server_aggregate,
    shard_rows,
)
from repro_torch.core.graphs import RoundGraph, run_eager
from repro_torch.core.scheduler import AsyncConfig, RoundScheduler
from repro_torch.core.staging import CohortStager
from repro_torch.core.strategies import FedAvg, ServerStrategy, resolve_strategy
from repro_torch.core.topology import Topology, resolve_topology
from repro_torch.data.batching import estimate_pool_nbytes, pack_clients, pad_cohort
from repro_torch.data.pool import StreamedClientPool, device_pool_budget
from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.ops import host_to_device, normalized_weights
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_ravel_stacked,
    tree_unravel,
    tree_unravel_stacked,
)


# The cohort ids' generator is seeded with ``cfg.seed ^ IDS_SEED_SALT``: on the
# CPU the device generator is an mt19937 seeded with ``cfg.seed`` too, and
# the same seed would make round 1's cohort uniforms its batch uniforms.
IDS_SEED_SALT = 0x1D5C0


class RoundState(NamedTuple):
    """Everything a round mutates: the global params and the strategy's
    server state (``outer_state``); the LM rounds of ``core.local_sgd``
    also thread the per-group inner optimizer state (``inner_state``, last
    here so that ``RoundState(params, outer_state)`` keeps its meaning)."""

    params: Any
    outer_state: Any = None
    inner_state: Any = None


class RoundBatch(NamedTuple):
    """One round's client data.

    data:           tuple of (m, n_steps, B, ...) tensors, ``(x, y)``.
    step_mask:      (m, n_steps) 0/1 float; padded steps are no-ops.
    client_weights: (m,) RAW example counts n_k, on the host or the device;
                    normalized once, inside ``server_aggregate``.
    lr:             client learning rate for this round: a float, or a 0-d
                    fp32 tensor on the device.
    gen:            the ``torch.Generator`` the codec draws its noise from
                    (the reference's ``RoundBatch.key``); the compressed
                    round step needs it, the plain one ignores it.
    cohort:         under cohort sharding, the ``CohortSlice`` these rows
                    are (the codec draws the whole cohort's noise and keeps
                    these rows, and ``total`` spares the all-reduce the
                    weight total); None: the rows are the whole cohort.
    """

    data: Any
    step_mask: torch.Tensor
    client_weights: torch.Tensor
    lr: Any = None
    gen: Optional[torch.Generator] = None
    cohort: Optional[CohortSlice] = None


def _state_hex(gen: torch.Generator) -> str:
    return gen.get_state().numpy().tobytes().hex()


def _state_of_hex(text: str) -> torch.Tensor:
    return torch.frombuffer(bytearray(bytes.fromhex(text)), dtype=torch.uint8)


def build_simulation_round_step(
    loss_fn: Callable,
    *,
    strategy: Optional[ServerStrategy] = None,
    group=None,
):
    """``round_step(state, batch) -> (state, {"loss": ...})``: the vmapped
    ClientUpdate, then the fp32 client deltas through ``server_aggregate``
    (the CUDA ``fedavg_aggregate`` on the card), then ``strategy.apply``.
    The reference's strategy path (``engine.py:153-217``).

    ``group`` (the reference's ``axis_name``): a ``torch.distributed``
    client group whose ranks each hold a slice of the cohort. The kernel then
    runs in partial-sum mode on this rank's slice and one all-reduce of the
    partial sum and the loss's terms finishes both (``total`` from
    ``batch.cohort`` when it has one); ``strategy.apply`` runs after it, so
    every rank returns the same params."""
    strategy = resolve_strategy(strategy)

    def round_step(state: RoundState, rb: RoundBatch):
        client_params, losses = client_update(
            loss_fn, state.params, rb.data, rb.step_mask, rb.lr
        )
        w = torch.as_tensor(rb.client_weights, dtype=torch.float32)
        w_dev = host_to_device(w, losses.device)
        deltas = tree_map(lambda c, p: (c - p).float(), client_params, state.params)
        if group is None:
            loss = masked_weighted_loss(losses, rb.step_mask, w_dev)
            agg_delta = server_aggregate(deltas, w)
        else:
            total = None if rb.cohort is None else rb.cohort.total
            terms = loss_terms(losses, rb.step_mask, w_dev, total)
            agg_delta = server_aggregate(deltas, w, group=group, total=total, carry=terms)
            loss = loss_of_terms(terms)
        outer, new_params = strategy.apply(state.outer_state, state.params, agg_delta)
        return state._replace(params=new_params, outer_state=outer), {"loss": loss}

    return round_step


def build_gossip_round_step(loss_fn: Callable):
    """``gossip_step(stacked, batch, step_mask, counts, idx, weight, lr) ->
    (mixed stacked, {"loss", "consensus"})``: one gossip round on injected
    batches, the reference's ``_engine_gossip_round`` (``engine.py:1724``).

    Node k trains packed client k from replica k (``client_update_stacked``);
    the loss is ``masked_weighted_loss`` over the nodes' real steps, weighted
    by the raw ``counts``; the (n_nodes, N) raveled replicas go through
    ``gossip_mix`` once. ``consensus`` is the RMS over nodes of each mixed
    row's L2 distance to the node mean, in fp32, from the same raveled
    matrix: 0 exactly when all replicas agree."""

    def gossip_step(stacked, batch, step_mask, counts, idx, weight, lr):
        node_params, losses = client_update_stacked(loss_fn, stacked, batch, step_mask, lr)
        w = torch.as_tensor(counts, dtype=torch.float32)
        loss = masked_weighted_loss(losses, step_mask, w.to(losses.device))
        flat, spec = tree_ravel_stacked(node_params)
        mixed = gossip_mix(flat, idx, weight)
        mf = mixed.float()
        center = mf.mean(dim=0, keepdim=True)
        consensus = torch.sqrt(torch.mean(torch.sum((mf - center) ** 2, dim=1)))
        return tree_unravel_stacked(spec, mixed), {"loss": loss, "consensus": consensus}

    return gossip_step


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float
    test_acc: Optional[float] = None
    test_loss: Optional[float] = None
    wall_s: float = 0.0
    # Simulated duration under the scheduler's LatencyModel (0.0 without
    # one): a sync round is charged its slowest observed arrival, an async
    # apply the time since the previous apply. Kept in the reference's
    # field order so that a checkpoint's history loads as is.
    sim_s: float = 0.0
    # Gossip lane only: the post-mix consensus distance (RMS over nodes of
    # each replica's L2 distance to the node mean). None on the star lanes.
    consensus: Optional[float] = None


def _monotone_crossing(curve, target: float) -> Optional[float]:
    """First crossing of ``target`` on a best-so-far-monotone curve of
    (x, acc) points, linearly interpolated between evaluations; a first
    point that already crosses returns its own x."""
    if not curve:
        return None
    best = -np.inf
    mono = []
    for x, acc in curve:
        best = max(best, acc)
        mono.append((x, best))
    prev: Optional[Tuple[float, float]] = None
    for x, acc in mono:
        if acc >= target:
            if prev is None or acc == prev[1]:
                return float(x)
            prev_x, prev_a = prev
            frac = (target - prev_a) / (acc - prev_a)
            return float(prev_x + frac * (x - prev_x))
        prev = (x, acc)
    return None


@dataclasses.dataclass
class History:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)

    def accuracy_curve(self) -> List[Tuple[int, float]]:
        return [(r.round, r.test_acc) for r in self.records if r.test_acc is not None]

    def rounds_to_target(self, target: float) -> Optional[float]:
        """Paper's metric: first crossing of ``target`` on the best-so-far
        accuracy curve, interpolated between evaluated rounds."""
        return _monotone_crossing(self.accuracy_curve(), target)

    def sim_time_to_target(self, target: float) -> Optional[float]:
        """Simulated seconds to first cross ``target``: the metric that tells
        sync from buffered-async under stragglers, where every sync round
        waits on its cohort's slowest client. x: the cumulative ``sim_s``."""
        t, curve = 0.0, []
        for r in self.records:
            t += r.sim_s
            if r.test_acc is not None:
                curve.append((t, r.test_acc))
        return _monotone_crossing(curve, target)


class RoundEngine:
    """Algorithm 1 over a client population.

    With the device pool, construction packs ``client_data`` once
    (``data.batching.pack_clients``) and uploads it to ``device``; each
    ``round()`` draws a cohort on the host and runs gather -> permute ->
    ClientUpdate -> aggregate on the device. ``device`` defaults to
    ``"cuda"`` and raises without a card.

    ``codec`` (``core.compression``) swaps the server step for the
    compressed-upload lane: each client's delta is encoded and the server
    averages the payloads through the codec's fused decode + aggregate.
    ``None`` keeps the plain lane.

    ``topology`` (a ``core.topology`` registry name or ``Topology``) switches
    to the gossip lane: one node per packed client, each with its own
    replica, mixed with its neighbours every round; ``run(n,
    rounds_per_step=R)`` runs its captured superstep (module docstring). It
    needs ``cfg.C == 1.0`` and an identity strategy (FedAvg or FedSGD), and
    takes no codec, no ``device_sampling``, no latency model, no async
    schedule and no streamed pool, as the reference's refusals say.

    ``strategy`` (``core.strategies``: None, a registry name or an instance)
    is the server's update rule over the aggregated fp32 delta; its
    ``validate_cfg`` runs before its state is built, and its state (FedAvgM's
    fp32 velocity) rides in ``outer_state``.

    ``device_sampling=True`` draws every round's cohort from the ids
    generator and its batches and codec noise on the device from the
    engine's generator (module docstring), and ``run(n,
    rounds_per_step=R)`` then runs R rounds a host sync; ``rounds_per_step``
    here is ``run``'s default (the spec's ``execution.rounds_per_step``). It
    takes the plain, FedAvgM and codec lanes (low-rank included) on either
    pool.

    ``latency`` (a ``core.latency.LatencyModel``) simulates stragglers on the
    host-sampled sync lane: each round is charged its slowest observed
    arrival and the clients that fail are ghosts. ``async_config`` (a
    ``core.scheduler.AsyncConfig``) runs the buffered-async schedule
    instead, where ``run(n)`` counts server applies; it takes no codec, no
    device sampling and no ``rounds_per_step`` other than 1.

    ``pool`` picks the population's store: ``"device"`` (packed on the
    device), ``"streamed"`` (``data.pool.StreamedClientPool`` shards of
    ``pool_shard_clients`` clients under ``pool_dir``, or a temporary
    directory; each round's cohort staged to the device), a prebuilt
    ``StreamedClientPool`` (``client_data`` may then be None), or
    ``"auto"``: the device pool while ``estimate_pool_nbytes`` fits
    ``device_pool_budget(device)``, else streamed. ``prefetch`` (0 or more)
    stages the next round's cohort (on the superstep lane the next chunk)
    while the current one runs when it is not 0. The streamed pool runs the
    sync lanes, host-sampled or device-sampled.

    ``mesh`` (a 1-D ``DeviceMesh`` with the dim ``client_axis``, e.g.
    ``launch.mesh.make_client_mesh()``) shards each cohort across the mesh's
    client group (module docstring); every rank of the group builds the
    engine alike and runs it in step. It takes the plain, FedAvgM and codec
    lanes, host-sampled or device-sampled, and refuses ``topology=``, the
    streamed pool, ``latency=`` and ``async_config=``, as the reference
    does; on a card a gloo group takes the host-sampled lane only (its
    all-reduce cannot be captured)."""

    def __init__(
        self,
        loss_fn: Callable,
        init_params,
        client_data: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]],
        cfg: FedAvgConfig,
        eval_fn: Optional[Callable] = None,
        *,
        strategy=None,
        codec: Optional[Codec] = None,
        topology=None,
        device_sampling: bool = False,
        rounds_per_step: Optional[int] = None,
        latency=None,
        async_config: Optional[AsyncConfig] = None,
        pool="auto",
        pool_shard_clients: int = 1024,
        pool_dir=None,
        prefetch: int = 1,
        mesh=None,
        client_axis: str = "clients",
        device="cuda",
    ):
        self._refuse(codec, topology, device_sampling, rounds_per_step, latency,
                     async_config, pool, prefetch, mesh)
        self.device = resolve_device(device)
        self._init_mesh(mesh, client_axis, device_sampling)
        # A private copy: the caller's tensors are never updated.
        self.params = tree_map(
            lambda p: torch.as_tensor(p).to(self.device, copy=True), init_params
        )
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.rng = np.random.default_rng(cfg.seed)
        self.strategy = resolve_strategy(strategy)
        self.strategy.validate_cfg(cfg)
        self.outer_state = self.strategy.init_state(self.params)
        self.round_idx = 0
        self.history = History()
        self.latency = latency
        self.async_config = async_config
        self._prefetch_depth = int(prefetch)
        self._prefetched = None
        self._delta_spec = None
        self.codec = codec
        self.device_sampling = bool(device_sampling)
        self.default_rounds_per_step = rounds_per_step
        # A gossip engine trains every node every round: "auto" resolves to the
        # device pool there (over the budget it raises), as in the reference.
        self._init_pool(client_data, "device" if topology is not None else pool,
                        pool_shard_clients, pool_dir)
        self._m = cohort_size(self.num_clients, cfg.C)
        self._init_cohort_slice()
        self._gen = self._graph = self._ids_gen = None
        if self.device_sampling or topology is not None:
            self._counts = torch.from_numpy(self.packed.counts).to(self.device)
            self._spe = torch.from_numpy(
                self.packed.steps_per_epoch.astype(np.int64)).to(self.device)
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(cfg.seed))
            self._graph = RoundGraph(self._gen)
        if self.device_sampling:
            self._ids_gen = torch.Generator()
            self._ids_gen.manual_seed(int(cfg.seed) ^ IDS_SEED_SALT)
        self.topology: Optional[Topology] = None
        if topology is not None:
            self._init_gossip(loss_fn, resolve_topology(topology))
        elif codec is None:
            self._round_step = build_simulation_round_step(loss_fn, strategy=self.strategy,
                                                           group=self._group)
        else:
            self._round_step = build_compressed_round_step(loss_fn, codec,
                                                           strategy=self.strategy,
                                                           group=self._group)

    @staticmethod
    def _refuse(codec, topology, device_sampling, rounds_per_step, latency, async_config,
                pool, prefetch, mesh=None) -> None:
        """The lane combinations the engine refuses, before any state is built
        (the reference's ``engine.py:392-420``, ``:452-456``, ``:467-520``
        and ``:700-719``). An ``"auto"`` pool that turns out streamed is
        refused with the latency, async and mesh lanes in ``_init_pool``."""
        if mesh is not None:
            if topology is not None:
                raise ValueError(
                    "topology= is incompatible with mesh=: the gossip lane runs every node "
                    "every round (no cohort draw to shard); construct the engine without "
                    "mesh")
            if latency is not None or async_config is not None:
                raise ValueError(
                    "latency=/async_config= are incompatible with mesh=: the straggler and "
                    "buffered-async schedules dispatch unsharded cohorts on the host; "
                    "construct the engine without mesh")
        if device_sampling and topology is not None:
            raise ValueError(
                "topology= is incompatible with device_sampling=True: the gossip lane runs "
                "every node every round (no cohort draw to fuse); construct the engine "
                "without it, and run its superstep with run(n, rounds_per_step=R)")
        if topology is not None and (latency is not None or async_config is not None):
            raise ValueError(
                "topology= is incompatible with latency=/async_config=: the straggler and "
                "buffered-async schedules dispatch against the star lanes; gossip rounds "
                "are a synchronous mixing schedule")
        if topology is not None and not (isinstance(pool, str) and pool in ("auto", "device")):
            raise ValueError(
                "topology= needs the device pool: every node trains every round, so a "
                "streamed pool would stage the whole population each round; use "
                "pool='device'")
        if latency is not None and device_sampling:
            raise ValueError(
                "latency simulation needs the per-round numpy-stream lane: construct the "
                "engine without device_sampling")
        if async_config is not None:
            if codec is not None or device_sampling:
                raise ValueError(
                    "async_config is incompatible with codec=/device_sampling=True: the "
                    "buffered-async lane ships dense fp32 deltas through the split client "
                    "and apply phases on the per-round numpy-stream lane")
            if rounds_per_step not in (None, 1):
                raise ValueError(
                    "async_config replaces the round loop entirely; "
                    f"rounds_per_step={rounds_per_step} has no meaning there")
        if int(prefetch) < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        streamed = isinstance(pool, StreamedClientPool)
        if not streamed and pool not in ("auto", "device", "streamed"):
            raise ValueError("pool must be 'auto', 'device', 'streamed', or a "
                             f"StreamedClientPool instance, got {pool!r}")
        if streamed or pool == "streamed":
            RoundEngine._refuse_streamed(latency, async_config, mesh)

    @staticmethod
    def _refuse_streamed(latency, async_config, mesh=None) -> None:
        if mesh is not None:
            raise ValueError(
                "pool='streamed' is incompatible with mesh= cohort sharding: streamed "
                "cohorts are staged host->device per round, while a sharded round needs "
                "the device-resident pool on every rank of the client group; shard with "
                "pool='device', or stream unsharded")
        if latency is not None or async_config is not None:
            raise ValueError(
                "pool='streamed' supports the sync round lane only: the latency/async "
                "schedulers dispatch against the device-resident pool directly")

    def _init_pool(self, client_data, pool, shard_clients: int, pool_dir) -> None:
        """Resolve ``pool`` and build the store: the packed device pool
        (``self._x``, ``self._y``) or the streamed one (``self.pool``, and a
        ``CohortStager``). ``self.packed`` is the population's metadata."""
        if client_data is not None and any(y is None for _, y in client_data):
            raise ValueError("RoundEngine trains classifiers: every client needs labels")
        kind = "streamed" if isinstance(pool, StreamedClientPool) else pool
        if client_data is None and kind != "streamed":
            raise ValueError("client_data is None: pass the population, or a prebuilt "
                             "StreamedClientPool as pool=")
        if kind == "auto":
            kind = "device"
            if len(client_data):   # pack_clients refuses the empty population
                x0, y0 = client_data[0]
                est = estimate_pool_nbytes(
                    np.asarray([len(x) for x, _ in client_data], np.int64), self.cfg.B,
                    x0.shape[1:], x0.dtype.itemsize, y0.shape[1:], y0.dtype.itemsize)
                if est > device_pool_budget(self.device):
                    kind = "streamed"
                    self._refuse_streamed(self.latency, self.async_config, self.mesh)
        self.pool_kind = kind
        self.pool = self._stager = None
        if kind == "device":
            packed = pack_clients(client_data, self.cfg.B,
                                  max_bytes=device_pool_budget(self.device))
            self._x = torch.from_numpy(packed.x).to(self.device)
            self._y = torch.from_numpy(packed.y).to(self.device)
            # Keep only the metadata on the host, where the host-sampled lane
            # draws its cohort.
            self.packed = packed._replace(x=None, y=None)
            return
        if isinstance(pool, StreamedClientPool):
            if pool.requested_batch_size != self.cfg.B:
                raise ValueError(
                    f"streamed pool was built with batch_size={pool.requested_batch_size} "
                    f"but cfg.B={self.cfg.B}: its step schedule would not match this "
                    "engine's")
            if not pool.has_labels:
                raise ValueError("RoundEngine trains classifiers: every client needs labels")
        else:
            pool = StreamedClientPool.build(client_data, self.cfg.B,
                                            shard_clients=shard_clients, root=pool_dir)
        self.pool = pool
        self.packed = pool.meta
        self._x = self._y = None
        self._stager = CohortStager(
            pool, cohort_size(pool.num_clients, self.cfg.C),
            self.cfg.E * self.packed.max_real_steps_per_epoch, self.device)

    def _init_mesh(self, mesh, client_axis: str, device_sampling: bool) -> None:
        """The client group of ``mesh`` (None: unsharded): its size D and
        this rank's index along ``client_axis`` (the reference's
        ``engine.py:450-456``)."""
        self.mesh, self.client_axis = mesh, client_axis
        self._group, self._shards, self._shard_rank = None, 1, 0
        if mesh is None:
            return
        names = tuple(mesh.mesh_dim_names or ())
        if client_axis not in names:
            raise ValueError(f"client_axis {client_axis!r} not in mesh axes {names}")
        if mesh.ndim != 1:
            raise ValueError(f"mesh= takes a 1-D client mesh, got the {mesh.ndim}-D mesh "
                             f"{names}")
        self._group = mesh.get_group(client_axis)
        self._shards = mesh.size()
        self._shard_rank = mesh.get_local_rank(client_axis)
        backend = dist.get_backend(self._group)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL client group reduces CUDA tensors, but this engine "
                             f"runs on {self.device}: build the mesh with "
                             "make_client_mesh(device='cpu') (gloo)")
        if backend == "gloo" and self.device.type == "cuda" and device_sampling:
            raise ValueError(
                "device_sampling=True on a card captures each round as a CUDA graph, and a "
                "gloo group's all-reduce (through host memory) cannot be captured: build "
                "the mesh with make_client_mesh(device='cuda') (NCCL), or run the "
                "host-sampled lane")

    def _init_cohort_slice(self) -> None:
        """This rank's slots of every cohort (m is fixed by K and C): a
        ``CohortSlice`` without its total, and the slots' 0/1 validity on
        the host and on the device (None unsharded)."""
        self._slots = self._valid = self._valid_dev = None
        if self._group is None:
            return
        _, valid = pad_cohort(np.zeros(self._m, np.int64), self._shards)
        m_local = len(valid) // self._shards
        lo = self._shard_rank * m_local
        self._slots = CohortSlice(self._m, lo, lo + m_local)
        self._valid = torch.from_numpy(valid[lo:lo + m_local])
        self._valid_dev = self._valid.to(self.device)

    def _init_gossip(self, loss_fn: Callable, topology: Topology) -> None:
        """The gossip lane's set-up (the reference's ``engine.py:386-434`` and
        ``:650-664``): refuse what the lane cannot take, build the mixing
        plan on the host, check its rows once, move it to the device, and
        tile the params into the (n_nodes, ...) replica stack."""
        if self.codec is not None:
            raise ValueError(
                "topology= is incompatible with codec=: gossip mixing replaces the "
                "server aggregate entirely, so there is no upload path to compress; "
                "drop the codec, or run the star lane"
            )
        if not isinstance(self.strategy, FedAvg):
            raise ValueError(
                f"topology= is incompatible with the {self.strategy.kind!r} server "
                "strategy: there is no server, the Metropolis-Hastings mixing step "
                "IS the update rule. Use FedAvg/FedSGD (identity)"
            )
        if float(self.cfg.C) != 1.0:
            raise ValueError(
                "topology= requires cfg.C == 1.0 (every node gossips every round; "
                f"there is no cohort sampling), got C={self.cfg.C}"
            )
        n_nodes = self.num_clients
        self.topology = topology
        self.plan = topology.build(n_nodes)
        err = float(np.abs(self.plan.weight.astype(np.float64).sum(axis=1) - 1.0).max())
        if err > 1e-3:
            raise ValueError(
                f"the {topology.kind!r} mixing plan is not row-stochastic: worst row "
                f"off by {err:.6f}"
            )
        self._mix_idx = torch.from_numpy(self.plan.idx).to(self.device)
        self._mix_w = torch.from_numpy(self.plan.weight).to(self.device)
        self._nodes = torch.arange(n_nodes, device=self.device)
        self.params = tree_map(
            lambda p: p.unsqueeze(0).repeat((n_nodes,) + (1,) * p.ndim), self.params
        )
        self._gossip_step = build_gossip_round_step(loss_fn)

    @classmethod
    def from_spec(
        cls,
        spec,
        client_data: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]],
        *,
        loss_fn: Optional[Callable] = None,
        init_params=None,
        eval_fn: Optional[Callable] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        mesh=None,
        device="cuda",
    ) -> "RoundEngine":
        """An engine from a ``repro_torch.specs.ExperimentSpec`` (the
        reference's ``RoundEngine.from_spec``, ``engine.py:746``).

        ``client_data`` stays an argument: a spec describes an experiment,
        not a dataset. ``loss_fn`` and ``init_params`` default to the spec's
        model built on ``device`` (``model_kwargs`` override its fields) and
        initialized from ``spec.fedavg.seed`` by the port's own ``init``,
        whose draws are not the reference's. ``async_spec`` becomes the
        ``AsyncConfig`` and the ``LatencyModel`` (a codec beside it is
        refused), and ``execution``'s pool fields reach the engine.
        ``execution.mesh_axes`` names the client axis: ``mesh`` defaults to
        ``launch.mesh.make_client_mesh(axis=...)`` over the process group's
        world on ``device`` (a world of one when none is up), as the
        reference's ``engine.py:781-786``. A spec field the port has no lane
        for yet is refused before any state is built, naming its ROADMAP
        item."""
        ex = spec.execution
        latency, async_config = None, None
        aspec = spec.async_spec
        if aspec is not None:
            if spec.codec is not None:
                raise ValueError(
                    f"spec {spec.name!r} sets both codec= and async_spec=: the "
                    "buffered-async lane has no codec path, so the run would ship dense "
                    f"fp32 deltas while the spec claims {spec.codec.kind!r} compression; "
                    "drop one of the two fields")
            async_config = AsyncConfig(buffer_k=aspec.buffer_k, concurrency=aspec.concurrency)
            latency = aspec.latency
        if ex.accum_dtype != "float32":
            raise ValueError(
                f"spec {spec.name!r} sets execution.accum_dtype={ex.accum_dtype!r}: the "
                "port's aggregation kernels accumulate in float32 only (a shared gap of "
                "ROADMAP Queue 2)")
        if ex.interpret is not None:
            raise ValueError(
                f"spec {spec.name!r} sets execution.interpret={ex.interpret!r}: the port "
                "has no kernel interpreter; the CPU path is chosen by device='cpu'")
        lane = dict(
            strategy=spec.build_strategy(),
            codec=spec.build_codec(),
            topology=spec.topology.build() if spec.topology is not None else None,
            device_sampling=ex.device_sampling,
            rounds_per_step=ex.rounds_per_step,
            latency=latency,
            async_config=async_config,
            pool=ex.pool,
            pool_shard_clients=ex.pool_shard_clients,
            prefetch=ex.prefetch,
        )
        client_axis = "clients"
        if ex.mesh_axes is not None:
            client_axis = ex.mesh_axes
            if mesh is None:
                from repro_torch.launch.mesh import make_client_mesh

                # what the spec's other fields refuse beside a mesh, refused
                # before a process group starts
                cls._refuse(*(lane[k] for k in ("codec", "topology", "device_sampling",
                                                "rounds_per_step", "latency",
                                                "async_config", "pool", "prefetch")),
                            mesh=ex.mesh_axes)
                mesh = make_client_mesh(axis=ex.mesh_axes, device=resolve_device(device).type)
        if loss_fn is None or init_params is None:
            model = spec.build_model(**{**(model_kwargs or {}), "device": device})
            loss_fn = loss_fn if loss_fn is not None else model.loss
            if init_params is None:
                init_params = model.init(spec.fedavg.seed)
        return cls(loss_fn, init_params, client_data, spec.fedavg, eval_fn, mesh=mesh,
                   client_axis=client_axis, device=device, **lane)

    @property
    def num_clients(self) -> int:
        return self.packed.num_clients

    @property
    def num_compilations(self) -> int:
        """Round programs behind the superstep loops (the reference's jit
        cache sizes, ``engine.py:840``): the one captured CUDA graph on a
        card, whatever R is, a ragged last chunk and (on the star lanes)
        ``round()`` included; on the CPU the eager round body, once a chunk
        has run it. 0 on the host-sampled lanes, which run eagerly and hold
        no graph, and on a gossip engine that has run only eager rounds."""
        return 0 if self._graph is None else self._graph.programs

    def consensus_params(self):
        """The node-mean parameter tree on the gossip lane (fp32 mean over
        the replica axis, cast back to the storage dtype): what evaluation
        reads. Mixing is doubly stochastic, so this mean is the quantity the
        replicas contract toward. A star engine returns ``params`` as they
        are."""
        if self.topology is None:
            return self.params
        return tree_map(lambda p: p.float().mean(dim=0).to(p.dtype), self.params)

    def lr_at(self, rnd: int) -> float:
        """Client lr for round ``rnd``. A callable ``cfg.lr`` is the complete
        round -> lr schedule and is used as it is; ``lr_decay`` applies only
        to a scalar ``cfg.lr``."""
        if callable(self.cfg.lr):
            return float(self.cfg.lr(rnd))
        return float(self.cfg.lr) * self.cfg.lr_decay**rnd

    def _next_round_inputs(self):
        """(cohort ids, generator seed, lr), drawn from the numpy stream in
        the reference's order: ``rng.choice``, then ``rng.integers``."""
        lr = self.lr_at(self.round_idx)
        return (*self._draw_cohort(), lr)

    def _draw_cohort(self):
        """One cohort's (ids, generator seed) from the numpy stream."""
        ids = sample_clients(self.rng, self.num_clients, self.cfg.C)
        return ids, int(self.rng.integers(2**31))

    def save(self, ckpt_dir) -> str:
        """Checkpoint params, the strategy's state, the round counter, the
        cohort stream and the history in the reference's layout and metadata
        (``engine.py:1309``), so either package resumes the other's
        checkpoint. The numpy bit-generator state rides as JSON (its 128-bit
        integers overflow msgpack's ints). ``sample_key`` is what a
        host-sampling reference engine holds, ``jax.random.PRNGKey(seed)``:
        ``[0, seed]`` for a seed below 2**32. A device-sampling or gossip
        engine also writes its device generator's ``get_state()`` bytes as
        hex (``torch_generator_state``) and the generator's device type
        (``torch_generator_device``): the device stream it resumes from; a
        device-sampling engine also its ids generator's
        (``torch_generator_ids_state``). A streamed engine's prefetched
        cohort or chunk is discarded first, its draw rewound, so the
        checkpoint holds the streams an unprefetched run (and a device-pool
        run) would hold. A sharded engine's ranks hold the
        same state: rank 0 writes (recording ``mesh_shards``, D), then every
        rank waits at a barrier of the client group, so a restore that
        follows on any rank finds the files."""
        self._discard_prefetch()
        metadata = {
            "round_idx": self.round_idx,
            "rng_state": json.dumps(self.rng.bit_generator.state),
            "sample_key": [int(self.cfg.seed) >> 32, int(self.cfg.seed) & 0xFFFFFFFF],
            "device_sampling": self.device_sampling,
            "strategy": self.strategy.name,
            "topology": self.topology.name if self.topology is not None else None,
            "history": [dataclasses.asdict(r) for r in self.history.records],
        }
        if self._gen is not None:
            metadata["torch_generator_state"] = _state_hex(self._gen)
            metadata["torch_generator_device"] = self.device.type
        if self._ids_gen is not None:
            metadata["torch_generator_ids_state"] = _state_hex(self._ids_gen)
        if self._group is None:
            return save_checkpoint(
                ckpt_dir, {"params": self.params, "strategy_state": self.outer_state},
                step=self.round_idx, metadata=metadata)
        metadata["mesh_shards"] = self._shards
        path = str(Path(ckpt_dir) / f"step_{self.round_idx:08d}")
        if self._shard_rank == 0:
            path = save_checkpoint(
                ckpt_dir, {"params": self.params, "strategy_state": self.outer_state},
                step=self.round_idx, metadata=metadata)
        dist.barrier(group=self._group)
        return path

    def restore(self, ckpt_dir, step: Optional[int] = None) -> int:
        """Restore what :meth:`save` wrote (either package's) into this
        engine, built with the same population and config; returns the
        restored round index. The step is pinned once, and every guard runs
        on the metadata alone before any state changes: the sampling mode,
        the topology, the device streams (a reference device-sampling or
        gossip checkpoint holds a threefry key, which Philox cannot continue;
        a generator state of another device type; a device-sampling
        checkpoint without the ids generator's state), the strategy, and a
        checkpoint that predates strategies loaded into a stateful one. Leaves land on
        the engine's device in the dtypes it holds. A pending prefetch, drawn
        for the stream before the restore, is discarded first."""
        self._discard_prefetch()
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        meta = peek_metadata(ckpt_dir, step=step)
        recorded_ds = bool(meta.get("device_sampling", False))
        if recorded_ds != self.device_sampling:
            raise ValueError(
                f"checkpoint was written by a device_sampling={recorded_ds} engine but this "
                f"engine has device_sampling={self.device_sampling}: resuming across sampling "
                "modes would silently continue with a different cohort stream")
        rec_topo = meta.get("topology")
        eng_topo = self.topology.name if self.topology is not None else None
        if rec_topo != eng_topo:
            raise ValueError(
                f"checkpoint was written by a topology={rec_topo} engine but this engine "
                f"has topology={eng_topo}: restoring across communication graphs would "
                "silently continue a different mixing process")
        gen_state = ids_state = None
        if self._gen is not None:
            if "torch_generator_state" not in meta:
                lane = "gossip" if self.topology is not None else "device_sampling=True"
                raise ValueError(
                    f"checkpoint was written by the reference's {lane} engine: it carries a "
                    "threefry sample_key and no torch generator state, and Philox cannot "
                    "continue threefry's stream; resume it in the reference, or start this "
                    "engine's device stream afresh")
            gen_device = meta.get("torch_generator_device")
            if gen_device != self.device.type:
                raise ValueError(
                    f"checkpoint's torch generator state is a {gen_device} generator's but "
                    f"this engine draws on {self.device.type}: the two devices' generators "
                    "are different streams, so the run could not continue bit for bit")
            gen_state = _state_of_hex(meta["torch_generator_state"])
        if self._ids_gen is not None:
            if "torch_generator_ids_state" not in meta:
                raise ValueError(
                    "checkpoint predates the cohort ids' own generator (its device-sampling "
                    "engine drew the ids from the device generator): the cohort stream "
                    "could not continue; start this engine afresh")
            ids_state = _state_of_hex(meta["torch_generator_ids_state"])
        recorded = meta.get("strategy")
        if recorded is not None and recorded != self.strategy.name:
            raise ValueError(
                f"checkpoint was written by a {recorded} engine but this engine runs "
                f"{self.strategy.name}: restoring across server strategies would "
                "silently continue a different algorithm")
        if recorded is None:
            # A checkpoint from before strategies holds the params alone.
            if tree_leaves(self.outer_state):
                raise ValueError(
                    "checkpoint predates server strategies (no recorded strategy state) "
                    f"but this engine runs {self.strategy.name}, which carries state: "
                    "resume it with a FedAvg/FedSGD engine instead")
            params, meta = restore_checkpoint(ckpt_dir, self.params, step=step)
        else:
            tree, meta = restore_checkpoint(
                ckpt_dir, {"params": self.params, "strategy_state": self.outer_state},
                step=step)
            params = tree["params"]
            self.outer_state = tree["strategy_state"]
        self.params = params
        self.round_idx = int(meta["round_idx"])
        self.rng.bit_generator.state = json.loads(meta["rng_state"])
        if gen_state is not None:
            self._gen.set_state(gen_state)
        if ids_state is not None:
            self._ids_gen.set_state(ids_state)
        if "history" in meta:
            self.history = History([RoundRecord(**dict(d)) for d in meta["history"]])
        return self.round_idx

    def _permuted_batches(self, xs: torch.Tensor, ys: torch.Tensor, n_real: torch.Tensor,
                          u: torch.Tensor):
        """(bx, by) of a cohort's gathered (m, n_pad, ...) rows ``xs``, ``ys``
        on the device: one draw order per (client, epoch) from the (m, E,
        n_pad) uniforms ``u``. Sorting by ``u + 2*(row >= n_k)`` puts a
        uniform permutation of the client's n_k real rows first and the tiled
        padding rows after, so the active steps (ceil(n_k / B) per epoch) see
        every real example exactly once per epoch. The device pool gathers
        the rows from its resident pack, the streamed pool stages them: the
        same bytes, the same batches."""
        E = self.cfg.E
        spe = self.packed.max_real_steps_per_epoch
        B = self.packed.batch_size
        m, n_pad = xs.shape[:2]
        is_pad = torch.arange(n_pad, device=xs.device) >= n_real[:, None, None]
        perm = torch.argsort(u + 2.0 * is_pad, dim=-1)[:, :, : spe * B]
        perm = perm.reshape(m, E * spe * B)
        rows = torch.arange(m, device=xs.device)[:, None]
        bx = xs[rows, perm].reshape((m, E * spe, B) + tuple(xs.shape[2:]))
        by = ys[rows, perm].reshape((m, E * spe, B) + tuple(ys.shape[2:]))
        return bx, by

    def _batch_uniforms(self, m: int, gen: torch.Generator) -> torch.Tensor:
        n_pad = self.packed.max_steps_per_epoch * self.packed.batch_size
        return torch.rand((m, self.cfg.E, n_pad), generator=gen, device=self.device)

    def _host_mask(self, ids) -> np.ndarray:
        """(m, E * spe) 0/1 step mask of host cohort ``ids``, from the host
        steps per epoch."""
        E, spe = self.cfg.E, self.packed.max_real_steps_per_epoch
        spe_k = self.packed.steps_per_epoch[ids]
        return (np.arange(E * spe)[None, :] % spe < spe_k[:, None]).astype(np.float32)

    def materialize_round_batch(self, ids, generator_seed: int,
                                cohort: Optional[CohortSlice] = None):
        """(batch, step_mask, weights) for host cohort ``ids``, the
        permutations drawn from a device generator seeded with
        ``generator_seed``: the host-sampled lane's batches. The ids, the
        real-row counts and the step mask reach the device from page-locked
        memory without a sync; the weights are the host float32 counts. A
        streamed engine reads the rows from its shards (the round loop
        stages them ahead instead, :meth:`_prepare_round`). With a
        ``cohort`` slice, ``ids`` are this rank's slots (ghosts id 0) and the
        uniforms are the whole cohort's draw cut to them (``shard_rows``)."""
        ids = np.asarray(ids)
        dev = self.device
        counts = self.packed.counts[ids]
        with sanctioned_staging():
            n_real = host_to_device(torch.from_numpy(counts.astype(np.int64)), dev)
            mask = host_to_device(torch.from_numpy(self._host_mask(ids)), dev)
            if self.pool is None:
                idx = host_to_device(torch.from_numpy(ids.astype(np.int64)), dev)
            else:
                x, y = self.pool.gather(ids)
                xs = host_to_device(torch.from_numpy(x), dev)
                ys = host_to_device(torch.from_numpy(y), dev)
        if self.pool is None:
            xs, ys = self._x.index_select(0, idx), self._y.index_select(0, idx)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(generator_seed))
        u = shard_rows(self._batch_uniforms(len(ids) if cohort is None else cohort.m, gen),
                       cohort)
        batch = self._permuted_batches(xs, ys, n_real, u)
        return batch, mask, torch.from_numpy(counts.copy())

    def assemble_round_batch(self, ids: torch.Tensor, u: torch.Tensor, rows=None):
        """(batch, step_mask, weights) for the device cohort ``ids`` (int64)
        and the (m, E, n_pad) uniforms ``u``, all computed on the device from
        the device counts and steps per epoch (the reference's
        ``_assemble_batches``, ``engine.py:1498``): the device-sampling and
        gossip rounds' batches, which read no host value. ``rows``: the
        cohort's (xs, ys) as staged by the streamed pool, else gathered from
        the device pool. For the same ids and uniforms they equal
        :meth:`materialize_round_batch`'s."""
        E, spe = self.cfg.E, self.packed.max_real_steps_per_epoch
        w = self._counts.index_select(0, ids)
        if rows is None:
            rows = (self._x.index_select(0, ids), self._y.index_select(0, ids))
        batch = self._permuted_batches(*rows, w.long(), u)
        spe_k = self._spe.index_select(0, ids)
        steps = torch.arange(E * spe, device=self.device) % spe
        mask = (steps[None, :] < spe_k[:, None]).to(torch.float32)
        return batch, mask, w

    def _device_round(self, params, outer_state, lr, ids, *rows):
        """The device-sampling round body (``core.graphs``): round ``lr`` (0-d
        fp32) on the cohort ``ids`` (m,), the batch uniforms and codec noise
        from the engine's generator, in that order, then the lane's round
        step; the streamed pool passes the cohort's staged ``rows`` (xs,
        ys). Returns (params, outer_state, (loss,)). Sharded, every rank
        takes the whole cohort's ids, draws its uniforms, pads and keeps its
        slots, and the whole cohort's weight total comes from the device
        counts (the reference's ``engine.py:1688-1700``)."""
        gen = self._gen
        u = self._batch_uniforms(self._m, gen)
        cohort = None
        if self._group is not None:
            cohort = self._slots._replace(total=self._counts.index_select(0, ids).sum())
            ids, u = shard_rows(ids, cohort), shard_rows(u, cohort)
        batch, mask, w = self.assemble_round_batch(ids, u, rows or None)
        if cohort is not None:
            w = w * self._valid_dev
        state, metrics = self._round_step(
            RoundState(params, outer_state=outer_state),
            RoundBatch(batch, mask, w, lr=lr, gen=gen, cohort=cohort),
        )
        return state.params, state.outer_state, (metrics["loss"],)

    def _gossip_round(self, stacked, outer_state, lr):
        """The gossip round body (``core.graphs``): every node's batch
        uniforms from the engine's generator, the batches assembled on the
        device for ids ``arange(n_nodes)``, then ClientUpdate from each
        replica and one ``gossip_mix`` (the reference's ``_round_gossip``
        with its data key off the key chain). Returns (replicas,
        outer_state, (loss, consensus))."""
        u = self._batch_uniforms(self.num_clients, self._gen)
        batch, mask, w = self.assemble_round_batch(self._nodes, u)
        stacked, metrics = self._gossip_step(stacked, batch, mask, w, self._mix_idx,
                                             self._mix_w, lr)
        return stacked, outer_state, (metrics["loss"], metrics["consensus"])

    def _round_body(self, params, outer_state, *inputs):
        """The lane's round body for ``core.graphs``."""
        if self.topology is not None:
            return self._gossip_round(params, outer_state, *inputs)
        return self._device_round(params, outer_state, *inputs)

    def round(self) -> Dict[str, torch.Tensor]:
        """One synchronous round; returns {'loss': device scalar}, plus
        'consensus' on the gossip lane, where it is one eager round body. On
        a device-sampling engine it is one replay of the captured round (one
        eager body on the CPU)."""
        if self.topology is not None:
            loss, consensus = self._advance(1, captured=False)
            return {"loss": loss[0], "consensus": consensus[0]}
        if self.device_sampling:
            return {"loss": self._advance(1)[0][0]}
        if self.pool is not None:
            return self._round_streamed()
        return self._host_round(*self._next_round_inputs())

    def _host_round(self, ids, seed: int, lr, arrival: Optional[np.ndarray] = None):
        """The device pool's host-sampled round on cohort ``ids``. ``arrival``
        (m,) 0/1 masks the host weights: the straggler model's ghosts, which
        then vanish from the aggregate and the loss. Sharded, the cohort is
        padded with ghosts and this rank runs its slots, their weights
        masked by validity, with the whole cohort's weight total from the
        host counts (the reference's ``engine.py:902-912`` and
        ``:1570-1590``)."""
        if self._group is None:
            batch, mask, w = self.materialize_round_batch(ids, seed)
            if arrival is not None:
                w = w * torch.from_numpy(arrival)
            return self._step(batch, mask, w, lr, seed)
        padded, _ = pad_cohort(np.asarray(ids), self._shards)
        cohort = self._slots._replace(total=float(self.packed.counts[ids].sum()))
        batch, mask, w = self.materialize_round_batch(padded[cohort.lo:cohort.hi], seed,
                                                      cohort)
        return self._step(batch, mask, w * self._valid, lr, seed, cohort)

    def _step(self, batch, mask, w, lr, seed: int,
              cohort: Optional[CohortSlice] = None) -> Dict[str, torch.Tensor]:
        """The lane's round step on one cohort's batches; the codec's
        generator is seeded with ``seed ^ 0x5EED``."""
        codec_gen = None if self.codec is None else codec_generator(seed ^ 0x5EED, self.device)
        state, metrics = self._round_step(
            RoundState(self.params, outer_state=self.outer_state),
            RoundBatch(batch, mask, w, lr=lr, gen=codec_gen, cohort=cohort),
        )
        self.params, self.outer_state = state.params, state.outer_state
        self.round_idx += 1
        return metrics

    # -- the streamed pool's staging pipeline -------------------------------

    def _rng_snapshot(self):
        return copy.deepcopy(self.rng.bit_generator.state)

    def _discard_prefetch(self) -> None:
        """Drop a staged cohort (or chunk) that was not played and rewind the
        stream it was drawn from to before its draw (the numpy stream, or
        the ids generator on the superstep lane): exact, because nothing
        else drew from that stream since (prepares are sequential)."""
        p = self._prefetched
        if p is None:
            return
        if "ids_gen" in p:
            self._ids_gen.set_state(p["ids_gen"])
        else:
            self.rng.bit_generator.state = p["rng"]
        self._prefetched = None

    def _take_prefetch(self, for_round: int, r: Optional[int] = None):
        """The prefetched cohort if it was staged for ``for_round`` (a chunk:
        and its ``r`` rounds); else none, any other one discarded and its
        draw rewound."""
        p = self._prefetched
        if p is not None and p["for_round"] == for_round and p.get("r") == r:
            self._prefetched = None
            return p
        self._discard_prefetch()
        return None

    def _prepare_round(self, for_round: int):
        """Draw round ``for_round``'s cohort, read its rows from the shards
        and stage them with its real-row counts and step mask
        (``CohortStager``); the stream's state before the draw rides along."""
        snap = self._rng_snapshot()
        ids, seed = self._draw_cohort()
        counts = self.packed.counts[ids]
        dev, event = self._stager.stage(ids, counts, self._host_mask(ids))
        return {"for_round": for_round, "ids": ids, "seed": seed,
                "lr": self.lr_at(for_round), "w": torch.from_numpy(counts.copy()),
                "dev": dev, "event": event, "rng": snap}

    def _round_streamed(self) -> Dict[str, torch.Tensor]:
        """One streamed round: the staged cohort (prefetched, or staged now)
        through the device pool's permutation and round step; then, with
        ``prefetch``, the next round's cohort staged while this one runs."""
        b = self._take_prefetch(self.round_idx) or self._prepare_round(self.round_idx)
        xs, ys, n_real, mask = self._stager.ready(b["dev"], b["event"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(b["seed"])
        batch = self._permuted_batches(xs, ys, n_real, self._batch_uniforms(len(b["ids"]), gen))
        metrics = self._step(batch, mask, b["w"], b["lr"], b["seed"])
        if self._prefetch_depth > 0:
            # The round above is queued, not finished: this draw, shard read
            # and copy overlap its tail on the card.
            self._prefetched = self._prepare_round(self.round_idx)
        return metrics

    def _draw_ids(self, r: int) -> torch.Tensor:
        """The next r rounds' cohorts, (r, m) int64 on the host, from the ids
        generator."""
        return torch.stack([sample_clients_device(self._ids_gen, self.num_clients, self._m)
                            for _ in range(r)])

    def _prepare_chunk(self, for_round: int, r: int):
        """Draw a chunk's r cohorts from the ids generator, read their rows
        from the shards and stage them as one (r, m, n_pad, ...) block
        (``CohortStager.stage_chunk``); the chunk's learning rates and ids
        go up beside them. The ids generator's state before the draw rides
        along (the reference's ``_prepare_chunk``)."""
        snap = self._ids_gen.get_state()
        ids = self._draw_ids(r)
        dev, event = self._stager.stage_chunk(ids.numpy())
        return {"for_round": for_round, "r": r, "inputs": self._upload(for_round, r, ids),
                "dev": dev, "event": event, "ids_gen": snap}

    def _upload(self, for_round: int, r: int, ids: Optional[torch.Tensor] = None):
        """A chunk's (r,) fp32 learning rates from round ``for_round`` on,
        and its (r, m) host ids when it has them, on the device without a
        host wait: the chunk's own host to device copies."""
        with sanctioned_staging():
            lrs = host_to_device(torch.tensor(
                [self.lr_at(for_round + j) for j in range(r)], dtype=torch.float32),
                self.device)
            return (lrs,) if ids is None else (lrs, host_to_device(ids, self.device))

    def _chunk_inputs(self, r: int) -> Tuple[torch.Tensor, ...]:
        """The next r rounds' per-round inputs, each with a leading (r,)
        axis: the learning rates; on the superstep lane the cohort ids; on
        the streamed pool the staged rows (prefetched, or staged now)."""
        if self.topology is not None:
            return self._upload(self.round_idx, r)
        if self.pool is None:
            return self._upload(self.round_idx, r, self._draw_ids(r))
        b = self._take_prefetch(self.round_idx, r) or self._prepare_chunk(self.round_idx, r)
        return b["inputs"] + tuple(self._stager.ready(b["dev"], b["event"]))

    @property
    def staged_bytes(self) -> int:
        """Bytes a streamed round stages host to device (rows, real-row
        counts, step mask; on the superstep lane the rows and the ids); 0 on
        the device pool."""
        if self._stager is None:
            return 0
        if self.device_sampling:
            return self._stager.rows_nbytes + 8 * self._m
        return self._stager.nbytes

    # -- the buffered-async phases (core.scheduler) --------------------------

    def _client_phase(self, ids, seed: int, lr):
        """The dispatch half of a round: ClientUpdate of cohort ``ids``
        against the current params (never changed here). Returns the (width,
        N) raveled fp32 deltas, the (width,) per-client mean losses over the
        real steps (``masked_weighted_loss``'s phrasing) and the (width,) raw
        host weights."""
        batch, mask, w = self.materialize_round_batch(ids, seed)
        client_params, losses = client_update(self.loss_fn, self.params, batch, mask, lr)
        deltas = tree_map(lambda c, p: (c - p).float(), client_params, self.params)
        flat, self._delta_spec = tree_ravel_stacked(deltas)
        per_client = torch.sum(losses * mask, dim=1) / torch.clamp(
            torch.sum(mask, dim=1), min=1.0)
        return flat, per_client, w

    def _apply_buffer(self, flat, per_loss, w, stale) -> torch.Tensor:
        """The server half: the buffer's raw host weights ``w`` scaled by the
        strategy's ``staleness_scale`` of the host server-version gaps
        ``stale``, normalized once on the host (``normalized_weights``, as
        the sync round does, so the degenerate schedule's weights are its
        bits), ``fedavg_aggregate`` (the CUDA kernel on the card),
        ``strategy.apply``. Ghost rows carry w == 0 and vanish from the
        aggregate and the loss. Returns the buffer's weighted loss, on the
        device."""
        w = w * self.strategy.staleness_scale(stale)
        wn = normalized_weights(w, flat.device)
        agg = tree_unravel(self._delta_spec, fedavg_aggregate(flat, wn))
        self.outer_state, self.params = self.strategy.apply(self.outer_state, self.params, agg)
        return torch.sum(wn * per_loss)

    def _advance(self, r: int, captured: bool = True) -> Tuple[torch.Tensor, ...]:
        """r rounds of the lane's round body (the superstep lane's, the
        gossip lane's), through the round graph, or eagerly when not
        ``captured``; the (r,) metrics stay on the device. A streamed
        engine with ``prefetch`` stages the next chunk of r while these
        rounds run."""
        inputs = self._chunk_inputs(r)
        run = self._graph.run if captured else run_eager
        self.params, self.outer_state, metrics = run(
            self._round_body, self.params, self.outer_state, inputs)
        self.round_idx += r
        if self._stager is not None and self._prefetch_depth > 0:
            # The chunk above is queued, not finished: this draw, shard read
            # and copy overlap its replays on the card.
            self._prefetched = self._prepare_chunk(self.round_idx, r)
        return metrics

    def _superstep(self, r: int) -> Tuple[np.ndarray, ...]:
        """Advance r captured rounds with one host sync (the reference's
        ``engine.py:1120``); returns the (r,) losses, and on the gossip lane
        the (r,) consensus distances, read back once."""
        metrics = self._advance(r)
        with sanctioned_staging():
            return tuple(torch.stack(metrics).cpu().numpy())

    def _resolve_rounds_per_step(self, rounds_per_step, n_rounds: int,
                                 eval_every: int) -> int:
        """The reference's ``engine.py:1092`` and ``:1255``: ``None`` takes the
        engine's default, then auto-selects: a host-sampled or gossip engine
        runs a round a step; a device-sampling one a chunk per evaluation
        (``eval_every``) with an ``eval_fn``, else the whole run."""
        if rounds_per_step is None:
            rounds_per_step = self.default_rounds_per_step
        if rounds_per_step is None:
            if not self.device_sampling:
                return 1
            return max(1, int(eval_every)) if self.eval_fn is not None \
                else max(1, int(n_rounds))
        R = int(rounds_per_step)
        if R < 1:
            raise ValueError(f"rounds_per_step must be >= 1, got {rounds_per_step}")
        if R > 1 and self.async_config is not None:
            raise ValueError(
                "async_config replaces the round loop entirely; "
                f"rounds_per_step={rounds_per_step} has no meaning there")
        if R > 1 and not self.device_sampling and self.topology is None:
            raise ValueError(
                "rounds_per_step > 1 needs RoundEngine(device_sampling=True): the "
                "superstep draws its cohorts on the device from the engine's generator, "
                "which this engine's numpy stream cannot feed without a host sync a round")
        return R

    def run(
        self,
        n_rounds: int,
        eval_every: int = 1,
        target_acc: Optional[float] = None,
        verbose: bool = False,
        rounds_per_step: Optional[int] = None,
    ) -> History:
        """Run ``n_rounds`` of Algorithm 1, evaluating every ``eval_every``
        rounds and after the last; stop early once ``target_acc`` is met.
        Each record's ``wall_s`` ends at the synced loss read. On the gossip
        lane each record also carries the consensus distance, read in the
        same sync as the loss, and evaluation sees ``consensus_params()``;
        ``rounds_per_step=R`` > 1 runs it in captured chunks of R, as the
        superstep lane below (the reference's ``_run_gossip``).

        The host-sampled star lanes run in ``core.scheduler``: without a
        latency model the plain sync schedule, with ``latency=`` the
        straggler-simulated one (records gain ``sim_s``), with
        ``async_config=`` the buffered-async one, where ``n_rounds`` counts
        server applies.

        A device-sampling engine runs chunks of ``rounds_per_step=R`` rounds
        (``None`` auto-selects, :meth:`_resolve_rounds_per_step`), one host
        sync a chunk: evaluation and ``target_acc`` then act at chunk
        boundaries (an eval whenever a chunk crosses an eval point, so the
        target overshoots by at most R - 1 rounds), and each round's
        ``wall_s`` is the chunk's time / r."""
        if int(eval_every) < 1:
            raise ValueError(
                f"eval_every must be >= 1, got {eval_every} (use a large "
                "eval_every, not 0, to evaluate only at the end)"
            )
        if target_acc is not None and self.eval_fn is None:
            raise ValueError(
                "run(target_acc=...) needs an eval_fn to measure accuracy"
            )
        R = self._resolve_rounds_per_step(rounds_per_step, n_rounds, eval_every)
        if self.topology is not None and R == 1:
            return self._run_gossip(n_rounds, eval_every, target_acc, verbose)
        if self.async_config is not None:
            return RoundScheduler(self).run_async(n_rounds, eval_every, target_acc, verbose)
        if self.device_sampling or self.topology is not None:
            return self._run_supersteps(n_rounds, R, eval_every, target_acc, verbose)
        return RoundScheduler(self).run_sync(n_rounds, eval_every, target_acc, verbose)

    def _run_gossip(self, n_rounds, eval_every, target_acc, verbose) -> History:
        """The gossip lane's eager round loop (R = 1): the loss and the
        consensus distance read back in one sync a round."""
        for i in range(n_rounds):
            t0 = time.perf_counter()
            metrics = self.round()
            with sanctioned_staging():
                loss, consensus = torch.stack(
                    [metrics["loss"], metrics["consensus"]]).tolist()
            rec = RoundRecord(round=self.round_idx, train_loss=loss,
                              wall_s=time.perf_counter() - t0, consensus=consensus)
            if self._log(rec, self.round_idx % eval_every == 0 or i == n_rounds - 1,
                         target_acc, verbose):
                break
        return self.history

    def _run_supersteps(self, n_rounds, R, eval_every, target_acc, verbose) -> History:
        """The reference's ``_run_supersteps`` (``engine.py:1203``) and, on
        the gossip lane, its chunked ``_run_gossip`` (``:1246``): each
        gossip record carries its round's consensus distance."""
        done = 0
        while done < n_rounds:
            r = min(R, n_rounds - done)
            t0 = time.perf_counter()
            losses, *consensus = self._superstep(r)
            chunk_s = time.perf_counter() - t0
            done += r
            for j in range(r):
                self.history.records.append(RoundRecord(
                    round=self.round_idx - r + j + 1, train_loss=float(losses[j]),
                    wall_s=chunk_s / r,
                    consensus=float(consensus[0][j]) if consensus else None))
            crossed = self.round_idx // eval_every > (self.round_idx - r) // eval_every
            if self.eval_fn is not None and (crossed or done >= n_rounds):
                acc = self._evaluate(self.history.records[-1], verbose)
                if target_acc is not None and acc >= target_acc:
                    break
        return self.history

    @staticmethod
    def _read_loss(loss: torch.Tensor) -> float:
        """A round's or an apply's loss read back to the host: the loop's one
        sanctioned sync."""
        with sanctioned_staging():
            return float(loss)

    def _log(self, rec: RoundRecord, evaluate: bool, target_acc, verbose) -> bool:
        """Append ``rec`` to the history and, when ``evaluate`` and there is
        an ``eval_fn``, evaluate into it; True once ``target_acc`` is met."""
        self.history.records.append(rec)
        if not evaluate or self.eval_fn is None:
            return False
        acc = self._evaluate(rec, verbose)
        return target_acc is not None and acc >= target_acc

    def _evaluate(self, rec: RoundRecord, verbose: bool) -> float:
        """``eval_fn`` on ``consensus_params()`` into ``rec``; returns the
        accuracy. Evaluation reads its result back: a sanctioned sync."""
        with sanctioned_staging():
            ev = self.eval_fn(self.consensus_params())
            rec.test_acc = float(ev["acc"])
            rec.test_loss = float(ev.get("loss", np.nan))
        if verbose:
            cons = "" if rec.consensus is None else f"consensus {rec.consensus:.2e} "
            sim = f"sim_s {rec.sim_s:.3f} " if rec.sim_s else ""
            print(f"round {self.round_idx:5d} {sim}loss {rec.train_loss:.4f} "
                  f"{cons}test_acc {rec.test_acc:.4f}")
        return rec.test_acc
