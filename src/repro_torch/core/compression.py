"""Client-update compression: the compressed-upload lane (counterpart of
``repro/core/compression.py``).

Codecs are statically shaped transforms over the raveled client deltas.
The reference writes each codec for one client and vmaps it; here the
client axis is written out: ``encode`` takes the (m, n) stack of fp32
deltas and returns a payload dict whose leaves carry a leading client axis,
and ``decode`` maps such a stack back to (m, n). One compressed round is::

    ClientUpdate -> ravel deltas (m, n) -> encode -> decode+aggregate -> apply

``decode_aggregate`` averages the payloads with RAW count weights. The
quantize codec fuses decode into the CUDA ``quantized_aggregate`` (or its
bit-packed twin), the top-k codec into the CUDA ``sparse_aggregate``; the
identity and mask codecs decode and go through ``fedavg_aggregate``; the
low-rank codec is one ``einsum``.

Noise: ``encode(gen, flat, cohort=None)`` draws every random number the
codec needs from the ``torch.Generator`` ``gen``, then calls a noise-free
core that
takes the noise as an argument (the uniform draw for quantize, the
Bernoulli mask for mask, the Gaussian sketch for low-rank). The cores are
what the tests hold against the reference with the same numpy noise.
torch's generators are not JAX's, so payloads are never the reference's bit
for bit. The host-sampled round builds ``gen`` on the payload's device from
a host integer (:func:`codec_generator`); the superstep lane passes the
engine's own device generator, so nothing in its round creates a generator
or reads a host value. Low-rank's sketch is a pure function of its int64
seed on any device (:func:`lowrank_sketch`), so the server regrows it from
the seed alone. Under cohort sharding (``cohort``, a
``core.fedavg.CohortSlice``) every rank draws the whole cohort's noise, the
unsharded shape, and keeps its own rows (``shard_rows``), so a sharded
round encodes what the unsharded one does; ``aggregate`` and
:func:`decode_aggregate` then take ``group=`` (and the ``total=`` and
``carry=`` of ``ops.finish_partial_sum``) for the partial-sum finish.

The payloads are the wire: sub-byte and odd widths ship bit-packed 32-bit
words (``utils.bitpack``), byte-wide codes ship truncated to the true n,
so for every codec except ``mask`` (whose dense masked store is a
simulation convenience) ``realized_device_bytes`` of one client's payload
equals ``wire_bytes(n)``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.fedavg import (
    client_update,
    loss_of_terms,
    loss_terms,
    masked_weighted_loss,
    shard_rows,
)
from repro_torch.core.strategies import resolve_strategy
from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.ops import (
    finish_partial_sum,
    host_to_device,
    normalized_weights,
    packed_quantized_fedavg_aggregate,
    quantized_fedavg_aggregate,
    shard_weights,
    sharded_packed_quantized_fedavg_aggregate,
    sharded_quantized_fedavg_aggregate,
    sharded_sparse_fedavg_aggregate,
    sparse_fedavg_aggregate,
)
from repro_torch.kernels.quantized_agg import dequantize_ref, unpack_ref
from repro_torch.utils.bitpack import pack_codes, packed_size, words_per_chunk
from repro_torch.utils.tree import tree_leaves, tree_map, tree_ravel_stacked, tree_unravel

# Charged once per upload by codecs whose server-side decode regrows client
# randomness from a shared seed (mask: the kept positions; low-rank: the
# sketch A).
SEED_BYTES = 8


class Codec(NamedTuple):
    """A statically shaped update codec over stacked (m, n) delta rows.

    ``encode(gen, flat, cohort=None)`` returns a payload dict of (m, ...)
    tensors, its noise drawn from the ``torch.Generator`` ``gen`` (for a
    ``CohortSlice`` ``cohort``, the whole cohort's draw, this rank's rows);
    ``decode(payloads, n)`` rebuilds the (m, n) fp32 delta estimates.
    ``wire_bytes(n)`` is one client's upload size from shapes alone;
    ``payload_bytes(payload)`` the realized size of one client's payload
    (leaves without the client axis). ``aggregate(payloads, weights, n,
    group=None, total=None, carry=None)``, where present, fuses decode into
    the weighted server mean (RAW count weights), finished over a client
    ``group`` when one is given; :func:`decode_aggregate` is the entry
    point.
    """

    name: str
    encode: Callable
    decode: Callable
    wire_bytes: Callable
    payload_bytes: Callable
    unbiased: bool
    aggregate: Optional[Callable] = None


def codec_generator(seed: int, device) -> torch.Generator:
    """The generator ``codec.encode`` takes on the host-sampled lane: on
    ``device``, seeded with the host integer ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _draw(draw, rows: int, cohort):
    """``draw(m)``'s (m, ...) noise for this call's ``rows`` clients: the
    whole cohort's draw cut to this rank's rows under sharding
    (``shard_rows``), else ``draw(rows)``."""
    return shard_rows(draw(rows if cohort is None else cohort.m), cohort)


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the columns of an (m, w) tensor to ``width``, through a byte
    view, so that every dtype (uint16 included) takes the same path."""
    m, w = x.shape
    if w == width:
        return x.contiguous()
    size = x.element_size()
    out = torch.zeros((m, width * size), dtype=torch.uint8, device=x.device)
    out[:, : w * size] = x.contiguous().view(torch.uint8)
    return out.view(x.dtype)


# ---------------------------------------------------------------------------
# noise-free encode cores: each takes the noise its codec's encode draws
# ---------------------------------------------------------------------------

def _quantize_core(flat, u, *, bits, chunk):
    """Quantize (m, n) rows with the (m, C, chunk) uniform draw ``u``."""
    levels = 2**bits - 1
    m, n = flat.shape
    pad = (-n) % chunk
    v = flat.to(torch.float32)
    # Edge-pad, not zero-pad: a padded 0 would widen the tail chunk's range.
    v = torch.cat([v, v[:, -1:].expand(m, pad)], dim=1).reshape(m, -1, chunk)
    lo = v.amin(dim=2)
    scale = v.amax(dim=2) - lo
    safe = torch.clamp(scale, min=1e-12)
    x = (v - lo[:, :, None]) / safe[:, :, None] * levels
    q = torch.clamp(torch.floor(x + u), 0, levels)
    if bits % 8:
        wire = pack_codes(q.reshape(-1, chunk), bits, chunk).reshape(m, -1)
        wire = wire[:, : packed_size(n, chunk, bits)].contiguous()
    else:
        store = torch.uint8 if bits == 8 else torch.uint16
        wire = q.to(store).reshape(m, -1)[:, :n].contiguous()
    # ``n`` is the true (unpadded) size: simulation metadata, not wire payload
    return {"q": wire, "lo": lo, "scale": scale,
            "n": torch.full((m,), n, dtype=torch.int32)}


def _mask_core(flat, mask, keep_frac):
    """Mask (m, n) rows with the boolean Bernoulli(keep_frac) draw ``mask``."""
    vals = torch.where(mask, flat.to(torch.float32) / keep_frac, 0.0)
    return {"values": vals, "kept": mask.sum(dim=1).to(torch.int32)}


def _lowrank_dims(n: int):
    """(d1, d2): d1 = ceil(sqrt(n)), d2 = ceil(n / d1)."""
    d1 = math.isqrt(n)
    if d1 * d1 < n:
        d1 += 1
    d1 = max(d1, 1)
    return d1, -(-n // d1)


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 tensors (or ints) in [0, 2**32), in
    16-bit halves so that no product passes 2**49: exact, and the same bits
    on every device."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (the "lowbias32" xorshift-multiply chain) on
    int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sketch_bits(seeds: torch.Tensor, count: int) -> torch.Tensor:
    """(m, count) 32-bit words, as int64, of the counter-based stream of
    each int64 seed in ``seeds`` (m,): word c of seed s is
    ``h(h(c ^ k1) ^ k2)`` with ``h`` :func:`_hash32`, ``k1 = h(lo)`` and
    ``k2 = h(hi ^ k1)`` of the seed's 32-bit halves. Integer arithmetic
    only, so every device gives the same words."""
    lo, hi = seeds & _M32, (seeds >> 32) & _M32
    k1 = _hash32(lo)
    k2 = _hash32(hi ^ k1)
    c = torch.arange(count, dtype=torch.int64, device=seeds.device)
    return _hash32(_hash32(c[None, :] ^ k1[:, None]) ^ k2[:, None])


def lowrank_sketch(seeds: torch.Tensor, d1: int, rank: int) -> torch.Tensor:
    """(m, d1, rank) fp32 Gaussian sketches A, a pure function of the int64
    seeds (m,) on their device, with no host read (so a captured round
    regrows them): two 24-bit uniforms a coordinate from :func:`sketch_bits`
    (u1 in (0, 1], u2 in [0, 1), both exact in fp32), then Box-Muller's
    ``sqrt(-2 ln u1) cos(2 pi u2)`` in fp64, rounded to fp32. The entries
    are independent N(0, 1), so E[A A^T] = rank I."""
    bits = sketch_bits(seeds, 2 * d1 * rank) >> 8
    scale = 2.0 ** -24
    u1 = (bits[:, 0::2].to(torch.float64) + 1.0) * scale
    u2 = bits[:, 1::2].to(torch.float64) * scale
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.to(torch.float32).reshape(seeds.shape[0], d1, rank)


def _lowrank_core(flat, a):
    """B = A^T M for (m, n) rows and the (m, d1, rank) sketch ``a``."""
    m, n = flat.shape
    d1, d2 = _lowrank_dims(n)
    mat = torch.nn.functional.pad(flat.to(torch.float32), (0, d1 * d2 - n))
    return torch.einsum("kdr,kde->kre", a, mat.reshape(m, d1, d2))


def _lowrank_aggregate_core(a, b, w, n):
    """Σ_k w_k A_k B_k / rank, one contraction over (client, rank): the mean
    for normalized weights ``w``, a rank's partial sum for its
    ``ops.shard_weights``."""
    m = torch.einsum("kdr,kre->de", a * w[:, None, None], b)
    return m.reshape(-1)[:n] / a.shape[2]


def identity_codec() -> Codec:
    """fp32 passthrough: the compressed lane equals the plain lane."""

    def encode(gen, flat, cohort=None):
        return {"values": flat.to(torch.float32)}

    def decode(payloads, n):
        return payloads["values"][:, :n]

    return Codec(
        name="identity",
        encode=encode,
        decode=decode,
        wire_bytes=lambda n: 4 * n,
        payload_bytes=lambda p: p["values"].numel() * 4,
        unbiased=True,
    )


def quantize_codec(bits: int = 8, chunk: int = 512) -> Codec:
    """Stochastic uniform quantization to 2^bits levels per ``chunk``.

    Each row is edge-padded to a multiple of ``chunk`` and split into
    (C, chunk) blocks, each with its own fp32 (lo, scale); stochastic
    rounding ``floor(x + U[0,1))`` keeps E[decode(encode(x))] = x, and a
    constant chunk (scale 0) decodes exactly to lo. Widths with
    bits % 8 != 0 ship bit-packed int32 words truncated to
    ``packed_size(n)``; bits 8 and 16 ship uint8/uint16 codes truncated to
    n. The aggregate fuses into ``quantized_aggregate`` or
    ``packed_quantized_aggregate``."""
    if bits < 1 or bits > 16:
        raise ValueError(f"quantize_codec supports 1..16 bits, got {bits}")
    levels = 2**bits - 1
    packed = bits % 8 != 0
    wpc = words_per_chunk(chunk, bits) if packed else None

    def encode(gen, flat, cohort=None):
        m, n = flat.shape
        u = _draw(lambda rows: torch.rand((rows, -(-n // chunk), chunk), generator=gen,
                                          device=flat.device), m, cohort)
        return _quantize_core(flat, u, bits=bits, chunk=chunk)

    def codes_of(payloads, n):
        """The chunk-aligned kernel input: the wire re-padded with zeros
        (code 0; the output is sliced to n, so pad codes are inert)."""
        n_chunks = -(-n // chunk)
        return _pad_cols(payloads["q"], n_chunks * (wpc if packed else chunk))

    def decode(payloads, n):
        codes = codes_of(payloads, n)
        if packed:
            codes = unpack_ref(codes, bits=bits, chunk=chunk)
        x = dequantize_ref(codes, payloads["lo"], payloads["scale"],
                           chunk=chunk, levels=levels)
        return x[:, :n]

    def aggregate(payloads, weights, n, group=None, **finish):
        codes = codes_of(payloads, n)
        lo, scale = payloads["lo"], payloads["scale"]
        if packed:
            if group is None:
                out = packed_quantized_fedavg_aggregate(
                    codes, lo, scale, weights, bits=bits, chunk=chunk, levels=levels)
            else:
                out = sharded_packed_quantized_fedavg_aggregate(
                    codes, lo, scale, weights, bits=bits, chunk=chunk, levels=levels,
                    group=group, **finish)
        elif group is None:
            out = quantized_fedavg_aggregate(codes, lo, scale, weights, chunk=chunk,
                                             levels=levels)
        else:
            out = sharded_quantized_fedavg_aggregate(codes, lo, scale, weights, chunk=chunk,
                                                     levels=levels, group=group, **finish)
        return out[:n]

    def wire_bytes(n: int) -> int:
        # codes at their word-framed width plus 8 bytes of (lo, scale) per
        # chunk; the rounding noise stays with the client, so no seed ships
        n_chunks = -(-n // chunk)
        if packed:
            return 4 * packed_size(n, chunk, bits) + 8 * n_chunks
        return -(-n * bits // 8) + 8 * n_chunks

    return Codec(
        name=f"q{bits}",
        encode=encode,
        decode=decode,
        wire_bytes=wire_bytes,
        payload_bytes=lambda p: wire_bytes(int(p["n"])),
        unbiased=True,
        aggregate=aggregate,
    )


def mask_codec(keep_frac: float = 0.1) -> Codec:
    """Random-mask subsampling: keep each coordinate with probability p and
    rescale by 1/p (unbiased). The mask regrows from a shared seed, so the
    wire carries the kept values plus the seed; the payload keeps the dense
    masked vector (a simulation convenience) and the realized kept count,
    which ``payload_bytes`` charges."""
    if not 0.0 < keep_frac <= 1.0:
        raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")

    def encode(gen, flat, cohort=None):
        m, n = flat.shape
        u = _draw(lambda rows: torch.rand((rows, n), generator=gen, device=flat.device),
                  m, cohort)
        return _mask_core(flat, u < keep_frac, keep_frac)

    return Codec(
        name=f"mask{keep_frac:g}",
        encode=encode,
        decode=lambda payloads, n: payloads["values"][:, :n],
        wire_bytes=lambda n: 4 * int(round(keep_frac * n)) + SEED_BYTES,
        payload_bytes=lambda p: 4 * int(p["kept"]) + SEED_BYTES,
        unbiased=True,
    )


def topk_codec(keep_frac: float = 0.05) -> Codec:
    """Magnitude top-k with int32 indices on the wire; k = max(floor(p*n), 1).
    Biased (``unbiased=False``). The aggregate scatter-adds the pairs
    through ``sparse_aggregate`` and never densifies the clients."""
    if not 0.0 < keep_frac <= 1.0:
        raise ValueError(f"keep_frac must be in (0, 1], got {keep_frac}")
    # floor(p * n) in integer arithmetic: the float product can land one ulp
    # below the true value (100 * 0.29 -> 28.999...).
    frac_ppb = round(keep_frac * 10**9)

    def k_of(n: int) -> int:
        return max(n * frac_ppb // 10**9, 1)

    def encode(gen, flat, cohort=None):
        flat = flat.to(torch.float32)
        _, idx = torch.topk(flat.abs(), k_of(flat.shape[1]), dim=1)
        return {"idx": idx.to(torch.int32), "values": torch.gather(flat, 1, idx)}

    def decode(payloads, n):
        idx = payloads["idx"].to(torch.int64)
        out = torch.zeros((idx.shape[0], n), dtype=torch.float32, device=idx.device)
        return out.scatter_(1, idx, payloads["values"].to(torch.float32))

    def aggregate(payloads, weights, n, group=None, **finish):
        if group is None:
            return sparse_fedavg_aggregate(payloads["idx"], payloads["values"], weights, n)
        return sharded_sparse_fedavg_aggregate(payloads["idx"], payloads["values"], weights,
                                               n, group=group, **finish)

    return Codec(
        name=f"top{keep_frac:g}",
        encode=encode,
        decode=decode,
        wire_bytes=lambda n: 8 * k_of(n),
        payload_bytes=lambda p: 8 * p["idx"].numel(),
        unbiased=False,
        aggregate=aggregate,
    )


def lowrank_codec(rank: int = 8) -> Codec:
    """Low-rank sketch (Konečný et al., arXiv 1610.02527): the delta viewed
    as a (d1, d2) matrix M (d1 = ceil(sqrt(n)), zero-padded) ships as
    B = A^T M for a Gaussian A of shape (d1, rank), plus the int64 seed that
    regrows A (the ``key`` leaf, charged at ``SEED_BYTES``). Decode is
    A B / rank, unbiased since E[A A^T] = rank I. The seeds are drawn from
    ``gen`` on the payload's device, and A is :func:`lowrank_sketch` of its
    seed: a pure function on the device (the reference's regrow is
    ``jax.random.normal`` of the key), so the server regrows A from the seed
    alone and a captured round draws and regrows without a host value. The
    aggregate Σ_k w_k A_k B_k / rank is one ``einsum`` over (client, rank);
    the reference's is an XLA ``dot_general``, not a Pallas kernel."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")

    def encode(gen, flat, cohort=None):
        m, n = flat.shape
        seeds = _draw(lambda rows: torch.randint(0, 2**62, (rows,), generator=gen,
                                                 device=flat.device), m, cohort)
        a = lowrank_sketch(seeds, _lowrank_dims(n)[0], rank)
        return {"b": _lowrank_core(flat, a), "key": seeds}

    def decode(payloads, n):
        b = payloads["b"]
        a = lowrank_sketch(payloads["key"], _lowrank_dims(n)[0], rank)
        m = torch.einsum("kdr,kre->kde", a, b)
        return m.reshape(m.shape[0], -1)[:, :n] / rank

    def aggregate(payloads, weights, n, group=None, **finish):
        b = payloads["b"]
        a = lowrank_sketch(payloads["key"], _lowrank_dims(n)[0], rank)
        if group is None:
            return _lowrank_aggregate_core(a, b, normalized_weights(weights, b.device), n)
        w = shard_weights(weights, b.device, finish.get("total"))
        return finish_partial_sum(_lowrank_aggregate_core(a, b, w, n), w, group, **finish)

    def wire_bytes(n: int) -> int:
        return 4 * rank * _lowrank_dims(n)[1] + SEED_BYTES

    return Codec(
        name=f"lowrank{rank}",
        encode=encode,
        decode=decode,
        wire_bytes=wire_bytes,
        payload_bytes=lambda p: 4 * p["b"].numel() + SEED_BYTES,
        unbiased=True,
        aggregate=aggregate,
    )


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

def decode_aggregate(codec: Codec, payloads, weights, n: int, *, group=None,
                     **finish) -> torch.Tensor:
    """Weighted average of m stacked payloads -> one (n,) fp32 delta.

    ``weights`` are RAW example counts n_k; this is the one entry point
    that normalizes them (host counts on the host). Codecs with a fused
    ``aggregate`` take it; the rest decode to (m, n) and go through
    ``fedavg_aggregate``. Over a client ``group`` (the reference's
    ``axis_name``) the payloads are this rank's, the kernel runs in
    partial-sum mode and ``ops.finish_partial_sum`` (with ``finish``'s
    ``total`` and ``carry``) makes the mean."""
    if codec.aggregate is not None:
        if group is None:
            return codec.aggregate(payloads, weights, n)
        return codec.aggregate(payloads, weights, n, group=group, **finish)
    flat = codec.decode(payloads, n).contiguous()
    if group is None:
        return fedavg_aggregate(flat, normalized_weights(weights, flat.device))
    w = shard_weights(weights, flat.device, finish.get("total"))
    return finish_partial_sum(fedavg_aggregate(flat, w, normalized=False), w, group, **finish)


def build_compressed_round_step(loss_fn: Callable, codec: Codec, *, strategy=None,
                                group=None):
    """``round_step(state, batch) -> (state, {"loss": ...})`` for the
    compressed lane: ClientUpdate for the cohort, the fp32 deltas raveled
    to (m, n) and encoded with the generator ``batch.gen``, decode + weighted average
    through :func:`decode_aggregate`, then ``strategy.apply``. The loss is
    the plain lane's, so the identity codec reproduces the plain step
    exactly. The reference's ``build_compressed_round_step``
    (``compression.py:491``).

    Over a client ``group`` (the reference's ``axis_name``) the batch is
    this rank's slice of the cohort, ``batch.cohort`` its slots: the codec
    draws the whole cohort's noise and keeps this rank's rows, the
    aggregate finishes with one all-reduce that also carries the loss's
    terms, and ``strategy.apply`` runs after it on every rank alike."""
    strategy = resolve_strategy(strategy)

    def round_step(state, rb):
        if rb.gen is None:
            raise ValueError("the compressed round step needs RoundBatch.gen, the codec "
                             "stream's torch.Generator (seeded from the round's host seed "
                             "on the host-sampled lane)")
        client_params, losses = client_update(
            loss_fn, state.params, rb.data, rb.step_mask, rb.lr
        )
        w = torch.as_tensor(rb.client_weights, dtype=torch.float32)
        w_dev = host_to_device(w, losses.device)
        deltas = tree_map(lambda c, p: (c - p).float(), client_params, state.params)
        flat, spec = tree_ravel_stacked(deltas)
        # unsharded: the two-argument encode(gen, flat) a wrapped codec may have
        payloads = (codec.encode(rb.gen, flat) if rb.cohort is None
                    else codec.encode(rb.gen, flat, rb.cohort))
        if group is None:
            loss = masked_weighted_loss(losses, rb.step_mask, w_dev)
            avg = decode_aggregate(codec, payloads, w, spec.total_size)
        else:
            total = None if rb.cohort is None else rb.cohort.total
            terms = loss_terms(losses, rb.step_mask, w_dev, total)
            avg = decode_aggregate(codec, payloads, w, spec.total_size, group=group,
                                   total=total, carry=terms)
            loss = loss_of_terms(terms)
        agg_delta = tree_unravel(spec, avg)
        outer, new_params = strategy.apply(state.outer_state, state.params, agg_delta)
        return state._replace(params=new_params, outer_state=outer), {"loss": loss}

    return round_step


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

def wire_bytes(codec: Codec, params) -> int:
    """Expected upload bytes of one client's update of this model under
    this codec, from shapes alone; the dense fp32 baseline is 4 * size."""
    return int(codec.wire_bytes(sum(p.numel() for p in tree_leaves(params))))


def realized_device_bytes(payload) -> int:
    """Physical bytes of one client's payload (leaves without the client
    axis): the number :func:`wire_bytes` predicts. ``n`` and ``kept`` are
    simulation metadata and never travel; a ``key`` leaf stands for the
    shipped seed and is charged ``SEED_BYTES``."""
    total = 0
    for name, leaf in payload.items():
        if name in ("n", "kept"):
            continue
        total += SEED_BYTES if name == "key" else leaf.numel() * leaf.element_size()
    return total
