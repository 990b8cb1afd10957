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

Noise: ``encode(seed, flat)`` draws every random number the codec needs
from a ``torch.Generator`` seeded with the host integer ``seed``, then
calls a noise-free core that takes the noise as an argument (the uniform
draw for quantize, the Bernoulli mask for mask, the Gaussian sketch for
low-rank). The cores are what the tests hold against the reference with
the same numpy noise. torch's generators are not JAX's, so payloads are
never the reference's bit for bit.

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

from repro_torch.core.fedavg import client_update, masked_weighted_loss
from repro_torch.core.strategies import resolve_strategy
from repro_torch.kernels.fedavg_agg import fedavg_aggregate
from repro_torch.kernels.ops import (
    normalized_weights,
    packed_quantized_fedavg_aggregate,
    quantized_fedavg_aggregate,
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

    ``encode(seed, flat)`` returns a payload dict of (m, ...) tensors;
    ``decode(payloads, n)`` rebuilds the (m, n) fp32 delta estimates.
    ``wire_bytes(n)`` is one client's upload size from shapes alone;
    ``payload_bytes(payload)`` the realized size of one client's payload
    (leaves without the client axis). ``aggregate(payloads, weights, n)``,
    where present, fuses decode into the weighted server mean (RAW count
    weights); :func:`decode_aggregate` is the entry point.
    """

    name: str
    encode: Callable
    decode: Callable
    wire_bytes: Callable
    payload_bytes: Callable
    unbiased: bool
    aggregate: Optional[Callable] = None


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


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


def _lowrank_sketch(seeds, d1, rank, device):
    """(m, d1, rank) Gaussian sketches, one per host int64 seed, drawn by the
    CPU generator so that every device regrows the same A."""
    return torch.stack([
        torch.randn((d1, rank), generator=_generator(int(s), "cpu"))
        for s in seeds.tolist()
    ]).to(device)


def _lowrank_core(flat, a):
    """B = A^T M for (m, n) rows and the (m, d1, rank) sketch ``a``."""
    m, n = flat.shape
    d1, d2 = _lowrank_dims(n)
    mat = torch.nn.functional.pad(flat.to(torch.float32), (0, d1 * d2 - n))
    return torch.einsum("kdr,kde->kre", a, mat.reshape(m, d1, d2))


def _lowrank_aggregate_core(a, b, w, n):
    """Σ_k w_k A_k B_k / rank, one contraction over (client, rank), for
    normalized weights ``w``."""
    m = torch.einsum("kdr,kre->de", a * w[:, None, None], b)
    return m.reshape(-1)[:n] / a.shape[2]


def identity_codec() -> Codec:
    """fp32 passthrough: the compressed lane equals the plain lane."""

    def encode(seed, flat):
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

    def encode(seed, flat):
        m, n = flat.shape
        gen = _generator(seed, flat.device)
        u = torch.rand((m, -(-n // chunk), chunk), generator=gen, device=flat.device)
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

    def aggregate(payloads, weights, n):
        codes = codes_of(payloads, n)
        if packed:
            out = packed_quantized_fedavg_aggregate(
                codes, payloads["lo"], payloads["scale"], weights, bits=bits,
                chunk=chunk, levels=levels)
        else:
            out = quantized_fedavg_aggregate(
                codes, payloads["lo"], payloads["scale"], weights, chunk=chunk,
                levels=levels)
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

    def encode(seed, flat):
        gen = _generator(seed, flat.device)
        mask = torch.rand(flat.shape, generator=gen, device=flat.device) < keep_frac
        return _mask_core(flat, mask, keep_frac)

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

    def encode(seed, flat):
        flat = flat.to(torch.float32)
        _, idx = torch.topk(flat.abs(), k_of(flat.shape[1]), dim=1)
        return {"idx": idx.to(torch.int32), "values": torch.gather(flat, 1, idx)}

    def decode(payloads, n):
        idx = payloads["idx"].to(torch.int64)
        out = torch.zeros((idx.shape[0], n), dtype=torch.float32, device=idx.device)
        return out.scatter_(1, idx, payloads["values"].to(torch.float32))

    def aggregate(payloads, weights, n):
        return sparse_fedavg_aggregate(payloads["idx"], payloads["values"], weights, n)

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
    A B / rank, unbiased since E[A A^T] = rank I. The seeds are host
    integers and A is drawn by the CPU generator, then moved to the
    payload's device, so the server regrows the same A on any device. The
    aggregate Σ_k w_k A_k B_k / rank is one ``einsum`` over (client, rank);
    the reference's is an XLA ``dot_general``, not a Pallas kernel."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")

    def encode(seed, flat):
        m, n = flat.shape
        seeds = torch.randint(0, 2**62, (m,), generator=_generator(seed, "cpu"))
        a = _lowrank_sketch(seeds, _lowrank_dims(n)[0], rank, flat.device)
        return {"b": _lowrank_core(flat, a), "key": seeds}

    def decode(payloads, n):
        b = payloads["b"]
        a = _lowrank_sketch(payloads["key"], _lowrank_dims(n)[0], rank, b.device)
        m = torch.einsum("kdr,kre->kde", a, b)
        return m.reshape(m.shape[0], -1)[:, :n] / rank

    def aggregate(payloads, weights, n):
        b = payloads["b"]
        a = _lowrank_sketch(payloads["key"], _lowrank_dims(n)[0], rank, b.device)
        return _lowrank_aggregate_core(a, b, normalized_weights(weights, b.device), n)

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

def decode_aggregate(codec: Codec, payloads, weights, n: int) -> torch.Tensor:
    """Weighted average of m stacked payloads -> one (n,) fp32 delta.

    ``weights`` are RAW example counts n_k; this is the one entry point
    that normalizes them (host counts on the host). Codecs with a fused
    ``aggregate`` take it; the rest decode to (m, n) and go through
    ``fedavg_aggregate``."""
    if codec.aggregate is not None:
        return codec.aggregate(payloads, weights, n)
    flat = codec.decode(payloads, n).contiguous()
    return fedavg_aggregate(flat, normalized_weights(weights, flat.device))


def build_compressed_round_step(loss_fn: Callable, codec: Codec, *, strategy=None):
    """``round_step(state, batch) -> (state, {"loss": ...})`` for the
    compressed lane: ClientUpdate for the cohort, the fp32 deltas raveled
    to (m, n) and encoded with ``batch.seed``, decode + weighted average
    through :func:`decode_aggregate`, then ``strategy.apply``. The loss is
    the plain lane's, so the identity codec reproduces the plain step
    exactly. The reference's ``build_compressed_round_step``
    (``compression.py:491``)."""
    strategy = resolve_strategy(strategy)

    def round_step(state, rb):
        if rb.seed is None:
            raise ValueError("the compressed round step needs RoundBatch.seed "
                             "(the codec stream's seed)")
        client_params, losses = client_update(
            loss_fn, state.params, rb.data, rb.step_mask, rb.lr
        )
        w = torch.as_tensor(rb.client_weights, dtype=torch.float32)
        loss = masked_weighted_loss(losses, rb.step_mask, w.to(losses.device))
        deltas = tree_map(lambda c, p: (c - p).float(), client_params, state.params)
        flat, spec = tree_ravel_stacked(deltas)
        payloads = codec.encode(rb.seed, flat)
        agg_delta = tree_unravel(spec, decode_aggregate(codec, payloads, w, spec.total_size))
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
