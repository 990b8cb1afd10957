"""Chunk-framed code packing for the quantize wire (counterpart of
``repro/utils/bitpack.py``).

Integer codes in ``[0, 2**bits)`` pack little-endian into 32-bit words:
code ``j`` of a word occupies bits ``[j*bits, (j+1)*bits)``. Framing is per
chunk: each ``chunk``-code row packs into ``words_per_chunk`` words of its
own, ``32 // bits`` codes to a word, and codes never straddle a word, so
widths that do not divide 32 leave ``32 % bits`` slack bits in each word.
A tail chunk shorter than ``chunk`` ships only its own
``ceil(tail / codes_per_word)`` words (``packed_size``).

Words are carried as ``torch.int32`` holding the reference's uint32 bit
pattern: torch has no ``>>`` for uint32 on the CPU. The wire stays four
bytes a word. Packing sums the shifted codes in int64 (the shifted codes
share no bits, so the sum is the bitwise or) and wraps the result to int32
explicitly. Unpacking shifts the int32 words right arithmetically; since
``j*bits + bits <= 32``, the mask removes every copied sign bit.
"""
from __future__ import annotations

import torch

__all__ = [
    "codes_per_word",
    "words_per_chunk",
    "packed_size",
    "pack_codes",
    "unpack_codes",
]


def codes_per_word(bits: int) -> int:
    """How many ``bits``-wide codes one 32-bit word carries (floor)."""
    if not 1 <= bits < 32:
        raise ValueError(f"bits must be in [1, 32), got {bits}")
    return 32 // bits


def words_per_chunk(chunk: int, bits: int) -> int:
    """32-bit words per full ``chunk``-code frame."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return -(-chunk // codes_per_word(bits))


def packed_size(n: int, chunk: int, bits: int) -> int:
    """Words on the wire for ``n`` true codes under chunk framing: full
    chunks cost ``words_per_chunk`` each, the tail chunk only
    ``ceil(tail / codes_per_word)``."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    ppw = codes_per_word(bits)
    n_chunks = -(-n // chunk)
    tail = n - (n_chunks - 1) * chunk
    return (n_chunks - 1) * words_per_chunk(chunk, bits) + (-(-tail // ppw))


def pack_codes(codes: torch.Tensor, bits: int, chunk: int) -> torch.Tensor:
    """(C, chunk) integer codes (< 2**bits) -> (C * words_per_chunk,) int32
    words. Truncating to ``packed_size(n)`` for the wire is the caller's
    job (kernels take the full chunk-aligned array)."""
    if codes.ndim != 2 or codes.shape[1] != chunk:
        raise ValueError(f"codes must be (C, {chunk}), got {tuple(codes.shape)}")
    ppw = codes_per_word(bits)
    wpc = words_per_chunk(chunk, bits)
    q = codes.to(torch.int64)
    pad = wpc * ppw - chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    q = q.reshape(codes.shape[0], wpc, ppw)
    shifts = torch.arange(ppw, dtype=torch.int64, device=q.device) * bits
    words = (q << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(-1)


def unpack_codes(words: torch.Tensor, bits: int, chunk: int, n_chunks: int) -> torch.Tensor:
    """(n_chunks * words_per_chunk,) int32 words -> (n_chunks, chunk) int32
    codes: the exact inverse of :func:`pack_codes` (zero words decode to
    code 0)."""
    ppw = codes_per_word(bits)
    wpc = words_per_chunk(chunk, bits)
    if words.ndim != 1 or words.shape[0] != n_chunks * wpc:
        raise ValueError(
            f"words must be ({n_chunks * wpc},) for {n_chunks} chunks of "
            f"{wpc} words, got {tuple(words.shape)}"
        )
    if words.dtype != torch.int32:
        raise TypeError(f"words must be int32, got {words.dtype}")
    shifts = torch.arange(ppw, dtype=torch.int32, device=words.device) * bits
    codes = (words.reshape(n_chunks, wpc, 1) >> shifts) & (2**bits - 1)
    return codes.reshape(n_chunks, wpc * ppw)[:, :chunk]
