"""The codec aggregates' routes and the stream kernel's numerics, on the CPU.

The stream kernel (``csrc/quantized_agg.cu::qagg_stream_kernel``) runs only
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). What is tested
here: what :func:`_route` sends to it (it reads shapes, dtypes, alignment
and K only, before any build), that the private launcher refuses a route
before any build, and that the kernel's arithmetic -- each code made a float
from its bits (``0x4B000000 | q`` minus 2^23, by ``__byte_perm`` for bytes
and half-words, by mask-and-or for 1-, 2- and 4-bit fields), ``step =
scale / levels`` once per (k, chunk), then ``fma(w, fma(q, step, lo), acc)``
in k order -- meets 1e-6 of the largest term against the reference's Pallas
kernels (interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.quantized_agg import packed_quantized_aggregate as ref_packed  # noqa: E402
from repro.kernels.quantized_agg import quantized_aggregate as ref_qagg  # noqa: E402
from repro.utils.bitpack import pack_codes as ref_pack_codes  # noqa: E402
from repro_torch.kernels import quantized_agg as qa  # noqa: E402
from repro_torch.utils.bitpack import words_per_chunk  # noqa: E402

MAIN_N = (199_210, 1_663_370)   # the 2NN's and the CNN's parameters
CHUNK = 512                     # the specs' quantize chunk
TWO23 = np.float32(2.0**23)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load the library fails the test."""
    def refuse():
        raise AssertionError("the route reached the build")
    monkeypatch.setattr(qa, "_lib", refuse)


def _payload(kind, K, C, chunk=CHUNK, misaligned=False):
    """An uninitialized payload of C chunks: ``kind`` is "q8", "q16" or the
    packed bits (an int); returns (payload, bits)."""
    if kind in ("q8", "q16"):
        dtype, bits, cols = ((torch.uint8, 8, C * chunk) if kind == "q8"
                             else (torch.uint16, 16, C * chunk))
    else:
        dtype, bits, cols = torch.int32, kind, C * words_per_chunk(chunk, kind)
    if misaligned:   # a contiguous view one element past a 16-byte boundary
        return torch.empty(K * cols + 1, dtype=dtype)[1:].view(K, cols), bits
    return torch.empty((K, cols), dtype=dtype), bits


def _route(payload, bits, K, C, chunk=CHUNK):
    out = qa._out(payload, torch.empty((K, C)), chunk)
    return qa._route(payload, out, chunk=chunk, bits=bits, K=K)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", MAIN_N)
@pytest.mark.parametrize("kind", ["q8", "q16", 1, 2, 4])
def test_the_specs_shapes_take_the_stream_route(no_build, N, kind):
    C = -(-N // CHUNK)
    payload, bits = _payload(kind, 10, C)
    assert _route(payload, bits, 10, C) == "stream"


@pytest.mark.parametrize("kind", ["q8", "q16"])
@pytest.mark.parametrize("N,chunk", [(4097, 16), (100, 30)])
def test_odd_chunks_take_the_general_route(no_build, kind, N, chunk):
    C = -(-N // chunk)
    for K in (1, 2, 10, 17):
        payload, bits = _payload(kind, K, C, chunk)
        assert _route(payload, bits, K, C, chunk) == "general"


@pytest.mark.parametrize("kind", ["q8", "q16", 4])
def test_a_misaligned_view_takes_the_general_route(no_build, kind):
    payload, bits = _payload(kind, 10, 2, misaligned=True)
    assert payload.data_ptr() % 16 != 0
    assert _route(payload, bits, 10, 2) == "general"


def test_a_misaligned_output_takes_the_general_route(no_build):
    payload, _ = _payload("q8", 10, 2)
    out = torch.empty(2 * CHUNK + 1)[1:]
    assert qa._route(payload, out, chunk=CHUNK, bits=8, K=10) == "general"


@pytest.mark.parametrize("bits", [3, *range(5, 16)])
def test_bits_that_do_not_divide_32_take_the_general_route(no_build, bits):
    for chunk in (30, CHUNK):
        payload, _ = _payload(bits, 10, 2, chunk)
        assert _route(payload, bits, 10, 2, chunk) == "general"


@pytest.mark.parametrize("kind", ["q8", "q16", 1, 2, 4])
def test_more_rows_than_the_ring_holds_take_the_general_route(no_build, kind):
    for K, want in ((qa.STREAM_MAX_K, "stream"), (qa.STREAM_MAX_K + 1, "general")):
        payload, bits = _payload(kind, K, 3)
        assert _route(payload, bits, K, 3) == want


def test_the_route_is_total_and_stream_rows_are_whole_granules(no_build):
    """Every input the wrappers take gets one of the two routes; a row the
    stream route takes is a whole number of 16-byte granules a chunk, at
    least MIN_CHUNK_BYTES, and (for words) its frames have no slack codes."""
    seen = set()
    for kind in ("q8", "q16", *range(1, 16)):
        for chunk in (1, 8, 16, 30, 64, 96, 128, 256, 512, 1000, 1024):
            for K in (1, 10, 33):
                for misaligned in (False, True):
                    payload, bits = _payload(kind, K, 2, chunk, misaligned)
                    route = _route(payload, bits, K, 2, chunk)
                    assert route in qa.ROUTES
                    seen.add(route)
                    if route == "stream":
                        row_bytes = payload.shape[1] * payload.element_size()
                        chunk_bytes = row_bytes // 2
                        assert chunk_bytes % 16 == 0 and chunk_bytes >= qa.MIN_CHUNK_BYTES
                        assert chunk_bytes * 8 == chunk * bits
    assert seen == set(qa.ROUTES)


def test_private_launcher_refuses_unknown_and_inapplicable_routes(no_build):
    codes, _ = _payload("q8", 3, 2, chunk=30)
    lo = torch.zeros((3, 2))
    w = torch.full((3,), 1 / 3)
    out = qa._out(codes, lo, 30)
    with pytest.raises(ValueError, match="no route 'tma'"):
        qa._launch(codes, lo, lo, w, out, bits=8, chunk=30, levels=255, route="tma")
    with pytest.raises(ValueError, match="stream route does not take"):
        qa._launch(codes, lo, lo, w, out, bits=8, chunk=30, levels=255, route="stream")
    words, _ = _payload(3, 3, 2)
    with pytest.raises(ValueError, match="stream route does not take"):
        qa._launch(words, lo, lo, w, qa._out(words, lo, CHUNK), bits=3, chunk=CHUNK,
                   levels=7, route="stream")


@pytest.mark.parametrize("kind", ["q8", 4])
def test_cpu_call_takes_the_plain_version_and_counts_nothing(no_build, kind):
    rng = np.random.default_rng(3)
    K, C = 4, 3
    lo, scale, w = _ranges(rng, K, C)
    if kind == "q8":
        codes = torch.from_numpy(rng.integers(0, 256, (K, C * CHUNK)).astype(np.uint8))
        wrapper, kw = qa.quantized_aggregate, dict(chunk=CHUNK, levels=255)
        want = qa.quantized_aggregate_ref(codes, lo, scale, w, **kw)
    else:
        codes = torch.from_numpy(_words(rng, K, C, 4).view(np.int32))
        wrapper, kw = qa.packed_quantized_aggregate, dict(bits=4, chunk=CHUNK, levels=15)
        want = qa.packed_quantized_aggregate_ref(codes, lo, scale, w, **kw)
    before = (wrapper.launches, wrapper.stream_launches)
    got = wrapper(codes, lo, scale, w, **kw)
    assert torch.equal(got, want)
    assert (wrapper.launches, wrapper.stream_launches) == before


# ---------------------------------------------------------------------------
# the decode: a code's bits under the exponent of 2^23
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the eight bytes {x, y}."""
    src = np.stack([(x >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)]
                   + [(y >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _decode(words, bits):
    """qagg_stream_kernel's decode: (..., W) uint32 words -> (..., W * 32 /
    bits) float32 codes, code j of word i at i * 32 / bits + j."""
    words = np.asarray(words, dtype=np.uint32)
    magic = np.uint32(0x4B000000)
    fields = []
    for j in range(32 // bits):
        if bits == 8:
            f = _byte_perm(words, np.full_like(words, magic), 0x7440 | j)
        elif bits == 16:
            f = _byte_perm(words, np.full_like(words, magic), 0x7400 | ((2 * j + 1) << 4) | 2 * j)
        else:
            f = ((words >> np.uint32(j * bits)) & np.uint32((1 << bits) - 1)) | magic
        fields.append(f.view(np.float32) - TWO23)
    return np.stack(fields, axis=-1).reshape(*words.shape[:-1], -1)


def test_decode_is_exact_for_every_byte_code():
    codes = np.arange(256, dtype=np.uint8)
    got = _decode(codes.view(np.uint32), 8)
    assert np.array_equal(got, codes.astype(np.float32))


def test_decode_is_exact_for_every_half_word_code():
    codes = np.arange(65536, dtype=np.uint16)
    got = _decode(codes.view(np.uint32), 16)
    assert np.array_equal(got, codes.astype(np.float32))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_decode_is_exact_for_every_field_of_every_half_word(bits):
    """Each half-word value in both halves of a word, then random words:
    every field equals its integer, as the reference unpacks it."""
    h = np.arange(65536, dtype=np.uint32)
    rng = np.random.default_rng(bits)
    for words in (h | (h << np.uint32(16)), rng.integers(0, 2**32, 4096, dtype=np.uint32)):
        got = _decode(words, bits)
        shifts = np.arange(32 // bits, dtype=np.uint32) * np.uint32(bits)
        want = (words[:, None] >> shifts) & np.uint32((1 << bits) - 1)
        assert np.array_equal(got.reshape(words.size, -1), want.astype(np.float32))


# ---------------------------------------------------------------------------
# the stream kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """fp32 fma through fp64: a * b of two fp32 values is exact there; the
    add rounds once in fp64 and once to fp32 (1 fp32 ulp at most)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _emulate(payload_words, lo, scale, w, *, bits, chunk, levels):
    """qagg_stream_kernel's sum: (K, W) uint32 words -> (C * chunk,) fp32."""
    q = _decode(payload_words, bits)                     # (K, C * chunk)
    step = scale / np.float32(levels)                    # once per (k, chunk)
    c = np.arange(q.shape[1]) // chunk
    acc = np.zeros(q.shape[1], np.float32)
    for k in range(q.shape[0]):
        acc = _fma32(np.full_like(acc, w[k]), _fma32(q[k], step[k, c], lo[k, c]), acc)
    return acc


def _ranges(rng, K, C, ghosts=0):
    lo = rng.normal(size=(K, C)).astype(np.float32)
    scale = rng.uniform(0.0, 2.0, (K, C)).astype(np.float32)
    scale[rng.uniform(size=scale.shape) < 0.25] = 0.0      # constant chunks
    w = rng.uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        lo[K - ghosts:] = 1e4
        w[K - ghosts:] = 0.0
    w /= w.sum()
    return torch.from_numpy(lo), torch.from_numpy(scale), torch.from_numpy(w)


def _words(rng, K, C, bits):
    """(K, C * wpc) uint32 words packed from random codes, as the codec packs."""
    codes = rng.integers(0, 2**bits, (K * C, CHUNK))
    return np.stack([np.asarray(ref_pack_codes(jnp.asarray(codes[i * C:(i + 1) * C]), bits,
                                               CHUNK)).view(np.uint32)
                     for i in range(K)])


@pytest.mark.parametrize("K,ghosts", [(1, 0), (10, 0), (10, 3), (17, 0)])
@pytest.mark.parametrize("kind", ["q8", "q16", 1, 2, 4])
def test_stream_arithmetic_matches_the_reference_kernel(K, ghosts, kind):
    """Three chunks of 512 (one of them often constant): 1e-6 of the largest
    term, as the card holds the kernel against the plain version."""
    rng = np.random.default_rng(K * 100 + ghosts + (kind if isinstance(kind, int) else 0))
    C = 3
    lo, scale, w = _ranges(rng, K, C, ghosts)
    if kind in ("q8", "q16"):
        bits = 8 if kind == "q8" else 16
        levels = 2**bits - 1
        codes = rng.integers(0, levels + 1, (K, C * CHUNK)).astype(
            np.uint8 if bits == 8 else np.uint16)
        words = codes.view(np.uint32)
        want = ref_qagg(jnp.asarray(codes), jnp.asarray(lo.numpy()), jnp.asarray(scale.numpy()),
                        jnp.asarray(w.numpy()), chunk=CHUNK, levels=levels, interpret=True)
        plain = qa.quantized_aggregate_ref(torch.from_numpy(codes), lo, scale, w, chunk=CHUNK,
                                           levels=levels)
    else:
        bits, levels = kind, 2**kind - 1
        words = _words(rng, K, C, bits)
        codes = _decode(words, bits)
        want = ref_packed(jnp.asarray(words), jnp.asarray(lo.numpy()),
                          jnp.asarray(scale.numpy()), jnp.asarray(w.numpy()), bits=bits,
                          chunk=CHUNK, levels=levels, interpret=True)
        plain = qa.packed_quantized_aggregate_ref(torch.from_numpy(words.view(np.int32)), lo,
                                                  scale, w, bits=bits, chunk=CHUNK,
                                                  levels=levels)
    got = _emulate(words, lo.numpy(), scale.numpy(), w.numpy(), bits=bits, chunk=CHUNK,
                   levels=levels)
    real = K - ghosts
    c = np.arange(C * CHUNK) // CHUNK
    terms = (codes[:real].astype(np.float32) * (scale.numpy()[:real, c] / np.float32(levels))
             + lo.numpy()[:real, c])
    tol = 1e-6 * float(np.abs(terms).max())
    assert got.shape == (C * CHUNK,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=tol)


def test_probe_timeline_edits_still_match_the_kernel_source():
    """kernels/probe.py builds the stream kernel with timer stamps; each
    edit must find its code exactly once."""
    from repro_torch.kernels import build, probe

    text = (build.CSRC / "quantized_agg.cu").read_text()
    for old, _ in probe.TIMELINE_EDITS:
        assert text.count(old) == 1, old
