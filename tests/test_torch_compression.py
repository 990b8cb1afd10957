"""repro_torch's compressed-upload lane held against the reference.

The plain versions of the three wire kernels against the reference's
Pallas kernels in interpret mode; the bit packing word for word; each
codec's noise-free encode core against the reference's encode given the
same noise; ``decode_aggregate`` of identical payloads; unbiasedness under
torch's generator; the wire bytes; and the compressed engine. Inputs and
noise are made with numpy (or drawn by JAX and handed over as numpy); JAX
stays on the CPU. The CUDA kernels themselves are checked on the card
(tests/test_torch_gpu.py and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FedAvgConfig as RefConfig  # noqa: E402
from repro.core import RoundEngine as RefEngine  # noqa: E402
from repro.core import compression as ref_comp  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.quantized_agg import (  # noqa: E402
    packed_quantized_aggregate as ref_packed_qagg,
    quantized_aggregate as ref_qagg,
)
from repro.kernels.sparse_agg import sparse_aggregate as ref_sparse_agg  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro.utils import bitpack as ref_bitpack  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.simulation import make_eval_fn  # noqa: E402
from repro_torch.data.partition import partition_pathological_noniid  # noqa: E402
from repro_torch.data.synthetic import make_image_classification  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quantized_agg import (  # noqa: E402
    packed_quantized_aggregate,
    quantized_aggregate,
    quantized_aggregate_ref,
)
from repro_torch.kernels.sparse_agg import sparse_aggregate  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils import bitpack  # noqa: E402

torch.set_num_threads(1)

# Full-width upload bytes of one client, from the reference's
# ``codec.wire_bytes``: the quick-mode 2NN (mnist_2nn(n_classes=5, d_in=64)),
# the paper's 2NN and the paper's CNN. mask is the expectation.
WIRE_TABLE = {
    54_205: dict(identity=216_820, q8=55_053, q4=27_952, q2=14_400, q12=109_260,
                 top=21_680, lowrank8=7_464, mask=21_688),
    199_210: dict(identity=796_840, q8=202_330, q4=102_728, q2=52_924, q12=401_540,
                  top=79_680, lowrank8=14_280, mask=79_692),
    1_663_370: dict(identity=6_653_480, q8=1_689_362, q4=857_680, q2=441_836,
                    q12=3_352_732, top=665_344, lowrank8=41_288, mask=665_356),
}


def _codecs(ns):
    """The table's codecs, from either package's compression module."""
    return {
        "identity": ns.identity_codec(), "q8": ns.quantize_codec(8),
        "q4": ns.quantize_codec(4), "q2": ns.quantize_codec(2),
        "q12": ns.quantize_codec(12), "top": ns.topk_codec(0.05),
        "lowrank8": ns.lowrank_codec(8), "mask": ns.mask_codec(0.1),
    }


def _w(rng, K, ghosts=0):
    w = rng.uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        w[-ghosts:] = 0.0
    return (w / w.sum()).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))       # a writable copy


def _words_t(words):
    """Reference uint32 words -> the port's int32 carrier, same bits."""
    return _t(np.asarray(words).view(np.int32))


# ---------------------------------------------------------------------------
# plain kernel versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

def _quantized_payload(rng, K, N, chunk, code_dtype=np.uint8, levels=255):
    n_pad = -(-N // chunk) * chunk
    codes = rng.integers(0, levels + 1, (K, n_pad)).astype(code_dtype)
    C = n_pad // chunk
    lo = rng.normal(size=(K, C)).astype(np.float32)
    scale = rng.uniform(0.0, 2.0, (K, C)).astype(np.float32)
    scale[rng.uniform(size=scale.shape) < 0.2] = 0.0   # constant chunks
    return codes, lo, scale


@pytest.mark.parametrize("K", [1, 2, 17])
@pytest.mark.parametrize("N,chunk,code_dtype,levels", [
    (33, 16, np.uint8, 255),          # ragged N
    (1000, 64, np.uint8, 255),
    (100, 32, np.uint16, 65535),
])
def test_quantized_aggregate_matches_reference(rng, K, N, chunk, code_dtype, levels):
    codes, lo, scale = _quantized_payload(rng, K, N, chunk, code_dtype, levels)
    w = _w(rng, K, ghosts=K // 4)
    want = ref_qagg(jnp.asarray(codes), jnp.asarray(lo), jnp.asarray(scale),
                    jnp.asarray(w), chunk=chunk, levels=levels, interpret=True)
    before = quantized_aggregate.launches
    got = quantized_aggregate(_t(codes), _t(lo), _t(scale), _t(w), chunk=chunk,
                              levels=levels)
    assert quantized_aggregate.launches == before           # the CPU launches nothing
    assert got.dtype == torch.float32 and got.shape == (codes.shape[1],)
    # both accumulate in fp32 over K rows, in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("K", [1, 2, 17])
@pytest.mark.parametrize("N,chunk,bits", [
    (33, 16, 4),       # ragged N, 8 codes a word
    (1000, 64, 2),     # 16 codes a word
    (250, 30, 3),      # width and chunk that do not divide the word
    (100, 16, 12),     # odd wide width, 2 codes a word
])
def test_packed_quantized_aggregate_matches_reference(rng, K, N, chunk, bits):
    levels = 2**bits - 1
    n_pad = -(-N // chunk) * chunk
    C = n_pad // chunk
    codes = rng.integers(0, levels + 1, (K, n_pad)).astype(np.uint32)
    words = np.stack([np.asarray(ref_bitpack.pack_codes(
        jnp.asarray(c.reshape(C, chunk)), bits, chunk)) for c in codes])
    lo = rng.normal(size=(K, C)).astype(np.float32)
    scale = rng.uniform(0.0, 2.0, (K, C)).astype(np.float32)
    w = _w(rng, K)
    want = ref_packed_qagg(jnp.asarray(words), jnp.asarray(lo), jnp.asarray(scale),
                           jnp.asarray(w), bits=bits, chunk=chunk, levels=levels,
                           interpret=True)
    got = packed_quantized_aggregate(_words_t(words), _t(lo), _t(scale), _t(w),
                                     bits=bits, chunk=chunk, levels=levels)
    assert got.shape == (n_pad,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # and it is the unpacked kernel's plain version on the unpacked codes
    dense = quantized_aggregate_ref(_t(codes.astype(np.int64)), _t(lo), _t(scale), _t(w),
                                    chunk=chunk, levels=levels)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())


def _sparse_payload(rng, K, n, k):
    idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(K)]).astype(np.int32)
    return idx, rng.normal(size=(K, k)).astype(np.float32)


@pytest.mark.parametrize("K", [1, 2, 17])
@pytest.mark.parametrize("n,k", [(37, 3), (513, 25), (300, 15)])
def test_sparse_aggregate_matches_reference(rng, K, n, k):
    idx, vals = _sparse_payload(rng, K, n, k)
    w = _w(rng, K, ghosts=K // 4)
    want = ref_sparse_agg(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(w), n,
                          interpret=True)
    before = sparse_aggregate.launches
    got = sparse_aggregate(_t(idx), _t(vals), _t(w), n)
    assert sparse_aggregate.launches == before
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sparse_aggregate_bf16_values_duplicates_and_ghosts(rng):
    idx, vals = _sparse_payload(rng, 5, 200, 11)
    idx[0, :3] = 7                                  # duplicates within a client add
    w = _w(rng, 5, ghosts=1)
    vals16 = jnp.asarray(vals).astype(jnp.bfloat16)
    want = ref_sparse_agg(jnp.asarray(idx), vals16, jnp.asarray(w), 200, interpret=True)
    got = sparse_aggregate(_t(idx), torch.from_numpy(vals).bfloat16(), _t(w), 200)
    # the same bf16 values, accumulated in fp32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    real = sparse_aggregate(_t(idx[:4]), torch.from_numpy(vals[:4]).bfloat16(),
                            _t(w[:4] / w[:4].sum()), 200)
    np.testing.assert_allclose(got.numpy(), real.numpy(), atol=1e-6)


@pytest.mark.parametrize("kernel", ["quantized", "sparse"])
def test_bf16_accumulation_matches_reference(rng, kernel):
    """The plain versions keep the reference's accum_dtype option: the
    running sum rounds to bf16 at every client row, on both sides."""
    K = 9
    w = _w(rng, K)
    if kernel == "quantized":
        codes, lo, scale = _quantized_payload(rng, K, 200, 32)
        want = ref_qagg(jnp.asarray(codes), jnp.asarray(lo), jnp.asarray(scale),
                        jnp.asarray(w), chunk=32, levels=255, interpret=True,
                        accum_dtype=jnp.bfloat16)
        got = quantized_aggregate(_t(codes), _t(lo), _t(scale), _t(w), chunk=32,
                                  levels=255, accum_dtype=torch.bfloat16)
    else:
        idx, vals = _sparse_payload(rng, K, 200, 40)
        want = ref_sparse_agg(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(w), 200,
                              interpret=True, accum_dtype=jnp.bfloat16)
        got = sparse_aggregate(_t(idx), _t(vals), _t(w), 200, accum_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want).astype(np.float32)
    # both round the running sum to bf16 after each row, in other orders:
    # at most one bf16 ulp of the largest sum per row, K rows
    np.testing.assert_allclose(got.float().numpy(), want32,
                               atol=K * float(np.abs(want32).max()) * 2**-8, rtol=0)


def test_wire_kernels_refuse_bad_inputs(rng):
    codes, lo, scale = _quantized_payload(rng, 2, 64, 16)
    c, l, s, half = _t(codes), _t(lo), _t(scale), torch.tensor([0.5, 0.5])
    with pytest.raises(ValueError, match="pre-normalized"):
        quantized_aggregate(c, l, s, torch.tensor([1.0, 2.0]), chunk=16, levels=255)
    with pytest.raises(ValueError, match="C\\*chunk"):
        quantized_aggregate(c[:, :30], l, s, half, chunk=16, levels=255)
    with pytest.raises(TypeError, match="uint8 or uint16"):
        quantized_aggregate(c.to(torch.int32), l, s, half, chunk=16, levels=255)
    with pytest.raises(TypeError, match="float32"):
        quantized_aggregate(c, l.double(), s, half, chunk=16, levels=255)
    with pytest.raises(ValueError, match="lo/scale"):
        quantized_aggregate(c, l[:, :3], s, half, chunk=16, levels=255)
    words = _words_t(np.zeros((2, 8), np.uint32))
    with pytest.raises(ValueError, match="bits in 1..15"):
        packed_quantized_aggregate(words, l, s, half, bits=16, chunk=16, levels=65535)
    with pytest.raises(ValueError, match="C\\*2"):
        packed_quantized_aggregate(words[:, :3], l, s, half, bits=4, chunk=16, levels=15)
    with pytest.raises(TypeError, match="int32"):
        packed_quantized_aggregate(words.to(torch.int64), l[:, :4].contiguous(),
                                   s[:, :4].contiguous(), half, bits=4, chunk=16, levels=15)
    idx, vals = _sparse_payload(rng, 2, 64, 4)
    with pytest.raises(ValueError, match="pre-normalized"):
        sparse_aggregate(_t(idx), _t(vals), torch.tensor([1.0, 2.0]), 64)
    with pytest.raises(ValueError, match="share a"):
        sparse_aggregate(_t(idx[:, :3]), _t(vals), half, 64)
    with pytest.raises(ValueError, match="weights must be"):
        sparse_aggregate(_t(idx), _t(vals), torch.tensor([1.0]), 64)
    with pytest.raises(TypeError, match="int32"):
        sparse_aggregate(_t(idx).long(), _t(vals), half, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sparse_aggregate(_t(idx), _t(vals).half(), half, 64)


def test_ops_adapters_normalize_raw_counts(rng):
    counts = np.asarray([3.0, 9.0], np.float32)
    codes, lo, scale = _quantized_payload(rng, 2, 64, 16)
    got = ops.quantized_fedavg_aggregate(_t(codes), _t(lo), _t(scale), counts,
                                         chunk=16, levels=255)
    want = ref_ops.quantized_fedavg_aggregate(jnp.asarray(codes), jnp.asarray(lo),
                                              jnp.asarray(scale), jnp.asarray(counts),
                                              chunk=16, levels=255, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    idx, vals = _sparse_payload(rng, 2, 64, 4)
    got = ops.sparse_fedavg_aggregate(_t(idx), _t(vals), counts, 64)
    want = ref_ops.sparse_fedavg_aggregate(jnp.asarray(idx), jnp.asarray(vals),
                                           jnp.asarray(counts), 64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 16))
def test_pack_codes_bit_identical_to_reference(rng, bits):
    for chunk in (16, 30, 512):
        codes = rng.integers(0, 2**bits, (3, chunk)).astype(np.uint32)
        want = np.asarray(ref_bitpack.pack_codes(jnp.asarray(codes), bits, chunk))
        got = bitpack.pack_codes(_t(codes.astype(np.int64)), bits, chunk)
        assert got.dtype == torch.int32 and got.element_size() == 4
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        back = bitpack.unpack_codes(got, bits, chunk, 3)
        np.testing.assert_array_equal(back.numpy(), codes)
        assert bitpack.words_per_chunk(chunk, bits) == ref_bitpack.words_per_chunk(chunk, bits)
        for n in (1, chunk - 1, 5 * chunk + 3):
            if n >= 1:
                assert bitpack.packed_size(n, chunk, bits) == \
                    ref_bitpack.packed_size(n, chunk, bits)
    # the sign bit: a top code in the top slot survives the int32 carrier
    top = np.full((1, 32 // bits), 2**bits - 1, np.uint32)
    w = bitpack.pack_codes(_t(top.astype(np.int64)), bits, 32 // bits)
    np.testing.assert_array_equal(bitpack.unpack_codes(w, bits, 32 // bits, 1).numpy(), top)


# ---------------------------------------------------------------------------
# encode cores, fed the reference's own noise
# ---------------------------------------------------------------------------

def _flat(rng, n=300):
    return rng.normal(size=(n,)).astype(np.float32)


def _codes_of(payload_q, bits, chunk, n):
    """Integer codes (n,) from one client's wire ``q`` (either package)."""
    q = np.asarray(payload_q)
    if bits % 8 == 0:
        return q.astype(np.int64)
    n_chunks = -(-n // chunk)
    wpc = ref_bitpack.words_per_chunk(chunk, bits)
    words = np.zeros(n_chunks * wpc, np.uint32)
    words[: q.size] = q.view(np.uint32)
    return np.asarray(ref_bitpack.unpack_codes(jnp.asarray(words), bits, chunk,
                                               n_chunks)).reshape(-1)[:n].astype(np.int64)


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 16])
def test_quantize_core_matches_reference_encode(rng, bits):
    n, chunk = 300, 64
    flat = _flat(rng, n)
    key = jax.random.PRNGKey(bits)
    want = ref_comp.quantize_codec(bits, chunk=chunk).encode(key, jnp.asarray(flat))
    u = np.asarray(jax.random.uniform(key, (-(-n // chunk), chunk)))
    got = comp._quantize_core(_t(flat)[None], _t(u)[None], bits=bits, chunk=chunk)
    np.testing.assert_array_equal(got["lo"][0].numpy(), np.asarray(want["lo"]))
    np.testing.assert_array_equal(got["scale"][0].numpy(), np.asarray(want["scale"]))
    assert got["q"].shape[1] == np.asarray(want["q"]).size
    assert got["q"].element_size() == np.asarray(want["q"]).itemsize
    # fp32 arithmetic in other orders may tip floor(x + u) by one code step
    step = np.abs(_codes_of(got["q"][0].numpy(), bits, chunk, n)
                  - _codes_of(want["q"], bits, chunk, n))
    assert step.max() <= 1 and step.mean() < 0.01
    assert int(got["n"][0]) == int(want["n"])


def test_mask_core_matches_reference_encode(rng):
    flat = _flat(rng)
    key = jax.random.PRNGKey(3)
    want = ref_comp.mask_codec(0.25).encode(key, jnp.asarray(flat))
    mask = np.asarray(jax.random.bernoulli(key, 0.25, flat.shape))
    got = comp._mask_core(_t(flat)[None], _t(mask)[None], 0.25)
    np.testing.assert_allclose(got["values"][0].numpy(), np.asarray(want["values"]),
                               rtol=1e-6, atol=0)
    assert int(got["kept"][0]) == int(want["kept"])


def test_lowrank_core_matches_reference_encode(rng):
    n, rank = 500, 4
    flat = _flat(rng, n)
    key = jax.random.PRNGKey(5)
    want = ref_comp.lowrank_codec(rank).encode(key, jnp.asarray(flat))
    d1, d2 = comp._lowrank_dims(n)
    assert (rank, d2) == tuple(np.asarray(want["b"]).shape)
    a = np.asarray(jax.random.normal(key, (d1, rank), jnp.float32))
    got = comp._lowrank_core(_t(flat)[None], _t(a)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want["b"]), rtol=1e-5, atol=1e-5)


def test_topk_encode_matches_reference(rng):
    flat = _flat(rng, 400)
    want = ref_comp.topk_codec(0.05).encode(jax.random.PRNGKey(0), jnp.asarray(flat))
    got = comp.topk_codec(0.05).encode(0, _t(flat)[None])
    assert got["idx"].dtype == torch.int32
    np.testing.assert_array_equal(got["idx"][0].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["values"][0].numpy(), np.asarray(want["values"]))
    for frac, n, k in [(0.29, 100, 29), (0.07, 300, 21), (0.01, 10, 1)]:
        assert comp.topk_codec(frac).wire_bytes(n) == 8 * k


# ---------------------------------------------------------------------------
# decode + aggregate of identical payloads
# ---------------------------------------------------------------------------

def _ref_payloads(codec, flats, seed=0):
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(seed), s))(
        jnp.arange(flats.shape[0]))
    return jax.vmap(codec.encode)(keys, jnp.asarray(flats))


def _to_port(payloads):
    out = {}
    for name, leaf in payloads.items():
        a = np.asarray(leaf)
        out[name] = _t(a.view(np.int32) if a.dtype == np.uint32 else a)
    return out


@pytest.mark.parametrize("make", [
    lambda ns: ns.identity_codec(),
    lambda ns: ns.quantize_codec(8, chunk=64),
    lambda ns: ns.quantize_codec(16, chunk=64),
    lambda ns: ns.quantize_codec(4, chunk=64),
    lambda ns: ns.quantize_codec(12, chunk=30),
    lambda ns: ns.mask_codec(0.25),
    lambda ns: ns.topk_codec(0.1),
], ids=["identity", "q8", "q16", "q4", "q12", "mask", "top"])
def test_decode_aggregate_matches_reference(rng, make):
    m, n = 3, 333
    flats = rng.normal(size=(m, n)).astype(np.float32)
    counts = np.asarray([7.0, 19.0, 4.0], np.float32)            # RAW counts
    ref_codec, codec = make(ref_comp), make(comp)
    payloads = _ref_payloads(ref_codec, flats)
    want = ref_comp.decode_aggregate(ref_codec, payloads, jnp.asarray(counts), n,
                                     interpret=True)
    port = _to_port(payloads)
    got = comp.decode_aggregate(codec, port, counts, n)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # decode alone, client by client
    dec = codec.decode(port, n)
    want_dec = jax.vmap(lambda p: ref_codec.decode(p, n))(payloads)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec), atol=1e-5, rtol=0)


def test_lowrank_aggregate_matches_reference_on_the_same_sketches(rng):
    """The port regrows A from an int64 seed, the reference from a JAX key,
    so the contraction is held on the reference's own sketches."""
    m, n, rank = 3, 333, 4
    flats = rng.normal(size=(m, n)).astype(np.float32)
    counts = np.asarray([7.0, 19.0, 4.0], np.float32)
    ref_codec = ref_comp.lowrank_codec(rank)
    payloads = _ref_payloads(ref_codec, flats)
    want = ref_comp.decode_aggregate(ref_codec, payloads, jnp.asarray(counts), n,
                                     interpret=True)
    d1, _ = comp._lowrank_dims(n)
    a = jax.vmap(lambda k: jax.random.normal(k, (d1, rank), jnp.float32))(payloads["key"])
    got = comp._lowrank_aggregate_core(_t(a), _t(payloads["b"]),
                                       ops.normalized_weights(counts, "cpu"), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the port's own codec: decode_aggregate equals the weighted mean of decodes
    codec = comp.lowrank_codec(rank)
    own = codec.encode(11, _t(flats))
    agg = comp.decode_aggregate(codec, own, counts, n)
    w = counts / counts.sum()
    mean = (codec.decode(own, n) * _t(w)[:, None]).sum(0)
    np.testing.assert_allclose(agg.numpy(), mean.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# unbiasedness under torch's generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_unbiased(rng, bits):
    flat = _flat(rng, 200)
    reps = 150
    codec = comp.quantize_codec(bits, chunk=64)
    rows = _t(np.tile(flat, (reps, 1)))               # each row draws its own noise
    mean = codec.decode(codec.encode(1234, rows), 200).mean(0).numpy()
    step = float(np.abs(flat).max() * 2) / (2**bits - 1)
    np.testing.assert_allclose(mean, flat, atol=4 * step / (2 * np.sqrt(reps)) + 1e-3)


def test_mask_unbiased(rng):
    flat = _flat(rng)
    reps = 400
    codec = comp.mask_codec(0.25)
    payloads = codec.encode(99, _t(np.tile(flat, (reps, 1))))
    mean = codec.decode(payloads, flat.size).mean(0).numpy()
    np.testing.assert_allclose(mean, flat, rtol=3.5 * np.sqrt((1 / 0.25 - 1) / reps),
                               atol=0.05)
    kept = payloads["kept"].numpy()
    assert abs(kept.mean() / flat.size - 0.25) < 0.01


def test_lowrank_unbiased(rng):
    flat = _flat(rng, 300)
    reps = 200
    codec = comp.lowrank_codec(8)
    assert codec.unbiased
    mean = codec.decode(codec.encode(7, _t(np.tile(flat, (reps, 1)))), 300).mean(0).numpy()
    d1 = comp._lowrank_dims(300)[0]
    sigma = float(np.linalg.norm(flat) / np.sqrt(d1)) * np.sqrt((d1 + 1) / 8 / reps)
    assert float(np.abs(mean - flat).mean()) <= 5 * sigma + 1e-3


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", sorted(WIRE_TABLE))
def test_realized_bytes_equal_wire_bytes_and_reference(n):
    flat = torch.from_numpy(np.random.default_rng(n).normal(size=(1, n)).astype(np.float32))
    ref_codecs, codecs = _codecs(ref_comp), _codecs(comp)
    for name, want in WIRE_TABLE[n].items():
        codec, ref_codec = codecs[name], ref_codecs[name]
        assert codec.name == ref_codec.name
        assert codec.wire_bytes(n) == ref_codec.wire_bytes(n) == want, name
        if name == "mask":      # a dense simulation store: realized != wire (reference too)
            continue
        payload = {k: v[0] for k, v in codec.encode(0, flat).items()}
        assert comp.realized_device_bytes(payload) == want, name
        assert codec.payload_bytes(payload) == want, name


def test_mask_payload_bytes_track_the_realized_mask(rng):
    codec = comp.mask_codec(0.1)
    payload = {k: v[0] for k, v in codec.encode(3, _t(_flat(rng, 5000))[None]).items()}
    kept = int(payload["kept"])
    assert codec.payload_bytes(payload) == 4 * kept + comp.SEED_BYTES
    assert kept == int((payload["values"] != 0).sum())


def test_wire_bytes_of_a_model_matches_reference():
    ref_model = ref_paper.mnist_2nn(n_classes=5, d_in=64)
    model = paper.mnist_2nn(n_classes=5, d_in=64, device="cpu")
    for codec, ref_codec in zip(_codecs(comp).values(), _codecs(ref_comp).values()):
        assert comp.wire_bytes(codec, model.init(0)) == ref_comp.wire_bytes(
            ref_codec, ref_model.init(jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# the compressed engine
# ---------------------------------------------------------------------------

def _small_clients(sizes, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(n, 20)).astype(np.float32),
             r.choice([i % 5, (i + 1) % 5], n).astype(np.int32)) for i, n in enumerate(sizes)]


def test_identity_codec_engine_equals_plain_engine_bitwise():
    clients = _small_clients([9, 24, 17, 40])
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    cfg = FedAvgConfig(C=0.75, E=2, B=8, lr=0.2, seed=7)
    plain = RoundEngine(model.loss, model.init(1), clients, cfg, device="cpu")
    ident = RoundEngine(model.loss, model.init(1), clients, cfg,
                        codec=comp.identity_codec(), device="cpu")
    for a, b in zip(plain.run(3).records, ident.run(3).records):
        assert a.train_loss == b.train_loss
    for path in ("fc1", "fc2", "out"):
        for leaf in ("w", "b"):
            assert torch.equal(plain.params[path][leaf], ident.params[path][leaf])


@pytest.mark.parametrize("make", [lambda: comp.quantize_codec(8), lambda: comp.topk_codec(0.1),
                                  lambda: comp.lowrank_codec(4)], ids=["q8", "top", "lowrank"])
def test_codec_leaves_the_cohort_stream_unchanged(make):
    clients = _small_clients([12, 5, 30, 8, 19, 7, 22, 10, 9, 14])
    ref_model = ref_paper.mnist_2nn(n_classes=5, d_in=20)
    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    cfg = dict(C=0.3, E=1, B=4, lr=0.1, seed=11)
    ref = RefEngine(ref_model.loss, ref_model.init(jax.random.PRNGKey(0)), clients,
                    RefConfig(**cfg), codec=ref_comp.quantize_codec(8), interpret=True)
    eng = RoundEngine(model.loss, model.init(0), clients, FedAvgConfig(**cfg),
                      codec=make(), device="cpu")
    for _ in range(5):
        ref._next_round_inputs()
        eng.round()
    assert eng.rng.bit_generator.state == ref.rng.bit_generator.state


def test_noniid_2nn_q8_run_reaches_target_within_band_of_reference():
    """The band of the plain lane's run test: same data, init and cohorts;
    the batch permutations and the rounding noise differ. Rounds-to-target
    within 25% (at least 2 rounds), every evaluated accuracy within 0.05."""
    tr, te, _ = make_image_classification(1200, 400, seed=0)
    part = partition_pathological_noniid(tr.y, 20, seed=0)
    clients = [(tr.x[i], tr.y[i]) for i in part.client_indices]
    ref_model, model = ref_paper.mnist_2nn(), paper.mnist_2nn(device="cpu")
    jp = ref_model.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")
    cfg = dict(C=0.2, E=2, B=10, lr=0.05, seed=0)
    target = 0.8
    ref = RefEngine(ref_model.loss, jp, clients, RefConfig(**cfg),
                    eval_fn=ref_make_eval_fn(ref_model.apply, te.x, te.y),
                    codec=ref_comp.quantize_codec(8), interpret=True)
    eng = RoundEngine(model.loss, tp, clients, FedAvgConfig(**cfg),
                      eval_fn=make_eval_fn(model.apply, te.x, te.y, device="cpu"),
                      codec=comp.quantize_codec(8), device="cpu")
    want = ref.run(20, target_acc=target).rounds_to_target(target)
    got = eng.run(20, target_acc=target).rounds_to_target(target)
    assert want is not None and got is not None
    assert abs(got - want) <= max(2.0, 0.25 * want), (got, want)
    for a, b in zip(eng.history.accuracy_curve(), ref.history.accuracy_curve()):
        assert a[0] == b[0] and abs(a[1] - b[1]) <= 0.05, (a, b)


def test_compressed_round_step_needs_a_seed():
    from repro_torch.core.engine import RoundBatch, RoundState

    model = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    step = comp.build_compressed_round_step(model.loss, comp.quantize_codec(8))
    x = torch.zeros((1, 1, 2, 20))
    y = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="seed"):
        step(RoundState(model.init(0), ()),
             RoundBatch((x, y), torch.ones((1, 1)), torch.ones(1), lr=0.1))
