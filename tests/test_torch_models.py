"""repro_torch's data, models, losses, conversion and evaluation held
against the reference on the same numpy inputs and the reference's own
``init`` weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import losses as ref_losses  # noqa: E402
from repro.core.simulation import make_eval_fn as ref_make_eval_fn  # noqa: E402
from repro.data import batching as ref_batching  # noqa: E402
from repro.data import partition as ref_partition  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import paper as ref_paper  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core.simulation import make_eval_fn  # noqa: E402
from repro_torch.data import batching, partition, synthetic  # noqa: E402
from repro_torch.data.pool import device_pool_budget  # noqa: E402
from repro_torch.models import paper  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)


def _models(name):
    if name == "2nn":
        return (ref_paper.mnist_2nn(n_classes=5, d_in=20),
                paper.mnist_2nn(n_classes=5, d_in=20, device="cpu"), (20,), 5)
    return ref_paper.mnist_cnn(), paper.mnist_cnn(device="cpu"), (28, 28, 1), 10


def _carried(ref_model, model, seed=0):
    """The reference's init weights, and the same weights in the port."""
    jp = ref_model.init(jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.array, jp), model, device="cpu")


def _images(n, shape, classes, seed=0):
    """Synthetic MNIST-like inputs (real image statistics for the CNN)."""
    if shape == (28, 28, 1):
        tr, _, _ = synthetic.make_image_classification(n, 1, n_classes=classes, seed=seed)
        return tr.x, tr.y
    r = np.random.default_rng(seed)
    return (r.normal(size=(n,) + shape).astype(np.float32),
            r.integers(0, classes, n).astype(np.int32))


# ---------------------------------------------------------------------------
# models and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["2nn", "cnn"])
def test_forward_and_loss_match_reference(name):
    """Same weights, same inputs: logits, loss and accuracy agree at 1e-5.
    For the CNN this pins the NHWC flatten before ``fc`` and the
    HWIO -> OIHW kernel permute."""
    ref_model, model, shape, classes = _models(name)
    jp, tp = _carried(ref_model, model, seed=4)
    x, y = _images(16, shape, classes, seed=1)
    want = np.asarray(ref_model.apply(jp, jnp.asarray(x)))
    got = model.apply(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    (wl, waux), (gl, gaux) = (ref_model.loss(jp, (jnp.asarray(x), jnp.asarray(y))),
                              model.loss(tp, (torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(float(gl), float(wl), atol=1e-5, rtol=1e-5)
    assert float(gaux["acc"]) == float(waux["acc"])


def test_cnn_accepts_flat_inputs():
    ref_model, model, _, _ = _models("cnn")
    jp, tp = _carried(ref_model, model)
    x, _ = _images(4, (28, 28, 1), 10)
    flat = x.reshape(4, -1)
    np.testing.assert_allclose(model.apply(tp, torch.from_numpy(flat)).numpy(),
                               np.asarray(ref_model.apply(jp, jnp.asarray(flat))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ctor,n_params", [
    (lambda: paper.mnist_2nn(device="cpu"), 199_210),
    (lambda: paper.mnist_cnn(device="cpu"), 1_663_370),
])
def test_paper_param_counts(ctor, n_params):
    params = ctor().init(0)
    assert sum(p.numel() for p in tree_leaves(params)) == n_params


def test_init_is_seeded():
    m = paper.mnist_2nn(n_classes=5, d_in=20, device="cpu")
    a, b, c = m.init(3), m.init(3), m.init(4)
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert torch.equal(x, y)
        assert x.dtype == torch.float32
    assert not torch.equal(a["fc1"]["w"], c["fc1"]["w"])


def test_softmax_cross_entropy_matches_reference(rng):
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    want = ref_losses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)
    assert float(losses.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) == \
        float(ref_losses.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def test_params_round_trip_through_numpy():
    ref_model, model, _, _ = _models("cnn")
    jp, tp = _carried(ref_model, model, seed=2)
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("breakage,match", [
    (lambda t: t.pop("fc2"), "keys"),
    (lambda t: t["fc1"].__setitem__("w", np.zeros((21, 200), np.float32)), "fc1/w: shape"),
    (lambda t: t["out"].__setitem__("b", np.zeros((5,), np.float64)), "out/b: dtype"),
])
def test_params_from_numpy_refuses_mismatches(breakage, match):
    ref_model, model, _, _ = _models("2nn")
    tree = jax.tree.map(np.array, ref_model.init(jax.random.PRNGKey(0)))
    breakage(tree)
    with pytest.raises(ValueError, match=match):
        params_from_numpy(tree, model, device="cpu")


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        paper.mnist_2nn()
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_fn(lambda p, x: x, np.zeros((4, 2), np.float32),
                     np.zeros(4, np.int32))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_test,batch_size", [
    ("2nn", 37, 512),     # smaller than one eval batch (modular fill)
    ("2nn", 37, 16),      # ragged multi-batch tail
    ("cnn", 21, 512),
])
def test_make_eval_fn_matches_reference(name, n_test, batch_size):
    ref_model, model, shape, classes = _models(name)
    jp, tp = _carried(ref_model, model, seed=5)
    x, y = _images(n_test, shape, classes, seed=2)
    want = ref_make_eval_fn(ref_model.apply, x, y, batch_size=batch_size)(jp)
    got = make_eval_fn(model.apply, x, y, batch_size=batch_size, device="cpu")(tp)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-5, rtol=1e-5)
    assert float(got["acc"]) == pytest.approx(float(want["acc"]), abs=1e-7)


# ---------------------------------------------------------------------------
# data: byte-identical copies of repro.data
# ---------------------------------------------------------------------------

def test_synthetic_images_byte_identical():
    want = ref_synthetic.make_image_classification(60, 25, seed=7)
    got = synthetic.make_image_classification(60, 25, seed=7)
    for a, b in ((got[0].x, want[0].x), (got[0].y, want[0].y), (got[1].x, want[1].x),
                 (got[1].y, want[1].y), (got[2], want[2])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_partitions_byte_identical():
    labels = np.random.default_rng(1).integers(0, 10, 600).astype(np.int32)
    for got, want in (
        (partition.partition_iid(600, 12, seed=3), ref_partition.partition_iid(600, 12, seed=3)),
        (partition.partition_pathological_noniid(labels, 12, seed=3),
         ref_partition.partition_pathological_noniid(labels, 12, seed=3)),
    ):
        assert got.num_clients == want.num_clients
        np.testing.assert_array_equal(got.client_sizes, want.client_sizes)
        for a, b in zip(got.client_indices, want.client_indices):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("B", [None, 4, 10])
def test_pack_clients_byte_identical(rng, B):
    clients = [(rng.normal(size=(n, 3, 2)).astype(np.float32),
                rng.integers(0, 5, n).astype(np.int32)) for n in (3, 17, 9, 40)]
    got = batching.pack_clients(clients, B)
    want = ref_batching.pack_clients(clients, B)
    for field in ("x", "y", "counts", "steps_per_epoch", "bucket_of"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for field in ("batch_size", "max_steps_per_epoch", "bucket_sizes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.max_real_steps_per_epoch == want.max_real_steps_per_epoch
    assert got.overhead() == want.overhead()
    counts = np.asarray([len(x) for x, _ in clients])
    assert batching.estimate_pool_nbytes(counts, B, (3, 2), 4, (), 4) == \
        ref_batching.estimate_pool_nbytes(counts, B, (3, 2), 4, (), 4)
    with pytest.raises(ValueError, match="exceeds device budget"):
        batching.pack_clients(clients, B, max_bytes=16)


@pytest.mark.parametrize("n,multiple", [(10, 1), (10, 4), (3, 8)])
def test_pad_cohort_identical(n, multiple):
    ids = np.arange(n)[::-1].copy()
    for a, b in zip(batching.pad_cohort(ids, multiple),
                    ref_batching.pad_cohort(ids, multiple)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_device_pool_budget(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_POOL_BUDGET", "12345")
    assert device_pool_budget(torch.device("cpu")) == 12345
    monkeypatch.delenv("REPRO_DEVICE_POOL_BUDGET")
    assert device_pool_budget(torch.device("cpu")) == 2 * 1024**3
