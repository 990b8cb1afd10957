"""repro_torch's runtime guards (counterpart of ``tests/test_guards.py``).

``retrace_guard`` holds a warm superstep loop to zero new round programs on
every lane. ``transfer_guard`` is ``torch.cuda.set_sync_debug_mode`` on a
card and guards nothing on the CPU; here its mode handling is held against
a recording stand-in for the card's two calls. That a sync inside the
captured round raises on the card is ``tests/test_torch_gpu.py``'s."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (  # noqa: E402
    RetraceError,
    retrace_guard,
    sanctioned_staging,
    transfer_guard,
)
from repro_torch.core.compression import quantize_codec, topk_codec  # noqa: E402
from repro_torch.core.engine import RoundEngine  # noqa: E402
from repro_torch.core.fedavg import FedAvgConfig  # noqa: E402
from repro_torch.core.strategies import FedAvgM  # noqa: E402
from repro_torch.models import paper  # noqa: E402

torch.set_num_threads(1)


def _engine(**kw):
    r = np.random.default_rng(0)
    clients = [(r.normal(size=(n, 12)).astype(np.float32),
                r.integers(0, 5, n).astype(np.int32)) for n in (9, 24, 17, 8)]
    model = paper.mnist_2nn(n_classes=5, d_in=12, device="cpu")
    cfg = FedAvgConfig(C=0.75, E=1, B=8, lr=0.2, lr_decay=0.98, seed=7)
    return RoundEngine(model.loss, model.init(0), clients, cfg, device="cpu", **kw)


LANES = {
    "plain-device": (dict(device_sampling=True), dict(rounds_per_step=1)),
    "fedavgm": (dict(device_sampling=True, strategy=FedAvgM(0.9)), dict(rounds_per_step=3)),
    "q8": (dict(device_sampling=True, codec=quantize_codec(8)), dict(rounds_per_step=1)),
    "topk": (dict(device_sampling=True, codec=topk_codec(0.1)), dict(rounds_per_step=3)),
    "superstep": (dict(device_sampling=True), dict(rounds_per_step=3)),
    # the reference's "sharded" and "sharded-superstep" cases: a client mesh
    # over a gloo world of one (MESH); NCCL on the card is test_torch_gpu.py's
    "sharded": (dict(device_sampling=True, mesh="MESH"), dict(rounds_per_step=1)),
    "sharded-superstep": (dict(device_sampling=True, mesh="MESH"), dict(rounds_per_step=3)),
}


@pytest.fixture
def client_mesh():
    """A client mesh over a gloo world of one, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield make_client_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("lane", sorted(LANES))
def test_warmed_round_loop_builds_nothing_new_under_the_guards(lane, request):
    eng_kw, run_kw = LANES[lane]
    if eng_kw.get("mesh") == "MESH":
        eng_kw = {**eng_kw, "mesh": request.getfixturevalue("client_mesh")}
    eng = _engine(**eng_kw)
    eng.run(3, **run_kw)                     # warm: the one round program
    with transfer_guard("disallow"):
        with retrace_guard(lambda: eng.num_compilations, what=lane):
            h = eng.run(3, **run_kw)
            eng.run(2, rounds_per_step=2)    # another R: the same program
    assert len(h.records) == 8 and eng.num_compilations == 1
    assert all(np.isfinite(r.train_loss) for r in h.records)


def test_retrace_guard_raises_on_a_counter_that_moves():
    eng = _engine(device_sampling=True)
    with pytest.raises(RetraceError, match="1 new round program"):
        with retrace_guard(lambda: eng.num_compilations, what="cold engine"):
            eng.run(2, rounds_per_step=2)    # the first round program is new
    count = [0]
    with retrace_guard(lambda: count[0], max_new=2):
        count[0] += 2
    with pytest.raises(RetraceError, match="budget 2; 2 -> 5"):
        with retrace_guard(lambda: count[0], max_new=2):
            count[0] += 3


class _FakeSyncDebug:
    """The card's ``get_sync_debug_mode`` / ``set_sync_debug_mode`` pair,
    recording each mode set."""

    def __init__(self):
        self.mode, self.calls = 0, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}[mode] if isinstance(mode, str) else mode
        self.calls.append(self.mode)


def test_transfer_guard_sets_and_restores_the_sync_debug_mode(monkeypatch):
    fake = _FakeSyncDebug()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    with transfer_guard():
        assert fake.mode == 2
        with sanctioned_staging():
            assert fake.mode == 0
        assert fake.mode == 2
        with transfer_guard("log"):
            assert fake.mode == 1
        assert fake.mode == 2
    assert fake.mode == 0 and fake.calls == [2, 0, 2, 1, 2, 0]
    with pytest.raises(ZeroDivisionError):
        with transfer_guard():
            1 / 0
    assert fake.mode == 0                    # restored on the way out of an error


def test_guards_on_the_cpu_touch_no_card_state(monkeypatch):
    def card_only(*args):
        raise AssertionError("a guard reached torch.cuda on a machine without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", card_only)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", card_only)
    with transfer_guard("disallow"):
        with sanctioned_staging():
            float(torch.ones(()))
        float(torch.ones(()))                # nothing to wait for on the CPU
    with pytest.raises(ValueError, match="mode"):
        with transfer_guard("disallow_explicit"):
            pass
