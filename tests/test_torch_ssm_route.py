"""The CUDA ssm_scan's launch plan and the lane-split scan's numerics, on
the CPU.

The ring kernel (``csrc/ssm_scan.cu::ssm_scan_ring_kernel``) runs only on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``). What is tested
here: the lanes a channel :func:`launch_plan` picks (it reads T only,
before any build), and that the kernel's arithmetic -- each channel's N
states padded to 4, 8 or 16 and split across L lanes, exp2 of dt * (A log2
e), each lane's partial dot product with C summed in four interleaved
parts and a tree, the lanes combined in the order of the xor shuffles --
meets 1e-5 of the scale against the reference's Pallas kernel (interpret
mode) and its sequential oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as ref_ssm_scan  # noqa: E402
from repro_torch.kernels import ssm_scan as sk  # noqa: E402

LOG2E = np.float32(1.4426950408889634)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load the library fails the test."""
    def refuse():
        raise AssertionError("the plan reached the build")
    monkeypatch.setattr(sk, "_lib", refuse)


def _padded(N):
    return 4 if N <= 4 else 8 if N <= 8 else 16


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 2, 16, 37, 2048])
def test_launch_plan_reads_t_only(no_build, T):
    lanes = sk.launch_plan(T)
    assert lanes in sk.LANES
    assert lanes == (sk.DECODE_LANES if T == 1 else sk.PREFILL_LANES)


@pytest.mark.parametrize("N", range(1, sk.MAX_STATE + 1))
def test_every_lane_count_splits_the_padded_states_evenly(N):
    for lanes in sk.LANES:
        assert _padded(N) % lanes == 0 and _padded(N) // lanes >= 1


def test_private_launcher_refuses_a_lane_count_it_has_no_kernel_for(no_build):
    args = _inputs(np.random.default_rng(0), 1, 4, 8, 4)
    with pytest.raises(ValueError, match="no launch with 3 lanes"):
        sk._launch(*(torch.from_numpy(a) for a in args), 3)


def test_cpu_call_takes_the_plain_version_and_counts_nothing(no_build):
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(1), 2, 5, 8, 4)]
    before = (sk.ssm_scan.launches, dict(sk.ssm_scan.lane_launches))
    y, h = sk.ssm_scan(*args)
    y32, h32 = sk.ssm_scan_ref(*args)
    assert torch.equal(y, y32) and torch.equal(h, h32)
    assert (sk.ssm_scan.launches, sk.ssm_scan.lane_launches) == before


# ---------------------------------------------------------------------------
# the lane-split scan, emulated
# ---------------------------------------------------------------------------

def _inputs(rng, B, T, D, N, h0_scale=1.0):
    dt = (rng.uniform(size=(B, T, D)) * 0.1 + 1e-3).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    A = (-rng.uniform(size=(D, N)) * 16 - 0.5).astype(np.float32)
    h0 = (rng.normal(size=(B, D, N)) * h0_scale).astype(np.float32)
    return dt, Bm, Cm, x, A, h0


def _lane_sum(prod, lanes):
    """y from the (B, D, NS) products h * C as the kernel sums them: each
    lane's NSL states in NP = min(NSL, 4) interleaved fp32 sums, joined as
    (p0 + p1) + (p2 + p3); then the lanes by xor shuffles at distance 1,
    then 2: ((l0 + l1) + (l2 + l3))."""
    NSL = prod.shape[-1] // lanes
    part_of_lane = []
    for lane in range(lanes):
        mine = prod[..., lane * NSL:(lane + 1) * NSL]
        NP = min(NSL, 4)
        parts = [mine[..., j] for j in range(NP)]
        for i in range(NP, NSL):
            parts[i % NP] = parts[i % NP] + mine[..., i]
        if NP == 4:
            part_of_lane.append((parts[0] + parts[1]) + (parts[2] + parts[3]))
        elif NP == 2:
            part_of_lane.append(parts[0] + parts[1])
        else:
            part_of_lane.append(parts[0])
    while len(part_of_lane) > 1:   # distance 1 pairs (0, 1), (2, 3); then distance 2
        part_of_lane = [part_of_lane[i] + part_of_lane[i + 1]
                        for i in range(0, len(part_of_lane), 2)]
    return part_of_lane[0]


def _emulate_ring(dt, Bm, Cm, x, A, h0, lanes):
    """ssm_scan_ring_kernel's arithmetic in fp32: padded states (A = 0, B =
    C = 0, h0 = 0: they stay 0), exp2(dt * (A log2 e)), the update
    exp * h + (dt x) B, y summed as :func:`_lane_sum`."""
    B, T, D = dt.shape
    N = A.shape[1]
    pad = _padded(N) - N

    def padn(a):
        return torch.nn.functional.pad(torch.from_numpy(a), (0, pad))

    dt_, x_ = torch.from_numpy(dt), torch.from_numpy(x)
    Bp, Cp, h = padn(Bm), padn(Cm), padn(h0)
    a2 = padn(A) * LOG2E
    ys = []
    for t in range(T):
        dtv = dt_[:, t, :, None]
        dtx = (dt_[:, t] * x_[:, t])[..., None]
        h = torch.exp2(dtv * a2) * h + dtx * Bp[:, t, None, :]
        ys.append(_lane_sum(h * Cp[:, t, None, :], lanes))
    return torch.stack(ys, dim=1), h[..., :N]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("B,T,D,N", [(2, 37, 129, 5), (1, 24, 72, 13), (2, 20, 96, 16),
                                     (3, 1, 129, 5), (2, 1, 64, 16)])
def test_lane_split_scan_matches_the_reference_kernel(lanes, B, T, D, N):
    """N = 5, 13, 16 (padded to 8, 16, 16), a ragged D, T off the 16-step
    run and T = 1: 1e-5 of the scale, as the card holds the kernel."""
    arrs = _inputs(np.random.default_rng(B * T * D * N), B, T, D, N)
    j = [jnp.asarray(a) for a in arrs]
    yk, hk = ref_ssm_scan(*j, block_d=D, interpret=True)
    yr, hr = ref.ssm_scan_ref(*j)
    y, h = _emulate_ring(*arrs, lanes)
    scale = max(1.0, float(np.abs(np.asarray(yr)).max()), float(np.abs(np.asarray(hr)).max()))
    for got, want in ((y, yk), (y, yr), (h, hk), (h, hr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    # and the port's plain version, which the card holds the kernel against
    y32, h32 = sk.ssm_scan_ref(*(torch.from_numpy(a) for a in arrs))
    np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(h.numpy(), h32.numpy(), rtol=0, atol=1e-5 * scale)


def test_probe_cuts_still_match_the_kernel_sources():
    """kernels/probe.py times the scan and the dense gossip kernel with parts
    cut out of their sources; each cut must find its code exactly once."""
    from repro_torch.kernels import build, probe

    for (name, variant), cuts in probe.CUTS.items():
        text = (build.CSRC / f"{name}.cu").read_text()
        for old, _ in cuts:
            assert text.count(old) == 1, (name, variant)
