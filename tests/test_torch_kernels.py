"""The CUDA kernels against their plain PyTorch versions, on the card:
the dense and the gather screens exact (NaN-aware ``==``) up to 64 rows on
edge-case payloads (the trimmed mean in both its divisor forms); above,
the wide path (up to its 2048 rows, at every warp sort it compiles) and
the register kernels exact against the plain arithmetic summed left to
right, the median exact, the trimmed mean within the float32 summation
bound of the plain version; the gather screens under every plan on
small-world and Erdos-Renyi tables; the int8-codeword screens exact
against their plain versions and against their staged twins (the
``dequant`` kernel, then the float screen), the int8 decode exact in both
its forms (the plain one also at odd widths and on a misaligned base), the
pairwise distances within the float32 dot-product bound
(``test_torch_krum.py``) with exact symmetry, an exact zero diagonal and
the NaN/inf pattern kept; the views screens (the network runtime's, over
each node's own mailbox views) exact up to 63 slots, a receiver stride of
0 and starved nodes included, and above on the wide path; the screens'
decide form (y and the per-edge trim fractions) exact against its plain
twins, refusing above the register networks.

This file imports nothing of JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_kernels.py

Without a card every test here skips (the kernels have no CPU mode; their
plain versions are held to the reference in ``test_torch_screening.py``,
``test_torch_sparse.py`` and ``test_torch_comm.py``).  It also holds the
edge-case input recipes the CPU parity tests share.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    build, dequant, dequant_screen, gather_screen, median, networks, pairwise, ref, screen_decide,
    screen_wide, trimmed_mean, views_screen)


def edge_inputs(n: int, d: int, seed: int):
    """``w [n, d]`` with NaN, +-inf, 1e30, ties and +-0 payloads, and an
    adjacency whose first rows are starved (0, 1 and 2 in-neighbors, so
    count < 2b + 1 for b >= 1)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, d)).astype(np.float32)
    w[:, : d // 4] = np.round(w[:, : d // 4])  # ties
    for frac, val in ((0.05, np.nan), (0.03, np.inf), (0.03, -np.inf), (0.05, 1e30),
                      (0.03, -1e30), (0.04, -0.0), (0.04, 0.0)):
        w[rng.random((n, d)) < frac] = val
    adj = rng.random((n, n)) < 0.5
    for j, deg in enumerate((0, 1, 2)[: n - 1]):
        adj[j] = False
        adj[j, rng.choice([i for i in range(n) if i != j], size=min(deg, n - 1), replace=False)] = True
    np.fill_diagonal(adj, False)
    return w, adj


def sparse_inputs(k: int, d: int, seed: int):
    """``w [n, d]`` with the `edge_inputs` payloads and an adjacency of
    in-degree at most ``k - 2`` (so a width-``k`` table has padded slots on
    every row), the first rows starved (0, 1, 2 senders)."""
    n = max(k + 8, 20)
    w, _ = edge_inputs(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    adj = np.zeros((n, n), bool)
    for j in range(n):
        deg = (0, 1, 2)[j] if j < 3 else int(rng.integers(3, max(k - 1, 4)))
        others = np.array([i for i in range(n) if i != j])
        adj[j, rng.choice(others, size=min(deg, max(k - 2, 0)), replace=False)] = True
    return w, adj


def codeword(n: int, d: int, seed: int):
    """int8 codes (the first five of every row zero) and ``[n, S, 2]``
    scales of several magnitudes, with +-inf and zero scales, nonzero zero
    terms, and one row whose zero terms are all 0."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    q[:, :5] = 0
    s = -(-d // 128)
    scale = np.stack([(rng.uniform(0.001, 0.1, size=(n, s)) * 10.0 ** rng.integers(-3, 3, size=(n, s))),
                      rng.normal(size=(n, s))], -1).astype(np.float32)
    scale[0, 0, 0] = np.inf
    scale[1, 0, 0] = -np.inf
    scale[2, 0] = 0.0
    scale[3, :, 1] = 0.0
    return q, scale


U32 = 2.0 ** -24


def dist_rows(n: int, d: int, seed: int, *, special: bool = True) -> np.ndarray:
    """Rows for the distance tests: normal rows of scales 0.1-10, and (with
    ``special``) a NaN row, a +inf and a -inf entry."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.1, 10.0, size=(n, 1)).astype(
        np.float32)
    if special:
        x[1] = np.nan
        x[2, 3] = np.inf
        x[3, 0] = -np.inf
    return x


def dist_bound(x: np.ndarray) -> np.ndarray:
    """The float32 dot-product bound ``4 d 2^-24 (sq_i + sq_j)`` per entry."""
    x64 = np.where(np.isfinite(x), x, 0.0).astype(np.float64)
    sq = np.sum(x64 * x64, axis=1)
    return 4.0 * x.shape[1] * U32 * (sq[:, None] + sq[None, :])


def check_within_bound(got: np.ndarray, want: np.ndarray, x: np.ndarray) -> float:
    """Same non-finite pattern, finite entries within `dist_bound`; returns
    the largest |got - want| over the bound."""
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    np.testing.assert_array_equal(fin_g, fin_w)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~fin_g], want[~fin_w])
    bound = dist_bound(x)
    err = np.abs(got[fin_g].astype(np.float64) - want[fin_w])
    assert (err <= bound[fin_g]).all(), f"max excess {np.max(err - bound[fin_g])}"
    return float(np.max(err / np.maximum(bound[fin_g], 1e-300), initial=0.0))


def nan_equal(a, b):
    """Elementwise ``==`` under which NaN equals NaN (and +0 equals -0), for
    numpy arrays and torch tensors alike."""
    return (a == b) | ((a != a) & (b != b))


def test_cpu_wrappers_run_plain_versions_without_launching():
    w, adj = edge_inputs(12, 40, seed=5)
    tw, ta = torch.from_numpy(w), torch.from_numpy(adj)
    before = (trimmed_mean.trimmed_mean_dense.launches, median.median_dense.launches)
    out_t = trimmed_mean.trimmed_mean_dense(tw, ta, tw, 2)
    out_m = median.median_dense(tw, ta.to(torch.uint8), tw)
    assert nan_equal(out_t.numpy(), ref.trimmed_mean_dense(tw, ta, tw, 2).numpy()).all()
    assert nan_equal(out_m.numpy(), ref.median_dense(tw, ta, tw).numpy()).all()
    assert (trimmed_mean.trimmed_mean_dense.launches, median.median_dense.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "mask_shape", "contiguous", "b"])
def test_wrappers_reject_bad_operands(bad):
    w = torch.zeros(6, 10)
    adj = torch.zeros(6, 6, dtype=torch.bool)
    sv = w
    b = 1
    if bad == "dtype":
        w = w.double()
    elif bad == "shape":
        sv = torch.zeros(6, 11)
    elif bad == "mask_dtype":
        adj = adj.float()
    elif bad == "mask_shape":
        adj = torch.zeros(6, 5, dtype=torch.bool)
    elif bad == "contiguous":
        w = torch.zeros(10, 6).t()
    elif bad == "b":
        b = -1
    with pytest.raises((TypeError, ValueError)):
        trimmed_mean.trimmed_mean_dense(w, adj, sv, b)
    if bad != "b":
        with pytest.raises((TypeError, ValueError)):
            median.median_dense(w, adj, sv)


def test_build_is_lazy_and_needs_nvcc(monkeypatch, tmp_path):
    """Importing the kernels builds nothing; a build without ``nvcc`` raises
    instead of leaving a half-written library behind."""
    assert "libscreen" in build.library_path().name
    assert build.library_path().name.endswith(f"{build.source_hash()}.so")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not any(tmp_path.rglob("*.so"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their plain versions are "
                    "held to the reference in test_torch_screening.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 12, 20, 50, 64])
def test_kernels_equal_plain_on_card(cuda_device, n):
    w, adj = edge_inputs(n, 999, seed=n)
    tw, ta = torch.from_numpy(w).to(cuda_device), torch.from_numpy(adj).to(cuda_device)
    for b in (0, 1, 2, 4):
        got = trimmed_mean.trimmed_mean_dense(tw, ta, tw, b).cpu().numpy()
        assert nan_equal(got, ref.trimmed_mean_dense(tw, ta, tw, b).cpu().numpy()).all()
    got = median.median_dense(tw, ta, tw).cpu().numpy()
    assert nan_equal(got, ref.median_dense(tw, ta, tw).cpu().numpy()).all()


@pytest.mark.cuda
def test_kernels_reject_too_many_rows(cuda_device):
    """One row above the wide path's limit: M + 1 senders for the trimmed
    mean, M for the median (whose own value is a row)."""
    build.load()  # the report below is the build's, whichever test runs first
    m = screen_wide.MAX_ROWS + 1
    w = torch.zeros(m, 8, device=cuda_device)
    adj = torch.zeros(m, m, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        trimmed_mean.trimmed_mean_dense(w, adj, w, 1)
    with pytest.raises(ValueError):
        median.median_dense(w[:-1].contiguous(), adj[:-1, :-1].contiguous(), w[:-1].contiguous())
    assert build.ptxas_report()


def summation_bound(w, adj, b):
    """Float32 bound on two summation orders of the kept ranks plus self,
    after the division (above 64 rows the plain version sums with
    ``torch.sum``, the kernel left to right)."""
    count = adj.sum(dim=1).to(torch.float32)
    b_eff = torch.clamp(torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0), max=b)
    den = count - 2 * b_eff + 1
    colmax = torch.where(torch.isfinite(w), w.abs(), 0.0).max(dim=0).values[None, :]
    eps = torch.finfo(torch.float32).eps
    return 2.0 * w.shape[0] * eps * colmax * (count[:, None] + 1.0) / den[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [0, 2, 4])
def test_trimmed_mean_above_64_rows_on_card(cuda_device, b):
    w, adj = (torch.from_numpy(x).to(cuda_device) for x in edge_inputs(100, 777, seed=b))
    got = trimmed_mean.trimmed_mean_dense(w, adj, w, b)
    want = ref.trimmed_mean_dense(w, adj, w, b)
    finite = torch.isfinite(got) & torch.isfinite(want)
    assert bool(nan_equal(got[~finite], want[~finite]).all())
    assert bool(((got - want).abs()[finite] <= summation_bound(w, adj, b)[finite]).all())
    got_m = median.median_dense(w, adj, w)
    assert bool(nan_equal(got_m, ref.median_dense(w, adj, w)).all())


@pytest.mark.cuda
def test_separate_self_vals_on_card(cuda_device):
    w, adj = (torch.from_numpy(x).to(cuda_device) for x in edge_inputs(40, 513, seed=9))
    sv = torch.randn(w.shape, generator=torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    sv[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    assert bool(nan_equal(trimmed_mean.trimmed_mean_dense(w, adj, sv, 3),
                          ref.trimmed_mean_dense(w, adj, sv, 3)).all())
    assert bool(nan_equal(median.median_dense(w, adj, sv), ref.median_dense(w, adj, sv)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_trainer_step_launches_its_kernel_once(cuda_device, rule):
    from repro_torch.core.bridge import BridgeConfig, BridgeTrainer
    from repro_torch.core.graph import erdos_renyi
    from repro_torch.sim.tasks import linear_task

    task = linear_task(12, partition="iid", num_train=600, num_test=100, device=cuda_device)
    cfg = BridgeConfig(topology=erdos_renyi(12, 0.6, 2, seed=0), rule=rule, num_byzantine=2,
                       attack="random", t0=30)
    trainer = BridgeTrainer(cfg, task.grad_fn, device=cuda_device)
    state = trainer.init(task.init_fn(0))
    kernel = {"trimmed_mean": trimmed_mean.trimmed_mean_dense, "median": median.median_dense}[rule]
    before = kernel.launches
    for i in range(3):
        state, metrics = trainer.step(state, task.batch_fn(i))
    assert kernel.launches - before == 3
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 40, 63])
def test_gather_kernels_equal_plain_on_card(cuda_device, k):
    from repro_torch.core.neighbors import NeighborTable

    w, adj = sparse_inputs(k, 999, seed=k)
    table = NeighborTable.from_adjacency(adj, k=k, device=cuda_device)
    tw = torch.from_numpy(w).to(cuda_device)
    sv = torch.randn(tw.shape, generator=torch.Generator(device=cuda_device).manual_seed(k),
                     device=cuda_device)
    sv[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    for self_vals in (tw, sv):
        for b in (0, 1, 2, 4):
            got = gather_screen.gather_screen_trimmed_mean(tw, table.safe_idx, table.valid_dev,
                                                           self_vals, b)
            want = ref.gather_trimmed_mean(tw, table.safe_idx, table.valid_dev, self_vals, b)
            assert bool(nan_equal(got, want).all())
        got = gather_screen.gather_screen_median(tw, table.safe_idx, table.valid_dev, self_vals)
        want = ref.gather_median(tw, table.safe_idx, table.valid_dev, self_vals)
        assert bool(nan_equal(got, want).all())


@pytest.mark.cuda
def test_gather_kernels_reject_wide_tables(cuda_device):
    """One slot above the wide path's limit (K + 1 rows for the median)."""
    k = screen_wide.MAX_ROWS + 1
    w = torch.zeros(70, 8, device=cuda_device)
    idx = torch.zeros(70, k, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(70, k, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        gather_screen.gather_screen_trimmed_mean(w, idx, valid, w, 1)
    with pytest.raises(ValueError):
        gather_screen.gather_screen_median(w, idx[:, :-1].contiguous(), valid[:, :-1].contiguous(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4, 300), (512, 7850), (2500, 7850), (70000, 130)])
def test_dequant_kernels_equal_plain_on_card(cuda_device, n, d):
    """Also at the dense runtime's per-link rows (M W = 2500) and above
    gridDim.y's 65535, where a carry block takes more than one row."""
    q, scale = (torch.from_numpy(x).to(cuda_device) for x in codeword(n, d, seed=d))
    assert bool(nan_equal(dequant.dequant(q, scale), ref.dequant(q, scale)).all())
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    est = torch.randn((n, d), generator=gen, device=cuda_device)
    target = torch.randn((n, d), generator=gen, device=cuda_device) * 1e-3
    for sc in (scale, torch.stack([scale[..., 0], torch.zeros_like(scale[..., 0])], -1)):
        for folded in (True, False):
            x_hat, resid = dequant.dequant_carry(q, sc.contiguous(), est, target, folded)
            want_x, want_r = ref.dequant_carry(q, sc.contiguous(), est, target, folded)
            assert bool(nan_equal(x_hat, want_x).all()) and bool(nan_equal(resid, want_r).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4, 300), (50, 7850), (3, 129)])
def test_dequant_keep_nan_on_card(cuda_device, n, d):
    """The NaN-keeping form (the sharded gossip's decode): a NaN scale, and
    an inf scale times a zero code, stay NaN; every other product is the
    default form's, which maps those NaN to +inf."""
    q, scale = codeword(max(n, 4), d, seed=n + d)
    q, scale = q[:n], scale[:n].copy()
    scale[n - 1, -1, 0] = np.nan
    q, scale = (torch.from_numpy(x).to(cuda_device) for x in (q, scale))
    kept = dequant.dequant(q, scale, keep_nan=True)
    assert bool(nan_equal(kept, ref.dequant(q, scale, keep_nan=True)).all())
    assert bool(torch.isnan(kept[0, :5]).all()) and bool(torch.isnan(kept[n - 1, -1]))
    plain = dequant.dequant(q, scale)
    nan = torch.isnan(kept)
    assert bool((plain[nan] == torch.inf).all()) and bool(nan_equal(plain[~nan], kept[~nan]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 127, 128, 129, 3925, 7850])
def test_dequant_odd_shapes_on_card(cuda_device, d):
    """The decode walks the flat [n * d] codes in groups of 4: exact at row
    widths that split a group across rows (d < 4), across scale blocks and
    at no 16-byte alignment of a row, and on codes whose base sits 1, 4 or
    8 bytes past a 16-byte boundary (a contiguous view at a storage offset:
    the kernel's scalar head, then groups, with scalar stores where out is
    not 16-byte aligned at a group)."""
    for n in (1, 3, 50, 512):
        q, scale = (torch.from_numpy(x[:n]).to(cuda_device) for x in codeword(max(n, 4), d, n + d))
        assert bool(nan_equal(dequant.dequant(q, scale), ref.dequant(q, scale)).all()), n
        for offset in (1, 4, 8):
            base = torch.empty(n * d + offset, dtype=torch.int8, device=cuda_device)
            moved = base[offset:].view(n, d)
            moved.copy_(q)
            assert moved.data_ptr() % 16 == offset
            got = dequant.dequant(moved, scale)
            assert bool(nan_equal(got, ref.dequant(q, scale)).all()), (n, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("rule,codec", [("trimmed_mean", "identity"), ("median", "identity"),
                                        ("trimmed_mean", "int8")])
def test_sparse_trainer_launches_its_kernels(cuda_device, rule, codec):
    from repro_torch.core.bridge import BridgeConfig, BridgeTrainer
    from repro_torch.core.graph import small_world
    from repro_torch.sim.tasks import linear_task

    task = linear_task(40, partition="iid", num_train=800, num_test=100, device=cuda_device)
    cfg = BridgeConfig(topology=small_world(40, 3, 1, seed=0), rule=rule, num_byzantine=1,
                       attack="random", t0=30, sparse=True, codec=codec)
    trainer = BridgeTrainer(cfg, task.grad_fn, device=cuda_device)
    state = trainer.init(task.init_fn(0))
    kernel = {"trimmed_mean": gather_screen.gather_screen_trimmed_mean,
              "median": gather_screen.gather_screen_median}[rule]
    before = (kernel.launches, dequant.dequant_carry.launches,
              trimmed_mean.trimmed_mean_dense.launches, median.median_dense.launches)
    for i in range(3):
        state, metrics = trainer.step(state, task.batch_fn(i))
    after = (kernel.launches, dequant.dequant_carry.launches,
             trimmed_mean.trimmed_mean_dense.launches, median.median_dense.launches)
    assert after[0] - before[0] == 3
    assert after[1] - before[1] == (3 if codec == "int8" else 0)
    assert after[2:] == before[2:]
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(5, 100), (50, 7850), (100, 7850), (130, 1000), (512, 7850)])
def test_pairwise_kernel_equals_plain_on_card(cuda_device, n, d):
    x = dist_rows(n, d, seed=n)
    x[4] = 1e30
    tx = torch.from_numpy(x).to(cuda_device)
    before = pairwise.pairwise_sq_dists.launches
    got = pairwise.pairwise_sq_dists(tx)
    torch.cuda.synchronize()
    assert pairwise.pairwise_sq_dists.launches == before + 1
    got = got.cpu().numpy()
    want = ref.pairwise_sq_dists(tx).cpu().numpy()
    np.testing.assert_array_equal(got, got.T)
    finite_rows = np.isfinite(x).all(axis=1) & (np.abs(x).max(axis=1) < 1e18)
    assert (np.diagonal(got)[finite_rows] == 0.0).all()
    check_within_bound(got, want, x)


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("rule", ["krum", "bulyan"])
def test_vector_rules_launch_the_distance_kernel_once_a_tick(cuda_device, rule, sparse):
    from repro_torch.core.bridge import BridgeConfig, BridgeTrainer
    from repro_torch.core.graph import erdos_renyi
    from repro_torch.sim.tasks import linear_task

    task = linear_task(20, partition="iid", num_train=600, num_test=100, device=cuda_device)
    cfg = BridgeConfig(topology=erdos_renyi(20, 1.0, 2, seed=0), rule=rule, num_byzantine=2,
                       attack="random", sparse=sparse)
    trainer = BridgeTrainer(cfg, task.grad_fn, device=cuda_device)
    state = trainer.init(task.init_fn(0))
    tm = gather_screen.gather_screen_trimmed_mean if sparse else trimmed_mean.trimmed_mean_dense
    before = (pairwise.pairwise_sq_dists.launches, tm.launches)
    for i in range(3):
        state, metrics = trainer.step(state, task.batch_fn(i))
    torch.cuda.synchronize()
    assert pairwise.pairwise_sq_dists.launches - before[0] == 3
    assert tm.launches - before[1] == (3 if rule == "bulyan" else 0)
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 20, 50, 64])
def test_trimmed_mean_reciprocal_form_on_card(cuda_device, n):
    w, adj = edge_inputs(n, 999, seed=n + 3)
    tw, ta = torch.from_numpy(w).to(cuda_device), torch.from_numpy(adj).to(cuda_device)
    for b in (0, 2):
        got = trimmed_mean.trimmed_mean_dense(tw, ta, tw, b, recip=True)
        assert bool(nan_equal(got, ref.trimmed_mean_dense(tw, ta, tw, b, recip=True)).all())


def card_codewords(n: int, d: int, seed: int, device):
    """Random codewords (inf and zero scales, nonzero zero terms, codes of
    -128) and the int8 codec's own codewords of a seeded bank, with self
    values carrying NaN and +-inf."""
    from repro_torch.comm import codec

    q, scale = codeword(n, d, seed)
    q[4 % n, :7] = -128
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.05).astype(np.float32)
    msg = codec.get_codec("int8").encode(np.array([0, seed], np.uint32),
                                         torch.from_numpy(x).to(device))
    sv = rng.normal(size=(n, d)).astype(np.float32)
    sv[0, :3] = [np.nan, np.inf, -np.inf]
    sv = torch.from_numpy(sv).to(device)
    return [(torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device), sv),
            (msg.payload, msg.scale, sv)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(5, 130), (20, 1000), (50, 7850), (64, 999), (100, 777)])
def test_dense_codeword_screens_on_card(cuda_device, n, d):
    _, adj = edge_inputs(n, 4, seed=n)
    ta = torch.from_numpy(adj).to(cuda_device)
    for q, scale, sv in card_codewords(n, d, n + d, cuda_device):
        before = (dequant_screen.dequant_screen_trimmed_mean_dense.launches,
                  dequant_screen.dequant_screen_median_dense.launches)
        tm = dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, ta, sv, 2)
        md = dequant_screen.dequant_screen_median_dense(q, scale, ta, sv)
        torch.cuda.synchronize()
        assert (dequant_screen.dequant_screen_trimmed_mean_dense.launches,
                dequant_screen.dequant_screen_median_dense.launches) == (before[0] + 1,
                                                                         before[1] + 1)
        staged = dequant.dequant(q, scale)
        assert bool(nan_equal(md, median.median_dense(staged, ta, sv)).all())
        assert bool(nan_equal(md, ref.dequant_median_dense(q, scale, ta, sv)).all())
        if n <= 64:  # above, the plain trimmed mean sums with torch.sum
            assert bool(nan_equal(tm, ref.dequant_trimmed_mean_dense(q, scale, ta, sv, 2)).all())
        assert bool(nan_equal(tm, trimmed_mean.trimmed_mean_dense(staged, ta, sv, 2)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 40, 63])
def test_gather_codeword_screens_on_card(cuda_device, k):
    from repro_torch.core.neighbors import NeighborTable

    _, adj = sparse_inputs(k, 4, seed=k)
    n = adj.shape[0]
    table = NeighborTable.from_adjacency(adj, k=k, device=cuda_device)
    for q, scale, sv in card_codewords(n, 1000, k, cuda_device):
        args = (q, scale, table.safe_idx, table.valid_dev, sv)
        tm = gather_screen.gather_dequant_screen_trimmed_mean(*args, 2)
        md = gather_screen.gather_dequant_screen_median(*args)
        staged = dequant.dequant(q, scale)
        assert bool(nan_equal(tm, ref.gather_dequant_trimmed_mean(*args, 2)).all())
        assert bool(nan_equal(md, ref.gather_dequant_median(*args)).all())
        assert bool(nan_equal(tm, gather_screen.gather_screen_trimmed_mean(
            staged, table.safe_idx, table.valid_dev, sv, 2)).all())
        assert bool(nan_equal(md, gather_screen.gather_screen_median(
            staged, table.safe_idx, table.valid_dev, sv)).all())


@pytest.mark.cuda
def test_codeword_screens_reject_what_they_do_not_take(cuda_device):
    m = screen_wide.MAX_ROWS  # M + 1 rows to sort for the median: one above the limit
    q = torch.zeros(m, 256, dtype=torch.int8, device=cuda_device)
    scale = torch.ones(m, 2, 2, device=cuda_device)
    sv = torch.zeros(m, 256, device=cuda_device)
    adj = torch.zeros(m, m, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        dequant_screen.dequant_screen_median_dense(q, scale, adj, sv)
    idx = torch.zeros(m, m + 1, dtype=torch.int32, device=cuda_device)
    valid = torch.ones(m, m + 1, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        gather_screen.gather_dequant_screen_trimmed_mean(q, scale, idx, valid, sv, 1)
    with pytest.raises(ValueError):  # operands on two devices
        dequant_screen.dequant_screen_trimmed_mean_dense(q[:5, :].contiguous(), scale[:5].cpu(),
                                                         adj[:5, :5].contiguous(), sv[:5], 1)


# Row counts at every boundary of the sorting networks' buckets (b - 1, b,
# b + 1), grouped by bucket: the trimmed mean sorts `count` rows, the
# median `count + 1`.
BOUNDARY_ROWS = [tuple(r for r in (b - 1, b, b + 1) if r <= networks.MAX_ROWS)
                 for b in networks.BUCKETS]


def boundary_adjacency(rows, median_rows: bool, seed: int):
    """An ``[m, m]`` mask whose node j has ``rows[j % len(rows)]`` rows to
    sort (one fewer senders for the median, whose own value is a row),
    senders drawn with self-loops allowed so a count can reach m; m as
    large as the kernels take, at most 8 above the largest count."""
    counts = [r - 1 if median_rows else r for r in rows]
    limit = networks.MAX_ROWS - 1 if median_rows else networks.MAX_ROWS
    m = min(limit, max(counts) + 8)
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        adj[j, rng.choice(m, size=counts[j % len(counts)], replace=False)] = True
    return adj


def left_to_right_trimmed_mean(w, adj, self_vals, b, recip=False):
    """`ref.trimmed_mean_dense` with the kept ranks summed left to right for
    any M (the plain version sums with ``torch.sum`` above 64 rows, as the
    reference does): the kernel's order, for exact checks above 64 rows."""
    mask = adj.bool()
    count = mask.sum(dim=1)
    b_eff = ref.effective_trim(b, count)
    order = torch.sort(torch.where(mask[:, :, None], ref.sanitize(w)[None], torch.inf), dim=1).values
    total = torch.zeros_like(self_vals)
    for i in range(mask.shape[1]):
        keep = (i >= b_eff) & (i < count - b_eff)
        total = total + torch.where(keep[:, None], order[:, i], 0.0)
    den = (count - 2 * b_eff + 1).to(torch.float32)[:, None]
    return (total + self_vals) * (1.0 / den) if recip else (total + self_vals) / den


@pytest.mark.cuda
@pytest.mark.parametrize("rows", BOUNDARY_ROWS, ids=lambda r: f"rows{r[0]}-{r[-1]}")
def test_dense_screens_at_bucket_boundaries_on_card(cuda_device, rows):
    """The four dense entries, exact, on nodes whose row counts sit at a
    network bucket's boundary: float rows with NaN, +-inf, ties and +-0,
    and codewords with inf and zero scales."""
    for median_rows in (False, True):
        adj = boundary_adjacency(rows, median_rows, seed=rows[0])
        m = adj.shape[0]
        w, _ = edge_inputs(m, 300, seed=rows[0] + 1)
        sv = np.random.default_rng(rows[0]).normal(size=(m, 300)).astype(np.float32)
        sv[0, :3] = [np.nan, np.inf, -np.inf]
        tw, ta, tsv = (torch.from_numpy(x).to(cuda_device) for x in (w, adj, sv))
        cw = [tuple(torch.from_numpy(x).to(cuda_device) for x in codeword(m, 300, seed=rows[0]))]
        if median_rows:
            assert bool(nan_equal(median.median_dense(tw, ta, tsv), ref.median_dense(tw, ta, tsv)).all())
            for q, scale in cw:
                got = dequant_screen.dequant_screen_median_dense(q, scale, ta, tsv)
                assert bool(nan_equal(got, ref.dequant_median_dense(q, scale, ta, tsv)).all())
            continue
        for b in (0, 3):
            got = trimmed_mean.trimmed_mean_dense(tw, ta, tsv, b)
            assert bool(nan_equal(got, left_to_right_trimmed_mean(tw, ta, tsv, b)).all())
            if m <= ref.MAX_EXACT_ROWS:
                assert bool(nan_equal(got, ref.trimmed_mean_dense(tw, ta, tsv, b)).all())
            for q, scale in cw:
                got = dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, ta, tsv, b)
                want = left_to_right_trimmed_mean(ref.dequant(q, scale), ta, tsv, b)
                assert bool(nan_equal(got, want).all())


def table_graph(kind: str, m: int, k: int, seed: int) -> np.ndarray:
    """An ``[m, m]`` in-neighbor mask of in-degree at most ``k`` (one node
    starved): ``small_world``, a ring lattice of the nearest ``k // 2``
    senders with 20% of the edges rewired at random, so consecutive nodes
    share most rows; ``erdos_renyi``, each node's ``k // 2`` to ``k``
    senders drawn at random, so they share few."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(1, m):
        if kind == "small_world":
            near = [(j + o) % m for o in range(-(k // 2), k - k // 2 + 1) if o != 0][:k]
            senders = [i if rng.random() >= 0.2 else int(rng.integers(m)) for i in near]
        else:
            senders = rng.choice(m, size=int(rng.integers(k // 2, k + 1)), replace=False)
        adj[j, senders] = True
        adj[j, j] = False
    return adj


def gather_plans(m: int, k: int, d: int, row_bytes: int, median: bool):
    """`tile_plan`'s choice (None: through the wrapper), every candidate,
    and a plan of the other column count a lane where the kernel takes
    one."""
    plan = gather_screen.tile_plan(m, k, d, row_bytes, median)
    other = gather_screen.plan_for(4, 64, m, k, d, row_bytes, median, cols=3 - plan.cols)
    return [None, *gather_screen.candidates(m, k, d, row_bytes, median),
            *([other] if other else [])]


def gather_under(plan, wrapper, rows, idx, valid, sv, *b):
    """The wrapper's result (plan None) or its tile kernel's under ``plan``."""
    if plan is None:
        return wrapper(*rows, idx, valid, sv, *b)
    return gather_screen.launch_tile(wrapper.__name__, plan, rows, idx, valid, sv, *b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["small_world", "erdos_renyi"])
@pytest.mark.parametrize("k", [3, 16, 20, 40, 63])
def test_gather_tile_kernels_on_graph_tables(cuda_device, kind, k):
    """The four gather entries, exact against their plain versions (and the
    codeword forms against dequant-then-screen) under every plan, on
    tables that share rows and tables that do not, with separate
    self_vals, at a node count that leaves a ragged tile and an odd d."""
    from repro_torch.core.neighbors import NeighborTable

    m = 300
    table = NeighborTable.from_adjacency(table_graph(kind, m, k, seed=k), k=k, device=cuda_device)
    idx, valid = table.safe_idx, table.valid_dev
    for d in (999, 1000):
        w, _ = edge_inputs(m, d, seed=k + d)
        tw = torch.from_numpy(w).to(cuda_device)
        sv = torch.randn(tw.shape, generator=torch.Generator(device=cuda_device).manual_seed(k),
                         device=cuda_device)
        sv[0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        want_tm = ref.gather_trimmed_mean(tw, idx, valid, sv, 2)
        want_md = ref.gather_median(tw, idx, valid, sv)
        for plan in gather_plans(m, k, d, 4, False):
            got = gather_under(plan, gather_screen.gather_screen_trimmed_mean, (tw,), idx, valid,
                               sv, 2)
            assert bool(nan_equal(got, want_tm).all()), plan
        for plan in gather_plans(m, k, d, 4, True):
            got = gather_under(plan, gather_screen.gather_screen_median, (tw,), idx, valid, sv)
            assert bool(nan_equal(got, want_md).all()), plan
        for q, scale, csv in card_codewords(m, d, k, cuda_device):
            staged = dequant.dequant(q, scale)
            want_tm = ref.gather_trimmed_mean(staged, idx, valid, csv, 2)
            want_md = ref.gather_median(staged, idx, valid, csv)
            for plan in gather_plans(m, k, d, 1, False):
                got = gather_under(plan, gather_screen.gather_dequant_screen_trimmed_mean,
                                   (q, scale), idx, valid, csv, 2)
                assert bool(nan_equal(got, want_tm).all()), plan
            for plan in gather_plans(m, k, d, 1, True):
                got = gather_under(plan, gather_screen.gather_dequant_screen_median, (q, scale),
                                   idx, valid, csv)
                assert bool(nan_equal(got, want_md).all()), plan


def wide_bound(rows: torch.Tensor, mask: torch.Tensor, self_vals: torch.Tensor, b: int):
    """The float32 summation bound between two orders of the kept ranks of
    ``n`` rows plus self, after the division (the wide path sums left to
    right, the plain version above 64 rows with ``torch.sum``)."""
    count = mask.sum(dim=1).to(torch.float32)
    b_eff = ref.effective_trim(b, mask.sum(dim=1)).to(torch.float32)
    fin = lambda x: torch.where(torch.isfinite(x), x.abs(), 0.0)
    colmax = torch.maximum(fin(rows).amax(dim=(0, 1))[None, :], fin(self_vals))
    eps = torch.finfo(torch.float32).eps
    return 2.0 * mask.shape[1] * eps * colmax * (count[:, None] + 1.0) / (count - 2 * b_eff + 1)[:, None]


def check_wide_trimmed_mean(got, want_ltr, want_plain, bound):
    """Exact against the plain arithmetic summed left to right; within the
    bound of the plain version where both are finite, equal elsewhere."""
    assert bool(nan_equal(got, want_ltr).all())
    fin = torch.isfinite(got) & torch.isfinite(want_plain)
    assert bool(nan_equal(got[~fin], want_plain[~fin]).all())
    assert bool(((got - want_plain).abs()[fin] <= bound[fin]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [129, 200, 513, 1024])
def test_wide_dense_screens_on_card(cuda_device, m):
    """The dense screens above 128 rows go through the wide path, float and
    codeword rows: the median exact, the trimmed mean exact against the
    left-to-right sum and within the summation bound of the plain version."""
    w, adj = edge_inputs(m, 300, seed=m)
    tw, ta = torch.from_numpy(w).to(cuda_device), torch.from_numpy(adj).to(cuda_device)
    sv = torch.randn(tw.shape, generator=torch.Generator(device=cuda_device).manual_seed(m),
                     device=cuda_device)
    before = (screen_wide.launch.launches, trimmed_mean.trimmed_mean_dense.launches,
              median.median_dense.launches)
    for b in (0, 3):
        got = trimmed_mean.trimmed_mean_dense(tw, ta, sv, b)
        check_wide_trimmed_mean(got, left_to_right_trimmed_mean(tw, ta, sv, b),
                                ref.trimmed_mean_dense(tw, ta, sv, b), wide_bound(tw[None], ta, sv, b))
    got = trimmed_mean.trimmed_mean_dense(tw, ta, tw, 2, recip=True)
    assert bool(nan_equal(got, left_to_right_trimmed_mean(tw, ta, tw, 2, recip=True)).all())
    assert bool(nan_equal(median.median_dense(tw, ta, sv), ref.median_dense(tw, ta, sv)).all())
    for q, scale, csv in card_codewords(m, 300, m, cuda_device):
        staged = dequant.dequant(q, scale)
        got = dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, ta, csv, 3)
        check_wide_trimmed_mean(got, left_to_right_trimmed_mean(staged, ta, csv, 3),
                                ref.dequant_trimmed_mean_dense(q, scale, ta, csv, 3),
                                wide_bound(staged[None], ta, csv, 3))
        got = dequant_screen.dequant_screen_median_dense(q, scale, ta, csv)
        assert bool(nan_equal(got, ref.dequant_median_dense(q, scale, ta, csv)).all())
    torch.cuda.synchronize()
    assert screen_wide.launch.launches - before[0] == 8
    assert (trimmed_mean.trimmed_mean_dense.launches, median.median_dense.launches) == before[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 100, 200, 1023])
def test_wide_gather_screens_on_card(cuda_device, k):
    """The gather screens above 63 slots go through the wide path, float and
    codeword rows, with the tolerances of `test_wide_dense_screens_on_card`."""
    from repro_torch.core.neighbors import NeighborTable

    w, adj = sparse_inputs(k, 300, seed=k)
    table = NeighborTable.from_adjacency(adj, k=k, device=cuda_device)
    idx, valid = table.safe_idx, table.valid_dev
    tw = torch.from_numpy(w).to(cuda_device)
    ta = torch.from_numpy(adj).to(cuda_device)
    before = (screen_wide.launch.launches, gather_screen.gather_screen_trimmed_mean.launches)
    for rows in (tw, None):
        for q, scale, sv in ([(None, None, tw)] if rows is not None
                             else card_codewords(tw.shape[0], 300, k, cuda_device)):
            x = tw if rows is not None else dequant.dequant(q, scale)
            gathered = table.gather_rows(x)
            for b in (0, 3):
                got = (gather_screen.gather_screen_trimmed_mean(tw, idx, valid, sv, b) if q is None
                       else gather_screen.gather_dequant_screen_trimmed_mean(q, scale, idx, valid,
                                                                             sv, b))
                check_wide_trimmed_mean(got, left_to_right_trimmed_mean(x, ta, sv, b),
                                        ref.gather_trimmed_mean(x, idx, valid, sv, b),
                                        wide_bound(gathered, valid, sv, b))
            got = (gather_screen.gather_screen_median(tw, idx, valid, sv) if q is None
                   else gather_screen.gather_dequant_screen_median(q, scale, idx, valid, sv))
            assert bool(nan_equal(got, ref.gather_median(x, idx, valid, sv)).all())
    torch.cuda.synchronize()
    assert screen_wide.launch.launches - before[0] == 3 * 3
    assert gather_screen.gather_screen_trimmed_mean.launches == before[1]


def wide_boundary_rows(regs: int) -> tuple[int, ...]:
    """Rows to sort around the warp sort of ``regs`` registers a lane: one
    below, at and above 32 regs, within the wide path's limit."""
    return tuple(r for r in (32 * regs - 1, 32 * regs, 32 * regs + 1) if r <= screen_wide.MAX_ROWS)


def wide_counts_adjacency(counts, m: int, seed: int) -> np.ndarray:
    """An ``[m, m]`` mask whose node j has ``counts[j % len(counts)]``
    senders (self-loops allowed, so a count can reach m)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        adj[j, rng.choice(m, size=counts[j % len(counts)], replace=False)] = True
    return adj


@pytest.mark.cuda
@pytest.mark.parametrize("regs", networks.WARP_REGS)
def test_wide_screens_at_every_warp_width_on_card(cuda_device, regs):
    """Each warp sort the wide path compiles, on nodes whose row counts sit
    one below, at and one above its 32 R rows: the dense screens (M at
    least 129, so the wide path runs) and the gather screens (K at least
    64), float rows with NaN, +-inf, ties and +-0 and codewords with inf
    and zero scales; medians exact, trimmed means exact against the
    left-to-right sum and within the summation bound of the plain
    version."""
    from repro_torch.core.neighbors import NeighborTable

    d = 200
    rows = wide_boundary_rows(regs)
    before = screen_wide.launch.launches
    launched = 0
    for median_rows in (False, True):
        counts = [r - 1 if median_rows else r for r in rows]
        limit = screen_wide.MAX_ROWS - (1 if median_rows else 0)
        m = min(limit, max(129, max(counts) + 8))
        adj = wide_counts_adjacency(counts, m, seed=regs)
        w, _ = edge_inputs(m, d, seed=regs + 1)
        sv = np.random.default_rng(regs).normal(size=(m, d)).astype(np.float32)
        sv[0, :3] = [np.nan, np.inf, -np.inf]
        tw, ta, tsv = (torch.from_numpy(x).to(cuda_device) for x in (w, adj, sv))
        k = min(limit, max(64, max(counts)))
        table = NeighborTable.from_adjacency(adj, k=k, device=cuda_device)
        idx, valid = table.safe_idx, table.valid_dev
        q, scale = (torch.from_numpy(x).to(cuda_device) for x in codeword(m, d, seed=regs))
        staged = dequant.dequant(q, scale)
        for x, dense, gather in (
            (tw, (trimmed_mean.trimmed_mean_dense, median.median_dense),
             (gather_screen.gather_screen_trimmed_mean, gather_screen.gather_screen_median)),
            (staged, (lambda _, a, s_, *b: dequant_screen.dequant_screen_trimmed_mean_dense(
                          q, scale, a, s_, *b),
                      lambda _, a, s_: dequant_screen.dequant_screen_median_dense(q, scale, a, s_)),
             (lambda _, i, v, s_, *b: gather_screen.gather_dequant_screen_trimmed_mean(
                 q, scale, i, v, s_, *b),
              lambda _, i, v, s_: gather_screen.gather_dequant_screen_median(q, scale, i, v, s_))),
        ):
            if median_rows:
                assert bool(nan_equal(dense[1](tw, ta, tsv), ref.median_dense(x, ta, tsv)).all())
                assert bool(nan_equal(gather[1](tw, idx, valid, tsv),
                                      ref.gather_median(x, idx, valid, tsv)).all())
                launched += 2
                continue
            want_ltr = left_to_right_trimmed_mean(x, ta, tsv, 3)
            check_wide_trimmed_mean(dense[0](tw, ta, tsv, 3), want_ltr,
                                    ref.trimmed_mean_dense(x, ta, tsv, 3), wide_bound(x[None], ta, tsv, 3))
            check_wide_trimmed_mean(gather[0](tw, idx, valid, tsv, 3), want_ltr,
                                    ref.gather_trimmed_mean(x, idx, valid, tsv, 3),
                                    wide_bound(table.gather_rows(x), valid, tsv, 3))
            launched += 2
    torch.cuda.synchronize()
    assert screen_wide.launch.launches - before == launched == 8


def wide_trainer_config(layout: str, rule: str):
    """The trainer settings of the wide path's parity: dense M = 129 on
    ``erdos_renyi(129, 0.5, 4)`` (129 rows for the trimmed mean, 130 for the
    median) and sparse K = 64 on ``small_world(128, 30, 2, max_degree=64)``
    (a 64-slot table: above the tile kernel's 63)."""
    from repro_torch.core.bridge import BridgeConfig
    from repro_torch.core.graph import erdos_renyi, small_world

    if layout == "dense":
        return BridgeConfig(topology=erdos_renyi(129, 0.5, 4, seed=0), rule=rule, num_byzantine=4,
                            attack="random", t0=30)
    return BridgeConfig(topology=small_world(128, 30, 2, seed=0, max_degree=64), rule=rule,
                        num_byzantine=2, attack="random", t0=30, sparse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_wide_trainers_match_the_cpu(cuda_device, rule, layout):
    """3 ticks from one state on the card (the wide path, once a tick) and
    on the CPU (the plain versions) agree on honest rows at the trainer
    tolerance, rtol 1e-5, atol 1e-6."""
    from repro_torch.core.bridge import BridgeTrainer
    from repro_torch.sim.tasks import linear_task

    cfg = wide_trainer_config(layout, rule)
    m = cfg.topology.num_nodes
    task = linear_task(m, partition="iid", num_train=20 * m, num_test=100, device="cpu")
    init = task.init_fn(0)
    batches = [task.batch_fn(i) for i in range(3)]
    states = {}
    for device in (cuda_device, "cpu"):
        trainer = BridgeTrainer(cfg, task.grad_fn, device=device)
        state = trainer.init({k: v.to(device) for k, v in init.items()}, seed=1)
        before = screen_wide.launch.launches
        for batch in batches:
            state, _ = trainer.step(state, tuple(x.to(device) for x in batch))
        grew = screen_wide.launch.launches - before
        assert grew == (3 if device == cuda_device else 0)
        states[str(device)] = (state, trainer.honest_mask.cpu())
    (gpu, honest), (cpu, _) = states[str(cuda_device)], states["cpu"]
    for k in gpu.params:
        torch.testing.assert_close(gpu.params[k].cpu()[honest], cpu.params[k][honest],
                                   rtol=1e-5, atol=1e-6)


def views_inputs(m, w, d, seed, stride0=False):
    """Mailbox views ``[m, w, d]`` with NaN, +-inf, 1e30, ties and +-0
    payloads (or one broadcast expanded over the receivers, stride 0), a
    usable mask whose first nodes are starved (0 and 1 usable slots), and
    self values with NaN.  ``chip_smoke.py`` screens the same recipe."""
    rng = np.random.default_rng(seed)
    if stride0:
        views = torch.as_tensor(rng.normal(size=(1, w, d)).astype(np.float32)).expand(m, w, d)
    else:
        v = rng.normal(size=(m, w, d)).astype(np.float32)
        v[:, :, : d // 4] = np.round(v[:, :, : d // 4])
        for frac, val in ((0.05, np.nan), (0.03, np.inf), (0.03, -np.inf), (0.05, 1e30),
                          (0.04, -0.0), (0.04, 0.0)):
            v[rng.random(v.shape) < frac] = val
        views = torch.as_tensor(v)
    mask = rng.random((m, w)) < 0.6
    mask[0] = False
    mask[1] = False
    mask[1, 0] = True
    self_vals = rng.normal(size=(m, d)).astype(np.float32)
    self_vals[rng.random((m, d)) < 0.05] = np.nan
    return views, torch.as_tensor(mask), torch.as_tensor(self_vals)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,d,stride0", [(50, 50, 7850, False), (50, 50, 999, True),
                                           (12, 16, 333, False), (20, 63, 1000, False),
                                           (512, 16, 500, False), (7, 1, 50, False)])
def test_views_kernels_equal_plain_on_card(cuda_device, m, w, d, stride0):
    views, mask, self_vals = (x.to(cuda_device) for x in views_inputs(m, w, d, m, stride0))
    for b in (0, 1, 4):
        got = views_screen.views_screen_trimmed_mean(views, mask, self_vals, b)
        assert bool(nan_equal(got, ref.trimmed_mean_views(views, mask, self_vals, b)).all())
        # a starved node keeps its own value: finite where self is
        assert bool((torch.isfinite(got[0]) == torch.isfinite(self_vals[0])).all())
    got = views_screen.views_screen_median(views, mask, self_vals)
    assert bool(nan_equal(got, ref.median_views(views, mask, self_vals)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,stride0", [(129, 129, True), (30, 129, False), (10, 64, False)])
def test_views_wide_path_on_card(cuda_device, m, w, stride0):
    """Above 63 slots: the median exact, the trimmed mean within the float32
    summation bound of the plain version (which sums with ``torch.sum``)."""
    views, mask, self_vals = (x.to(cuda_device) for x in views_inputs(m, w, 300, m, stride0))
    got = views_screen.views_screen_median(views, mask, self_vals)
    assert bool(nan_equal(got, ref.median_views(views, mask, self_vals)).all())
    got = views_screen.views_screen_trimmed_mean(views, mask, self_vals, 2)
    want = ref.trimmed_mean_views(views, mask, self_vals, 2)
    fin = torch.isfinite(want)
    scale = torch.where(torch.isfinite(views), views.abs(), 0.0).amax(dim=1) + self_vals.abs()
    tol = 2.0 * w * float(np.finfo(np.float32).eps) * scale
    assert bool(((got - want).abs() <= tol)[fin].all())
    assert bool((torch.isfinite(got) == fin).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,d,stride0,per_mask", [(20, 20, 7850, False, True),
                                                    (12, 16, 333, True, False),
                                                    (50, 50, 999, True, True),
                                                    (30, 129, 300, False, True)])
def test_views_kernels_with_experiments_on_card(cuda_device, m, w, d, stride0, per_mask):
    """The views kernels over ``[E, M, W, d]`` (a net grid's cells) in one
    launch, per-cell b, one mask or one a cell, a receiver stride of 0 in
    place: each cell equal to the one-cell kernel bit for bit and to the
    plain version (NaN / +-inf / 1e30 payloads, starved nodes), the wide
    path's trimmed mean against its left-to-right sum's one-cell kernel."""
    e = 3
    cells = [views_inputs(m, w, d, m + i, stride0) for i in range(e)]
    if stride0:  # one broadcast a cell, expanded over its receivers on the card
        views = torch.stack([v[0][0] for v in cells])[:, None].to(cuda_device).expand(e, m, w, d)
    else:
        views = torch.stack([v[0] for v in cells]).to(cuda_device)
    mask = (torch.stack([v[1] for v in cells]) if per_mask else cells[0][1]).to(cuda_device)
    self_vals = torch.stack([v[2] for v in cells]).to(cuda_device)
    b = torch.tensor([0, 1, 4], dtype=torch.int32, device=cuda_device)
    at = lambda i: mask[i] if per_mask else mask  # noqa: E731
    before = views_screen.views_screen_trimmed_mean.launches + screen_wide.launch.launches
    tm = views_screen.views_screen_trimmed_mean(views, mask, self_vals, b)
    assert (views_screen.views_screen_trimmed_mean.launches + screen_wide.launch.launches
            - before) == 1  # one launch for every cell
    md = views_screen.views_screen_median(views, mask, self_vals)
    for i in range(e):
        one = views_screen.views_screen_trimmed_mean(views[i], at(i), self_vals[i], int(b[i]))
        assert torch.equal(bits(tm[i]), bits(one))
        assert torch.equal(bits(md[i]),
                           bits(views_screen.views_screen_median(views[i], at(i), self_vals[i])))
    assert bool(nan_equal(md, ref.median_views(views, mask, self_vals)).all())
    if w <= gather_screen.MAX_SLOTS:
        assert bool(nan_equal(tm, ref.trimmed_mean_views(views, mask, self_vals, b)).all())


# ---------------------------------------------------------------------------
# The grids' experiment axis and the batched distance kernel on the card
# ---------------------------------------------------------------------------


def experiment_inputs(e, m, d, seed):
    """``[E, M, d]`` rows with NaN and +inf payloads, and own values."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(e, m, d)).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = np.nan
    w[rng.random(w.shape) < 0.03] = np.inf
    s = rng.normal(size=(e, m, d)).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(s), rng


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 50, 129])
def test_experiment_axis_kernels_equal_their_plain_versions(cuda_device, m):
    """The dense screens' experiment axis (register kernel, and the wide
    path at M = 129) on the card: each experiment equals the unbatched
    kernel exactly, and the plain version exactly (the trimmed mean above
    64 rows, where the plain version sums with a reduction tree, within
    the summation bound)."""
    e, d = 5, 999
    w, s, rng = experiment_inputs(e, m, d, seed=m)
    adj = torch.from_numpy(rng.random((m, m)) < 0.5)
    b = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    dev = cuda_device
    wd, sd, ad = w.to(dev), s.to(dev), adj.to(dev)
    tm = trimmed_mean.trimmed_mean_dense(wd, ad, sd, b.to(dev))
    md = median.median_dense(wd, ad, sd)
    for i in range(e):
        one = trimmed_mean.trimmed_mean_dense(wd[i], ad, sd[i], int(b[i]))
        torch.testing.assert_close(tm[i], one, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(md[i], median.median_dense(wd[i], ad, sd[i]), rtol=0, atol=0,
                                   equal_nan=True)
    torch.testing.assert_close(md.cpu(), ref.median_dense(w, adj, s), rtol=0, atol=0,
                               equal_nan=True)
    want = ref.trimmed_mean_dense(w, adj, s, b)
    if m <= ref.MAX_EXACT_ROWS:
        torch.testing.assert_close(tm.cpu(), want, rtol=0, atol=0, equal_nan=True)
    else:
        finite = torch.isfinite(want)
        torch.testing.assert_close(tm.cpu()[finite], want[finite], rtol=1e-5, atol=1e-5)
        assert torch.equal(torch.isfinite(tm.cpu()), finite)


def views_of(m, w, d, seed, stride0):
    """Views ``[m, w, d]`` (or one broadcast expanded over the receivers)
    and self values."""
    rng = np.random.default_rng(seed)
    if stride0:
        views = torch.from_numpy(rng.normal(size=(1, w, d)).astype(np.float32)).expand(m, w, d)
    else:
        views = torch.from_numpy(rng.normal(size=(m, w, d)).astype(np.float32))
    return views, torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))


def bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bit patterns, so that equality is bit for bit (NaN too)."""
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,d,stride0", [(50, 50, 7850, False), (50, 50, 7850, True),
                                           (512, 16, 7850, False), (64, 64, 999, True),
                                           (20, 20, 7850, False), (64, 16, 777, True),
                                           (200, 16, 7850, True), (40, 9, 130, False)])
def test_batched_kernel_on_views(cuda_device, m, w, d, stride0):
    """Every element equal bit for bit to the unbatched kernel of its rows,
    on the body `batch_plan` picks and on every other candidate (the
    cluster body, the batch body up to 17 rows); within the float32
    dot-product bound of the plain version; symmetric."""
    views, self_vals = views_of(m, w, d, seed=m + w, stride0=stride0)
    views, self_vals = views.to(cuda_device), self_vals.to(cuda_device)
    got = pairwise.pairwise_sq_dists_batched(views, self_vals)
    x = torch.cat([views, self_vals[:, None]], dim=1)
    for j in range(m):
        assert torch.equal(bits(got[j]), bits(pairwise.pairwise_sq_dists(x[j].contiguous())))
    for plan in pairwise.batch_candidates(m, w + 1, d):
        assert torch.equal(bits(pairwise.pairwise_sq_dists_batched(views, self_vals, plan)),
                           bits(got)), plan
    want = ref.pairwise_sq_dists_batched(views, self_vals)
    sq = torch.sum(x * x, dim=2)
    bound = 4 * d * np.finfo(np.float32).eps * (sq[:, :, None] + sq[:, None, :])
    assert bool(((got - want).abs() <= bound + 1e-30).all())
    assert torch.equal(got, got.mT)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d", [(8, 50, 7850), (300, 17, 999), (64, 5, 7850)])
def test_batched_kernel_without_self_rows(cuda_device, e, n, d):
    """``[E, n, d]`` rows with no self row (a grid's per-cell distances),
    NaN / +-inf / 1e30 rows among them: every body equal bit for bit, and
    every element to the unbatched kernel of its rows."""
    rng = np.random.default_rng(e + n)
    x = rng.normal(size=(e, n, d)).astype(np.float32)
    x[0, 1], x[1, 0, 3], x[1, 2, 0], x[2, n - 1] = np.nan, np.inf, -np.inf, 1e30
    x = torch.from_numpy(x).to(cuda_device)
    got = pairwise.pairwise_sq_dists_batched(x)
    for j in range(e):
        assert torch.equal(bits(got[j]), bits(pairwise.pairwise_sq_dists(x[j])))
    for plan in pairwise.batch_candidates(e, n, d):
        assert torch.equal(bits(pairwise.pairwise_sq_dists_batched(x, None, plan)), bits(got)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("w", [3, 16, 17, 40, 64, 65, 129])
@pytest.mark.parametrize("stride0", [False, True])
def test_views_backward_kernels_equal_the_plain_backward_on_card(cuda_device, w, stride0):
    """The views screens' backward kernels (`kernels.autograd`,
    ``csrc/views_screen_grad.cu``; above 64 slots the wide kernel) against
    the plain backward (the sort), bit for bit, on edge-case views (NaN,
    +-inf, ties, +-0, starved nodes, a receiver stride of 0), b of 0-2 and
    per cell, two cells."""
    from repro_torch.kernels import autograd as grad_ops

    views, mask, sv = views_inputs(6, w, 301, seed=w, stride0=stride0)
    views = views.to(cuda_device)[None].expand(2, *views.shape)
    mask, sv = mask.to(cuda_device), sv.to(cuda_device)[None].expand(2, -1, -1).contiguous()
    gy = torch.randn(sv.shape, device=cuda_device)
    for rule, bs in (("trimmed_mean", (0, 1, 2, torch.tensor([2, 0], dtype=torch.int32,
                                                              device=cuda_device))),
                     ("median", (0,))):
        for b in bs:
            spec = grad_ops.ScreenSpec(None, rule, "views", mask, b)
            want = grad_ops.plain_backward(spec, views, sv, gy)
            got = grad_ops._backward(spec, views, sv, gy)
            for g, p in zip(got, want, strict=True):
                assert torch.equal(g, p), (rule, b)


def _decide_equal(got, want, plain_y, bound=None) -> None:
    """``(y, trim)`` of a decide kernel: trim the twin's and y the plain
    kernel's, bit for bit; y the twin's (NaN-aware ``==``), or within
    ``bound`` where the twin sums in another order."""
    for g, w_ in ((got[0], plain_y), (got[1], want[1])):
        assert torch.equal(bits(g), bits(w_))
    if bound is None:
        assert bool(nan_equal(got[0], want[0]).all())
        return
    y, ty = got[0], want[0]
    finite = torch.isfinite(y) & torch.isfinite(ty)
    assert bool(nan_equal(y[~finite], ty[~finite]).all())
    assert bool(((y - ty).abs()[finite] <= bound[finite]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 20, 50, 64, 100, 129, 300])
def test_dense_decide_kernels_equal_their_plain_twins(cuda_device, n):
    """The dense screens' decide form at strides 1 and 4 (buckets with the
    register copy, up to 32 rows, and with the re-read above, the 128-row
    bucket included, and the wide path's decide form above 128 rows): trim
    the plain twin's and y the plain kernel's, bit for bit; y the twin's
    exactly, except the trimmed mean above 64 rows, where the twin sums
    with ``torch.sum`` (`summation_bound`)."""
    w, adj = edge_inputs(n, 999, seed=n)
    tw, ta = torch.from_numpy(w).to(cuda_device), torch.from_numpy(adj).to(cuda_device)
    for s in (1, 4):
        for b in (0, 2):
            _decide_equal(screen_decide.trimmed_mean_dense_decide(tw, ta, tw, b, s),
                          ref.trimmed_mean_dense_decide(tw, ta, tw, b, s),
                          trimmed_mean.trimmed_mean_dense(tw, ta, tw, b),
                          summation_bound(tw, ta, b) if n > 64 else None)
        _decide_equal(screen_decide.median_dense_decide(tw, ta, tw, s),
                      ref.median_dense_decide(tw, ta, tw, s), median.median_dense(tw, ta, tw))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 16, 40, 63, 64])
def test_tile_decide_kernels_equal_their_plain_twins(cuda_device, k):
    """The gather and views screens' decide form on tables with padded
    slots and starved nodes, exact against the plain twins and the plain
    kernels; above 63 slots through the wide path's decide form."""
    from repro_torch.core.neighbors import NeighborTable

    w, adj = sparse_inputs(k, 300, seed=k)
    tab = NeighborTable.from_adjacency(adj, k=k, device=cuda_device)
    tw = torch.from_numpy(w).to(cuda_device)
    idx, valid = tab.safe_idx, tab.valid_dev
    views = ref.gather(tw, idx).contiguous()
    for s in (1, 4):
        _decide_equal(screen_decide.gather_screen_trimmed_mean_decide(tw, idx, valid, tw, 2, s),
                      ref.gather_trimmed_mean_decide(tw, idx, valid, tw, 2, s),
                      gather_screen.gather_screen_trimmed_mean(tw, idx, valid, tw, 2))
        _decide_equal(screen_decide.gather_screen_median_decide(tw, idx, valid, tw, s),
                      ref.gather_median_decide(tw, idx, valid, tw, s),
                      gather_screen.gather_screen_median(tw, idx, valid, tw))
        _decide_equal(screen_decide.views_screen_trimmed_mean_decide(views, valid, tw, 2, s),
                      ref.trimmed_mean_views_decide(views, valid, tw, 2, s),
                      views_screen.views_screen_trimmed_mean(views, valid, tw, 2))
        _decide_equal(screen_decide.views_screen_median_decide(views, valid, tw, s),
                      ref.median_views_decide(views, valid, tw, s),
                      views_screen.views_screen_median(views, valid, tw))
