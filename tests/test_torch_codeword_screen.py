"""The port's int8-codeword screens — the plain versions
`ref.dequant_trimmed_mean_dense`, `ref.dequant_median_dense`,
`ref.gather_dequant_trimmed_mean`, `ref.gather_dequant_median` and the
``kernels.ops`` entries and wrappers that reach them on the CPU — against
the reference on the CPU.

The codewords are the int8 codec's own (a seeded bank, encoded by the
port's codec, which equals the reference's: ``test_torch_comm.py``), some
senders' replaced by ``scale_abuse`` or ``garbage_codeword``
(``test_torch_wire.py``), and random codewords with inf and zero scales and
nonzero zero terms (``test_torch_kernels.codeword``).  d = 300 leaves a
ragged last scale block.

Tolerances, stated per comparison:
* against JAX screening applied to ``repro.kernels.ref.dequant_ref``'s
  decode (jitted; the trainer's screening program with the mask and ``b``
  as operands): exact, NaN-aware.  The jitted decode is one fused
  multiply-add also with a run-time zero term (100% of coordinates,
  ``tools/xla_divisor_forms.py``), as the port's is;
* against the Pallas kernels ``dequant_trimmed_mean_pallas`` /
  ``dequant_median_pallas`` in interpret mode, with E = M per-node views of
  the broadcast, and ``gather_dequant_screen_pallas``: allclose at rtol
  1e-5, atol 1e-5 (JAX's own convention, ``tests/test_comm.py``), since the
  Pallas trimmed mean drops extremes one at a time and sums survivors in
  row order, where the port sorts;
* against ``ref.dequant_trimmed_mean_ref`` / ``dequant_median_ref``, which
  do not clamp ``b``, only at nodes with ``count >= 2b + 1``, within the
  same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import screening as jscreening
from repro.core.neighbors import NeighborTable as JTable
from repro.kernels import ref as jref
from repro.kernels.dequant_screen import dequant_median_pallas, dequant_trimmed_mean_pallas
from repro.kernels.gather_screen import gather_dequant_screen_pallas
from repro_torch.comm import codec
from repro_torch.core import byzantine, neighbors
from repro_torch.kernels import dequant_screen, gather_screen, ops, ref
from test_torch_kernels import codeword, edge_inputs, nan_equal, sparse_inputs

D = 300


def codec_bank(m: int, d: int, seed: int, attack: str = "none"):
    """The int8 codec's codewords of a seeded ``[m, d]`` bank scaled like
    iterates, the senders of ``pick_byzantine_mask(m, 2, seed)`` replaced
    by ``attack``, and self values (a few NaN, +-inf)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 10.0 ** rng.uniform(-3, 1, size=(m, 1))).astype(np.float32)
    x[0, :40] = 0.0
    key = np.array([0, seed], np.uint32)
    msg = codec.get_codec("int8").encode(key, torch.from_numpy(x))
    byz = torch.from_numpy(byzantine.pick_byzantine_mask(m, 2, seed))
    msg = byzantine.wire_attack_for(attack)(msg, byz, key, 3, d)
    self_vals = (x + rng.normal(size=x.shape).astype(np.float32) * 1e-3).astype(np.float32)
    self_vals[1, :3] = [np.nan, np.inf, -np.inf]
    return msg.payload.numpy(), msg.scale.numpy(), self_vals


def random_bank(m: int, d: int, seed: int):
    q, scale = codeword(m, d, seed)
    q[4, :7] = -128
    self_vals = np.random.default_rng(seed + 1).normal(size=(m, d)).astype(np.float32)
    self_vals[2, :2] = [np.nan, -np.inf]
    return q, scale, self_vals


BANKS = {
    "codec": lambda m, d, s: codec_bank(m, d, s),
    "scale_abuse": lambda m, d, s: codec_bank(m, d, s, "scale_abuse"),
    "garbage": lambda m, d, s: codec_bank(m, d, s, "garbage_codeword"),
    "random": random_bank,
}


@pytest.fixture(scope="module")
def jax_screen():
    """JAX screening (operands: mask and b) of the jitted reference decode."""
    dense = {rule: jax.jit(lambda q, sc, adj, sv, b, r=rule: jscreening.screen_all_banked(
        jref.dequant_ref(q, sc), adj, (r,), 0, b, chunk=1 << 20, self_vals=sv))
        for rule in ("trimmed_mean", "median")}
    views = {rule: jax.jit(lambda q, sc, idx, valid, sv, b, r=rule: jscreening.screen_views_banked(
        jref.dequant_ref(q, sc)[idx], valid, sv, (r,), 0, b, chunk=1 << 20))
        for rule in ("trimmed_mean", "median")}

    def run(rule, q, scale, adj, self_vals, b, table=None):
        args = (jnp.asarray(q), jnp.asarray(scale))
        if table is None:
            out = dense[rule](*args, jnp.asarray(adj), jnp.asarray(self_vals), jnp.int32(b))
        else:
            out = views[rule](*args, jnp.asarray(table.idx.clip(max=q.shape[0] - 1)),
                              jnp.asarray(table.valid), jnp.asarray(self_vals), jnp.int32(b))
        return np.asarray(out)

    return run


def port_dense(rule, q, scale, adj, self_vals, b):
    args = [torch.from_numpy(a) for a in (q, scale, adj, self_vals)]
    if rule == "trimmed_mean":
        return ops.dequant_trimmed_mean(*args, b).numpy()
    return ops.dequant_median(*args).numpy()


def port_gather(rule, q, scale, table, self_vals, b):
    tq, ts, tsv = (torch.from_numpy(a) for a in (q, scale, self_vals))
    if rule == "trimmed_mean":
        return ops.gather_dequant_trimmed_mean(tq, ts, table.safe_idx, table.valid_dev, tsv,
                                               b).numpy()
    return ops.gather_dequant_median(tq, ts, table.safe_idx, table.valid_dev, tsv).numpy()


def assert_nan_equal(got, want):
    bad = ~nan_equal(got, want)
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} entries differ"


def assert_close(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("m,b", [(7, 1), (20, 2)])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_dense_plain_bit_exact_vs_jax_decode_then_screen(jax_screen, rule, m, b, bank):
    q, scale, self_vals = BANKS[bank](m, D, m + b)
    _, adj = edge_inputs(m, 4, seed=m)
    want = jax_screen(rule, q, scale, adj, self_vals, b)
    assert_nan_equal(port_dense(rule, q, scale, adj, self_vals, b), want)


@pytest.mark.parametrize("bank", list(BANKS))
@pytest.mark.parametrize("k", [3, 8, 16])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_gather_plain_bit_exact_vs_jax_decode_then_screen(jax_screen, rule, k, bank):
    _, adj = sparse_inputs(k, 4, seed=k)
    m = adj.shape[0]
    q, scale, self_vals = BANKS[bank](m, D, k)
    jt = JTable.from_adjacency(adj, k=k)
    pt = neighbors.NeighborTable.from_adjacency(adj, k=k, device="cpu")
    want = jax_screen(rule, q, scale, adj, self_vals, 2, table=jt)
    assert_nan_equal(port_gather(rule, q, scale, pt, self_vals, 2), want)
    dense = port_dense(rule, q, scale, adj, self_vals, 2)
    assert_nan_equal(port_gather(rule, q, scale, pt, self_vals, 2), dense)


@pytest.mark.parametrize("bank,m,b", [("codec", 9, 1), ("scale_abuse", 12, 2), ("random", 12, 2)])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_dense_plain_vs_pallas_interpret(rule, m, b, bank):
    """E = M per-node views of the broadcast through the reference's fused
    kernels."""
    q, scale, self_vals = BANKS[bank](m, D, 3 * m)
    _, adj = edge_inputs(m, 4, seed=m + 5)
    qe = np.broadcast_to(q, (m, m, D))
    se = np.broadcast_to(scale, (m, *scale.shape))
    args = (jnp.asarray(qe), jnp.asarray(se), jnp.asarray(adj), jnp.asarray(self_vals))
    if rule == "trimmed_mean":
        want = dequant_trimmed_mean_pallas(*args, b, block_d=128, interpret=True)
    else:
        want = dequant_median_pallas(*args, block_d=128, interpret=True)
    assert_close(port_dense(rule, q, scale, adj, self_vals, b), np.asarray(want))


@pytest.mark.parametrize("bank,k", [("codec", 4), ("garbage", 8), ("random", 16)])
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_gather_plain_vs_pallas_interpret(rule, k, bank):
    _, adj = sparse_inputs(k, 4, seed=2 * k)
    m = adj.shape[0]
    q, scale, self_vals = BANKS[bank](m, D, k + 1)
    jt = JTable.from_adjacency(adj, k=k)
    want = gather_dequant_screen_pallas(jnp.asarray(q), jnp.asarray(scale), jnp.asarray(jt.idx),
                                        jnp.asarray(jt.valid), jnp.asarray(self_vals), 2,
                                        rule=rule, block_d=128, interpret=True)
    pt = neighbors.NeighborTable.from_adjacency(adj, k=k, device="cpu")
    assert_close(port_gather(rule, q, scale, pt, self_vals, 2), np.asarray(want))


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_dense_plain_vs_unclamped_ref_where_count_allows(rule):
    m, b = 14, 2
    q, scale, self_vals = codec_bank(m, D, 4, "scale_abuse")
    _, adj = edge_inputs(m, 4, seed=9)
    count = adj.sum(axis=1)
    qe = jnp.asarray(np.broadcast_to(q, (m, m, D)))
    se = jnp.asarray(np.broadcast_to(scale, (m, *scale.shape)))
    if rule == "trimmed_mean":
        want = jref.dequant_trimmed_mean_ref(qe, se, jnp.asarray(adj), jnp.asarray(self_vals), b)
    else:
        want = jref.dequant_median_ref(qe, se, jnp.asarray(adj), jnp.asarray(self_vals))
    got = port_dense(rule, q, scale, adj, self_vals, b)
    rows = count >= 2 * b + 1 if rule == "trimmed_mean" else np.ones(m, bool)
    assert rows.sum() >= m // 2
    assert_close(got[rows], np.asarray(want)[rows])


def test_plain_codeword_screens_are_decode_then_screen():
    """The plain versions are `ref.dequant` followed by the float screens,
    and an inf scale over zero codes (NaN) ranks as +inf."""
    q, scale, self_vals = random_bank(10, D, 6)
    _, adj = edge_inputs(10, 4, seed=6)
    tq, ts, ta, tsv = (torch.from_numpy(a) for a in (q, scale, adj, self_vals))
    dec = ref.dequant(tq, ts)
    assert torch.isposinf(dec[0, :5]).all()
    assert_nan_equal(ref.dequant_trimmed_mean_dense(tq, ts, ta, tsv, 2).numpy(),
                     ref.trimmed_mean_dense(dec, ta, tsv, 2).numpy())
    assert_nan_equal(ref.dequant_median_dense(tq, ts, ta, tsv).numpy(),
                     ref.median_dense(dec, ta, tsv).numpy())


def test_cpu_wrappers_run_plain_versions_without_launching():
    q, scale, self_vals = codec_bank(12, D, 1, "garbage_codeword")
    _, adj = edge_inputs(12, 4, seed=1)
    tq, ts, tsv = (torch.from_numpy(a) for a in (q, scale, self_vals))
    table = neighbors.NeighborTable.from_adjacency(adj, device="cpu")
    wrappers = (dequant_screen.dequant_screen_trimmed_mean_dense,
                dequant_screen.dequant_screen_median_dense,
                gather_screen.gather_dequant_screen_trimmed_mean,
                gather_screen.gather_dequant_screen_median)
    before = [fn.launches for fn in wrappers]
    ta = torch.from_numpy(adj).to(torch.uint8)
    outs = (wrappers[0](tq, ts, ta, tsv, 2), wrappers[1](tq, ts, ta, tsv),
            wrappers[2](tq, ts, table.safe_idx, table.valid_dev, tsv, 2),
            wrappers[3](tq, ts, table.safe_idx, table.valid_dev, tsv))
    assert [fn.launches for fn in wrappers] == before
    assert all(o.shape == (12, D) and o.dtype == torch.float32 for o in outs)
    assert_nan_equal(outs[0].numpy(), outs[2].numpy())
    assert_nan_equal(outs[1].numpy(), outs[3].numpy())


@pytest.mark.parametrize("bad", ["q_dtype", "scale_shape", "self_shape", "self_dtype", "adj",
                                 "contiguous", "b", "table"])
def test_codeword_wrappers_reject_bad_operands(bad):
    m = 6
    q = torch.zeros(m, D, dtype=torch.int8)
    scale = torch.ones(m, 3, 2)
    self_vals = torch.zeros(m, D)
    adj = torch.ones(m, m, dtype=torch.bool)
    idx = torch.zeros(m, 3, dtype=torch.int32)
    valid = torch.ones(m, 3, dtype=torch.bool)
    b = 1
    if bad == "q_dtype":
        q = q.float()
    elif bad == "scale_shape":
        scale = torch.ones(m, 2, 2)
    elif bad == "self_shape":
        self_vals = torch.zeros(m, D - 1)
    elif bad == "self_dtype":
        self_vals = self_vals.double()
    elif bad == "adj":
        adj = torch.ones(m, m + 1, dtype=torch.bool)
    elif bad == "contiguous":
        q = torch.zeros(D, m, dtype=torch.int8).T
    elif bad == "b":
        b = -1
    elif bad == "table":
        idx = idx.long()
    with pytest.raises((TypeError, ValueError)):
        if bad == "table":
            gather_screen.gather_dequant_screen_median(q, scale, idx, valid, self_vals)
        else:
            dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, adj, self_vals, b)
    if bad not in ("adj", "b"):
        with pytest.raises((TypeError, ValueError)):
            gather_screen.gather_dequant_screen_trimmed_mean(q, scale, idx, valid, self_vals, b)
