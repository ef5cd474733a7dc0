"""BRIDGE-K and BRIDGE-B over mailbox views: the batched distance kernel
(`repro_torch.kernels.pairwise.pairwise_sq_dists_batched`, batch = node)
and `screening.screen_views` on it.

* the batched plain distance per node equals `ref.pairwise_sq_dists` of
  that node's stacked views and itself, for materialized views and for a
  broadcast expanded over the receivers (stride 0), which it reads in
  place;
* the views screens of Krum and Bulyan follow the reference's
  ``screen_views_banked`` on the CPU, on stride-0 views too;
* the wrapper refuses what the kernel does not take;
* `pairwise.batch_plan`, which picks the body (the cluster body or the
  batch body), is a function of the shape, keeps `split_plan`'s order on
  every body, fits a block's shared memory and raises outside its limits.

On the card the kernel is held to the unbatched kernel of each node's rows
and to its plain version by ``tests/test_torch_kernels.py``
(``cuda``-marked, no JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import screening as jscreening
from repro_torch.core import screening
from repro_torch.kernels import pairwise, ref
from test_torch_rules import check_rule, cluster_inputs


def views_of(m, w, d, seed, stride0):
    """Views ``[m, w, d]`` (or one broadcast expanded over the receivers),
    a usable mask and self values."""
    rng = np.random.default_rng(seed)
    if stride0:
        views = torch.from_numpy(rng.normal(size=(1, w, d)).astype(np.float32)).expand(m, w, d)
    else:
        views = torch.from_numpy(rng.normal(size=(m, w, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random((m, w)) < 0.8)
    self_vals = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    return views, mask, self_vals


@pytest.mark.parametrize("with_self", [True, False])
@pytest.mark.parametrize("stride0", [False, True])
def test_batched_plain_distances_are_per_node_distances(stride0, with_self):
    views, _, self_vals = views_of(9, 7, 33, seed=1, stride0=stride0)
    got = pairwise.pairwise_sq_dists_batched(views, self_vals if with_self else None)
    assert got.shape == (9, 8 if with_self else 7, 8 if with_self else 7)
    for j in range(9):
        rows = torch.cat([views[j], self_vals[j:j + 1]]) if with_self else views[j]
        assert torch.equal(got[j], ref.pairwise_sq_dists(rows.contiguous()))
    assert torch.equal(got, got.mT)
    assert bool((torch.diagonal(got, dim1=1, dim2=2) == 0).all())


def jax_views(rule, views, mask, self_vals, b):
    fn = jax.jit(lambda v, m, s, b_: jscreening.screen_views_banked(v, m, s, (rule,), 0, b_))
    return np.asarray(fn(jnp.asarray(views), jnp.asarray(mask), jnp.asarray(self_vals),
                         jnp.int32(b)))


@pytest.mark.parametrize("stride0", [False, True])
@pytest.mark.parametrize("rule", ["krum", "bulyan"])
def test_views_vector_rules_follow_the_reference(rule, stride0):
    """Each node's Krum pick / Bulyan output over its own views and itself,
    against the reference's views screen: clustered views (the picks are
    clear of the distances' last bits), every node with enough usable
    views for Bulyan at b = 1."""
    w, _ = cluster_inputs(14, 24, seed=3)
    m, b = 14, 1
    rng = np.random.default_rng(4)
    if stride0:
        views = torch.from_numpy(w[None, :12]).expand(m, 12, 24)
    else:
        views = torch.from_numpy(np.stack([np.roll(w, j, axis=0)[:12] for j in range(m)]))
    mask = rng.random((m, 12)) < 0.9
    mask[:, :7] = True  # Bulyan's Table-II minimum at b = 1 is 6
    self_vals = w + np.float32(0.01) * rng.normal(size=w.shape).astype(np.float32)
    got = screening.screen_views(views, torch.from_numpy(mask), torch.from_numpy(self_vals),
                                 rule=rule, b=b).numpy()
    want = jax_views(rule, views.contiguous().numpy(), mask, self_vals, b)
    check_rule(rule, got, want, None, None, None)


@pytest.mark.parametrize("bad", ["dtype", "rank", "coord_stride", "self_shape", "self_dtype"])
def test_batched_wrapper_rejects_bad_operands(bad):
    views, _, self_vals = views_of(4, 3, 8, seed=0, stride0=False)
    if bad == "dtype":
        views = views.double()
    elif bad == "rank":
        views = views[0]
    elif bad == "coord_stride":
        views = torch.zeros(4, 8, 3).transpose(1, 2)
    elif bad == "self_shape":
        self_vals = self_vals[:, :7]
    else:
        self_vals = self_vals.double()
    with pytest.raises((TypeError, ValueError)):
        pairwise.pairwise_sq_dists_batched(views, self_vals)


BATCH_SHAPES = [(1, 1, 1), (1, 17, 7850), (20, 17, 7850), (64, 17, 777), (132, 17, 7850),
                (512, 17, 7850), (20, 21, 7850), (8, 50, 7850), (50, 51, 7850), (200, 33, 7850),
                (3, 2, 33), (10**6, 5, 100), (pairwise.MAX_BATCH, 17, 64)]


@pytest.mark.parametrize("bsz,n,d", BATCH_SHAPES)
def test_batch_plan_is_a_function_of_the_shape(bsz, n, d):
    """The same plan from a fresh computation; every candidate (and so the
    choice) under ``split_plan(n, d)``'s order, the batch body only for
    elements of one tile, each accepted by `check_batch_plan`."""
    plan = pairwise.batch_plan(bsz, n, d)
    cands = pairwise.batch_candidates(bsz, n, d)
    assert plan == min(cands, key=lambda p: pairwise.batch_cost(p, bsz, n, d))
    assert plan in cands and cands[0] == pairwise.BatchPlan(pairwise.split_plan(n, d))
    for cand in cands:
        assert cand.order == pairwise.split_plan(n, d)
        assert cand.body in ("cluster", "batch")
        assert cand.body == "cluster" or n <= pairwise.ONE_TILE
        pairwise.check_batch_plan(cand, bsz, n, d)


@pytest.mark.parametrize("bsz,n,d", BATCH_SHAPES)
def test_batch_plan_fits_a_blocks_shared_memory(bsz, n, d):
    """Each body's block within the 227 KB a block may use; the batch body's
    ring (three stages of 16 coordinates of 32 splits of 17 rows) as the
    kernel sizes it, and small enough for two blocks an SM."""
    for cand in pairwise.batch_candidates(bsz, n, d):
        if cand.body == "batch":
            assert pairwise.BATCH_SMEM == 3 * 16 * 32 * pairwise.ONE_TILE * 4
            assert 2 * (pairwise.BATCH_SMEM + 1024) <= 228 * 1024
        else:
            assert pairwise.smem_bytes(cand.order) <= 227 * 1024


def test_batch_plan_picks_the_bodies_of_the_main_path():
    """Sparse views K / B (M = 512, K = 16: each node's 16 views and itself)
    on the batch body; the net phase's M = 20 views and the K / B grid's
    cells (E = 8, M = 50) on the cluster body, which fills the card there."""
    assert pairwise.batch_plan(512, 17, 7850).body == "batch"
    assert pairwise.batch_plan(20, 21, 7850).body == "cluster"
    assert pairwise.batch_plan(8, 50, 7850).body == "cluster"
    assert pairwise.batch_plan(50, 51, 7850).body == "cluster"


@pytest.mark.parametrize("bsz,n,d", [(0, 5, 10), (pairwise.MAX_BATCH + 1, 5, 10), (5, 0, 10),
                                     (5, pairwise.MAX_ROWS + 1, 10), (5, 5, 0),
                                     (5, 5, pairwise.MAX_COORDS + 1)])
def test_batch_plan_raises_outside_its_limits(bsz, n, d):
    with pytest.raises(ValueError):
        pairwise.batch_plan(bsz, n, d)


@pytest.mark.parametrize("bad", ["batch_rows", "order", "cluster_order", "body"])
def test_check_batch_plan_refuses_plans_the_kernel_does_not_take(bad):
    """The batch body above one tile of rows, an order other than
    ``split_plan(n, d)``'s on either body, an unknown body."""
    n = 18 if bad == "batch_rows" else 17
    order = pairwise.split_plan(n, 7850)
    plan = {"batch_rows": pairwise.BatchPlan(order, "batch"),
            "order": pairwise.BatchPlan(pairwise.Plan(4, 4, 512), "batch"),
            "cluster_order": pairwise.BatchPlan(pairwise.Plan(6, 8, 256)),
            "body": pairwise.BatchPlan(order, "packed")}[bad]
    with pytest.raises(ValueError):
        pairwise.check_batch_plan(plan, 512, n, 7850)


def test_batched_wrapper_takes_a_plan_on_the_cpu():
    """On the CPU every plan gives the plain version (one matrix an
    element), and neither body's launch count moves."""
    views, _, self_vals = views_of(6, 16, 40, seed=5, stride0=False)
    before = (pairwise.cluster_body.launches, pairwise.batch_body.launches)
    want = ref.pairwise_sq_dists_batched(views, self_vals)
    for plan in pairwise.batch_candidates(6, 17, 40):
        assert torch.equal(pairwise.pairwise_sq_dists_batched(views, self_vals, plan), want)
    assert (pairwise.cluster_body.launches, pairwise.batch_body.launches) == before
