"""The port's numpy host builders against the reference's: graphs, data,
partitions, batches and the Byzantine pick must be equal array for array
(``np.array_equal``) for the same seed — the port draws from
``np.random.default_rng`` in the reference's order.  The port condenses
strongly connected components with scipy where the reference uses
networkx; `check_assumption4` must give the same verdicts."""
import numpy as np
import pytest

from repro.core import byzantine as jbyz
from repro.core import graph as jgraph
from repro.data import mnist_like as jmnist
from repro.data import partition as jpart
from repro_torch.core import byzantine, graph
from repro_torch.data import mnist_like, partition


def _both(fn_ref, fn_port):
    """Call both builders; both must return or both raise the same type."""
    try:
        want = fn_ref()
    except RuntimeError:
        with pytest.raises(RuntimeError):
            fn_port()
        return None, None
    return want, fn_port()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("m", [10, 20, 50])
def test_erdos_renyi_equal(m, b, seed):
    p = 0.9 if m == 10 else 0.5
    want, got = _both(lambda: jgraph.erdos_renyi(m, p, b, seed=seed, max_tries=20),
                      lambda: graph.erdos_renyi(m, p, b, seed=seed, max_tries=20))
    if want is None:
        return
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert got.num_byzantine == want.num_byzantine == b
    assert got.min_in_degree == want.min_in_degree


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("p", [0.15, 0.3, 0.6])
def test_check_assumption4_same_verdicts(p, seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((14, 14)) < p
    np.fill_diagonal(adj, False)
    for b in (0, 1, 2):
        want = jgraph.check_assumption4(jgraph.Topology(adj, b), num_samples=10, seed=seed)
        got = graph.check_assumption4(graph.Topology(adj, b), num_samples=10, seed=seed)
        assert got == want, (p, seed, b)


def test_source_component_cases():
    # a directed chain 0 -> 1 -> 2: {0} is a source component reaching all
    chain = np.zeros((3, 3), bool)
    chain[1, 0] = chain[2, 1] = True
    assert graph._has_source_component(chain, 1)
    assert not graph._has_source_component(chain, 2)
    # two disconnected pairs: no single component reaches every node
    pairs = np.zeros((4, 4), bool)
    pairs[0, 1] = pairs[1, 0] = pairs[2, 3] = pairs[3, 2] = True
    assert not graph._has_source_component(pairs, 1)
    for adj, k in ((chain, 1), (chain, 2), (pairs, 1)):
        assert graph._has_source_component(adj, k) == jgraph._has_source_component(adj, k)


def test_topology_checks_match():
    assert np.array_equal(graph.complete_graph(7, 2).adjacency, jgraph.complete_graph(7, 2).adjacency)
    loop = np.eye(3, dtype=bool)
    with pytest.raises(ValueError):
        graph.Topology(loop, 0)
    with pytest.raises(ValueError):
        graph.Topology(np.zeros((2, 3), bool), 0)
    topo = graph.erdos_renyi(12, 0.3, 1, seed=0)
    topo.validate_for_rule("trimmed_mean")
    with pytest.raises(ValueError):
        graph.Topology(topo.adjacency, 6).validate_for_rule("trimmed_mean")


@pytest.mark.parametrize("seed", [0, 3])
def test_make_mnist_like_equal(seed):
    want = jmnist.make_mnist_like(300, 60, seed=seed)
    got = mnist_like.make_mnist_like(300, 60, seed=seed)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["partition_iid", "partition_extreme_noniid",
                                  "partition_moderate_noniid"])
@pytest.mark.parametrize("m", [10, 20])
def test_partitions_and_batches_equal(name, m):
    x, y, _, _ = jmnist.make_mnist_like(400, 10, seed=1)
    want = getattr(jpart, name)(x, y, m, seed=2)
    got = getattr(partition, name)(x, y, m, seed=2)
    assert len(got) == len(want) == m
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    bf_want = jpart.stack_node_batches(want, 8, seed=3)
    bf_got = partition.stack_node_batches(got, 8, seed=3)
    for i in range(3):
        for g, w in zip(bf_got(i), bf_want(i), strict=True):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m,nbyz,seed", [(10, 2, 0), (12, 2, 1), (50, 4, 0), (50, 10, 7)])
def test_pick_byzantine_mask_equal(m, nbyz, seed):
    want = np.asarray(jbyz.pick_byzantine_mask(m, nbyz, seed))
    got = byzantine.pick_byzantine_mask(m, nbyz, seed)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == nbyz
