"""Communication graphs for decentralized learning — port of
`repro.core.graph` (``Topology``, ``erdos_renyi``, ``ring_of_cliques``,
``complete_graph``, ``small_world``, ``random_geometric``,
``toroidal_grid``, the ``TOPOLOGIES`` registry with ``make_topology``, and
``check_assumption4``).

Pure numpy, as in the reference, and draw-for-draw identical to it: the
same seed gives the same graph (``tests/test_torch_data_graph.py`` pins this
with ``np.array_equal``).  The reference condenses strongly connected
components with networkx; the port uses ``scipy.sparse.csgraph`` instead,
which gives the same answer and needs no networkx on the card's machine.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import breadth_first_order, connected_components


@dataclasses.dataclass(frozen=True)
class Topology:
    """A static communication graph over ``num_nodes`` nodes.

    ``adjacency[j, i] == True`` iff node ``i`` is an in-neighbor of node ``j``
    (node j receives messages from node i).  Self-loops are always False —
    the node's own value is handled separately by the screening rules.
    """

    adjacency: np.ndarray  # [M, M] bool
    num_byzantine: int  # the bound b the protocol is configured for

    def __post_init__(self):
        adj = np.asarray(self.adjacency, dtype=bool)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"adjacency must be square, got {adj.shape}")
        if adj.diagonal().any():
            raise ValueError("adjacency must not contain self-loops")
        object.__setattr__(self, "adjacency", adj)

    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def in_degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    @property
    def min_in_degree(self) -> int:
        return int(self.in_degrees.min())

    def neighbors(self, j: int) -> np.ndarray:
        return np.nonzero(self.adjacency[j])[0]

    def validate_for_rule(self, rule: str) -> None:
        """Check the per-rule minimum neighborhood sizes of Table II."""
        from repro_torch.core.screening import min_neighbors

        need = min_neighbors(rule, self.num_byzantine)
        if self.min_in_degree < need:
            raise ValueError(
                f"rule {rule!r} with b={self.num_byzantine} needs min in-degree "
                f">= {need}, graph has {self.min_in_degree}"
            )


# Above this node count `erdos_renyi` defaults to the degree-only recipe
# (the reference's threshold, kept so both packages certify the same graphs).
DEGREE_ONLY_NODES = 128


def erdos_renyi(
    num_nodes: int,
    p: float,
    num_byzantine: int,
    *,
    seed: int = 0,
    max_tries: int = 200,
    check_samples: int = 50,
    assumption4: str = "auto",
) -> Topology:
    """An undirected-as-bidirectional ER graph whose minimum degree exceeds
    2b and which passes the sampled reduced-graph check (Sec. V's recipe).
    Consumes ``np.random.default_rng(seed)`` in exactly the reference's
    order, so both packages return the same graph for the same seed."""
    if assumption4 not in ("auto", "sampled", "degree"):
        raise ValueError(f"assumption4 must be auto|sampled|degree, got {assumption4!r}")
    sample = assumption4 == "sampled" or (
        assumption4 == "auto" and num_nodes <= DEGREE_ONLY_NODES)
    rng = np.random.default_rng(seed)
    b = num_byzantine
    for _ in range(max_tries):
        upper = rng.random((num_nodes, num_nodes)) < p
        adj = np.triu(upper, 1)
        adj = adj | adj.T
        np.fill_diagonal(adj, False)
        topo = Topology(adjacency=adj, num_byzantine=b)
        if topo.min_in_degree <= 2 * b:
            continue
        if not sample:
            return topo
        if check_assumption4(topo, num_samples=check_samples, seed=int(rng.integers(2**31))):
            return topo
    raise RuntimeError(
        f"could not generate ER({num_nodes}, {p}) graph satisfying Assumption 4 "
        f"with b={b} in {max_tries} tries"
    )


def ring_of_cliques(num_cliques: int, clique_size: int, num_byzantine: int) -> Topology:
    """Cliques joined in a ring (the first node of each clique to the next
    clique's first): a stress case for consensus, which generally fails
    Assumption 4 for b > 0."""
    m = num_cliques * clique_size
    adj = np.zeros((m, m), dtype=bool)
    for c in range(num_cliques):
        lo = c * clique_size
        adj[lo:lo + clique_size, lo:lo + clique_size] = ~np.eye(clique_size, dtype=bool)
        nxt = ((c + 1) % num_cliques) * clique_size
        adj[lo, nxt] = adj[nxt, lo] = True
    return Topology(adjacency=adj, num_byzantine=num_byzantine)


def complete_graph(num_nodes: int, num_byzantine: int) -> Topology:
    adj = ~np.eye(num_nodes, dtype=bool)
    return Topology(adjacency=adj, num_byzantine=num_byzantine)


def small_world(
    num_nodes: int,
    nearest: int,
    num_byzantine: int,
    *,
    rewire_prob: float = 0.2,
    seed: int = 0,
    max_degree: int | None = None,
) -> Topology:
    """Watts-Strogatz small world, the graph of the sparse layout's scale
    runs: a ring lattice where every node links its ``nearest`` neighbors
    on each side, each edge's far endpoint rewired to a uniform node with
    probability ``rewire_prob``.  Edges stay bidirectional; a rewire must
    keep the old endpoint above the Table-II floor ``2b + 1`` and the new
    one below the degree cap ``max_degree`` (default ``2 * nearest + 4``),
    so ``K = max in-degree`` is bounded.  Consumes
    ``np.random.default_rng(seed)`` in the reference's order."""
    m, k = num_nodes, nearest
    if not 1 <= k < m // 2:
        raise ValueError(f"need 1 <= nearest < num_nodes/2, got {k} vs {m}")
    need = 2 * num_byzantine + 1
    if 2 * k < need:
        raise ValueError(
            f"small_world(nearest={k}) has min degree {2 * k} < 2b+1 = {need}")
    cap = max_degree if max_degree is not None else 2 * k + 4
    if cap < 2 * k:
        raise ValueError(f"max_degree={cap} below the lattice degree {2 * k}")
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), dtype=bool)
    for j in range(m):
        for off in range(1, k + 1):
            adj[j, (j + off) % m] = True
    adj = adj | adj.T
    deg = adj.sum(axis=1)
    for j in range(m):
        for off in range(1, k + 1):
            if rng.random() < rewire_prob:
                tgt = (j + off) % m
                cand = int(rng.integers(m))
                if (cand != j and not adj[j, cand] and adj[j, tgt]
                        and deg[tgt] > need and deg[cand] < cap and deg[j] <= cap):
                    adj[j, tgt] = adj[tgt, j] = False
                    adj[j, cand] = adj[cand, j] = True
                    deg[tgt] -= 1
                    deg[cand] += 1
    np.fill_diagonal(adj, False)
    topo = Topology(adjacency=adj, num_byzantine=num_byzantine)
    if topo.min_in_degree < need:
        raise RuntimeError("small_world: a rewire broke the 2b+1 degree floor")
    return topo


def random_geometric(num_nodes: int, num_byzantine: int, *, radius: float | None = None,
                     seed: int = 0, max_tries: int = 50) -> Topology:
    """Random geometric graph: nodes uniform in the unit square, edges within
    ``radius``.  ``radius=None`` starts at the connectivity threshold
    ``sqrt(2 log M / M)`` and grows it by 1.15 until every node clears the
    Table-II minimum degree ``2b + 1``."""
    m, b = num_nodes, num_byzantine
    rng = np.random.default_rng(seed)
    pts = rng.random((m, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    r = radius if radius is not None else float(np.sqrt(2.0 * np.log(max(m, 2)) / m))
    need = 2 * b + 1
    for _ in range(max_tries):
        adj = d2 <= r * r
        np.fill_diagonal(adj, False)
        topo = Topology(adjacency=adj, num_byzantine=b)
        if topo.min_in_degree >= need:
            return topo
        if radius is not None:
            break
        r *= 1.15
    raise RuntimeError(f"random_geometric({m}, r={r:.3f}) min degree {int(adj.sum(1).min())} "
                       f"< {need} for b={b}")


def toroidal_grid(rows: int, cols: int, num_byzantine: int, *,
                  diagonal: bool = False) -> Topology:
    """``rows x cols`` torus: every node links its 4 lattice neighbors (8
    with ``diagonal=True``) with wraparound."""
    m = rows * cols
    if rows < 3 or cols < 3:
        raise ValueError(f"torus needs rows, cols >= 3, got {rows}x{cols}")
    need = 2 * num_byzantine + 1
    if (8 if diagonal else 4) < need:
        raise ValueError(f"toroidal grid degree {8 if diagonal else 4} < 2b+1 = {need}")
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if diagonal:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    adj = np.zeros((m, m), dtype=bool)
    r, c = np.divmod(np.arange(m), cols)
    for dr, dc in offs:
        adj[np.arange(m), ((r + dr) % rows) * cols + (c + dc) % cols] = True
    np.fill_diagonal(adj, False)
    return Topology(adjacency=adj, num_byzantine=num_byzantine)


def _torus_of(m: int, b: int, arg) -> Topology:
    rows = int(arg) if arg is not None else int(np.sqrt(m))
    if rows < 1 or m % rows:
        raise ValueError(f"torus of {m} nodes needs a row count dividing it, got {rows}")
    return toroidal_grid(rows, m // rows, b)


# Named topology builders: ``spec`` strings like ``"small_world:8"``
# (`make_topology`), the registry the network scenarios name.
TOPOLOGIES = {
    "erdos_renyi": lambda m, b, seed, arg: erdos_renyi(
        m, arg if arg is not None else 0.5, b, seed=seed),
    "small_world": lambda m, b, seed, arg: small_world(
        m, int(arg) if arg is not None else max(2 * b + 1, 4), b, seed=seed),
    "geometric": lambda m, b, seed, arg: random_geometric(m, b, radius=arg, seed=seed),
    "torus": lambda m, b, seed, arg: _torus_of(m, b, arg),
    "complete": lambda m, b, seed, arg: complete_graph(m, b),
}


def make_topology(spec: str, num_nodes: int, num_byzantine: int, *, seed: int = 0) -> Topology:
    """Build a named topology: ``spec`` is ``name`` or ``name:<arg>``, the
    argument family-specific (ER edge probability, small-world ``nearest``,
    geometric radius, torus row count)."""
    name, _, arg = spec.partition(":")
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; options: {sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](num_nodes, num_byzantine, seed, float(arg) if arg else None)


def _has_source_component(adj: np.ndarray, min_size: int) -> bool:
    """True iff the digraph has an SCC of size >= min_size from which every
    node is reachable (Definition 2).  ``adj[j, i]`` means i sends to j, so
    the edge list is ``adj.T``.  Reaching every node from one member of an
    SCC is the same as its condensation node reaching every other one."""
    graph = csr_matrix(adj.T.astype(np.int8))
    n_total = adj.shape[0]
    n_comp, labels = connected_components(graph, directed=True, connection="strong")
    sizes = np.bincount(labels, minlength=n_comp)
    for comp in np.nonzero(sizes >= min_size)[0]:
        root = int(np.argmax(labels == comp))
        reached = breadth_first_order(graph, root, directed=True, return_predecessors=False)
        if len(reached) == n_total:
            return True
    return False


def check_assumption4(
    topo: Topology,
    *,
    num_samples: int = 50,
    seed: int = 0,
    byzantine_sets: Sequence[Sequence[int]] | None = None,
) -> bool:
    """Randomized check of Assumption 4: for sampled Byzantine sets of size
    b, remove b random incoming edges per honest node and require a source
    component of size b+1 in what remains.  False is definitive for the
    sampled instance; True means no counterexample was found."""
    rng = np.random.default_rng(seed)
    m, b = topo.num_nodes, topo.num_byzantine
    if b == 0:
        return _has_source_component(topo.adjacency, 1)
    sets = byzantine_sets
    if sets is None:
        sets = [rng.choice(m, size=b, replace=False) for _ in range(num_samples)]
    for byz in sets:
        byz = np.asarray(byz)
        keep = np.setdiff1d(np.arange(m), byz)
        red = topo.adjacency[np.ix_(keep, keep)].copy()
        for row in range(red.shape[0]):
            ins = np.nonzero(red[row])[0]
            if len(ins) > 0:
                drop = rng.choice(ins, size=min(b, len(ins)), replace=False)
                red[row, drop] = False
        if not _has_source_component(red, b + 1):
            return False
    return True
