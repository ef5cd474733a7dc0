"""The sorting networks the screening kernels compile (`repro_torch.kernels.networks`),
held to the reference's schedule and checked to sort, on the CPU.

The kernels include the header `networks.header` writes at build time, so
the list a test reads back from that text is the list the card runs.
"""
import itertools

import numpy as np
import pytest

from repro.core.screening import _batcher_pairs
from repro_torch.kernels import networks


def compiled_pairs(text: str, name: str = "batcher_sort") -> dict[int, tuple[tuple[int, int], ...]]:
    """The compare-exchanges of each network ``name`` as the header text
    spells them."""
    nets, current = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(f"__device__ __forceinline__ void {name}<"):
            current = int(line.split("<", 1)[1].split(">", 1)[0])
            nets[current] = []
        elif line == "}":
            current = None
        elif current is not None and line.startswith("SCREEN_CX("):
            for item in line.split("SCREEN_CX(")[1:]:
                a, b = item.split(")")[0].split(",")
                nets[current].append((int(a), int(b)))
    return {n: tuple(p) for n, p in nets.items()}


def apply_network(pairs, x: np.ndarray) -> np.ndarray:
    """The compare-exchanges ``pairs`` applied along the last axis of ``x``
    with min/max, as the kernels apply them."""
    x = x.copy()
    for a, b in pairs:
        lo = np.minimum(x[..., a], x[..., b])
        hi = np.maximum(x[..., a], x[..., b])
        x[..., a], x[..., b] = lo, hi
    return x


@pytest.mark.parametrize("n", range(networks.MAX_ROWS + 1))
def test_schedule_equals_reference(n):
    assert networks.batcher_pairs(n) == _batcher_pairs(n)


def test_compiled_networks_are_the_reference_schedule():
    """Every size the kernels sort (the buckets, and each size up to
    EXACT_ROWS for the gather tile kernel) is the reference's schedule."""
    compiled = compiled_pairs(networks.header())
    assert sorted(compiled) == list(networks.SIZES)
    assert set(networks.BUCKETS) <= set(networks.SIZES)
    assert set(range(1, networks.EXACT_ROWS + 1)) <= set(networks.SIZES)
    for n, pairs in compiled.items():
        assert pairs == _batcher_pairs(n), n
        assert all(0 <= a < b < n for a, b in pairs)


@pytest.mark.parametrize("n", range(1, 17))
def test_network_sorts_every_01_input(n):
    """The 0-1 principle: a comparator network that sorts every 0-1 input
    sorts every input."""
    bits = np.array(list(itertools.product((0.0, 1.0), repeat=n)), np.float32)
    out = apply_network(networks.batcher_pairs(n), bits)
    np.testing.assert_array_equal(out, np.sort(bits, axis=-1))


@pytest.mark.parametrize("n", networks.BUCKETS)
def test_bucket_network_sorts_padded_columns(n):
    """Each bucket's network on columns of every row count the bucket takes:
    random values with +-inf, repeated values and +-0, +inf padding."""
    rng = np.random.default_rng(n)
    pairs = compiled_pairs(networks.header())[n]
    lower = max(b for b in (0, *networks.BUCKETS) if b < n)
    for count in range(lower + 1, n + 1):
        x = rng.normal(size=(64, n)).astype(np.float32)
        x[:, : n // 3] = np.round(x[:, : n // 3])  # repeats
        x[rng.random(x.shape) < 0.05] = np.inf
        x[rng.random(x.shape) < 0.05] = -np.inf
        x[rng.random(x.shape) < 0.05] = -0.0
        x[:, count:] = np.inf  # the padded slots
        out = apply_network(pairs, x)
        np.testing.assert_array_equal(out, np.sort(x, axis=-1))


def test_bucket_covers_every_count():
    for rows in range(networks.MAX_ROWS + 1):
        b = networks.bucket(rows)
        assert b in networks.BUCKETS and rows <= b
        assert all(c < rows for c in networks.BUCKETS if c < b)
    for rows in (-1, networks.MAX_ROWS + 1):
        with pytest.raises(ValueError):
            networks.bucket(rows)


def test_header_dispatches_every_bucket_in_order():
    """for_bucket takes the buckets, for_rows every size up to EXACT_ROWS
    and the buckets above, each once, in ascending order, with the least row
    count each takes."""
    text = networks.header()
    dense = text[text.index("void for_bucket("):text.index("void for_rows(")]
    exact = text[text.index("void for_rows("):]
    for body, sizes in ((dense, networks.BUCKETS), (exact, networks.SIZES)):
        at = [body.index(f"if (rows <= {b})") for b in sizes]
        assert at == sorted(at)
        lows = (0, *(a + 1 for a in sizes[:-1]))
        assert all(body.count(f"body(Bucket<{b}, {lo}>{{}});") == 1
                   for b, lo in zip(sizes, lows, strict=True))


@pytest.mark.parametrize("n", range(1, networks.EXACT_ROWS + 1))
def test_median_selection_networks(n):
    """The median's selection network is the compiled one, a subset of the
    full schedule in its order, and leaves the two middle positions what a
    sort leaves there: on every 0-1 input up to 16 rows (the 0-1 principle
    holds for selection networks) and on random columns with repeats,
    +-inf and +-0."""
    pairs = networks.median_pairs(n)
    assert compiled_pairs(networks.header(), "median_select")[n] == pairs
    full = networks.batcher_pairs(n)
    it = iter(full)
    assert all(p in it for p in pairs)  # a subsequence of the full schedule
    mid = sorted({(n - 1) // 2, n // 2})
    if n <= 16:
        x = np.array(list(itertools.product((0.0, 1.0), repeat=n)), np.float32)
    else:
        rng = np.random.default_rng(n)
        x = rng.normal(size=(4096, n)).astype(np.float32)
        x[:, : n // 3] = np.round(x[:, : n // 3])
        x[rng.random(x.shape) < 0.05] = np.inf
        x[rng.random(x.shape) < 0.05] = -np.inf
        x[rng.random(x.shape) < 0.05] = -0.0
    out = apply_network(pairs, x)
    np.testing.assert_array_equal(out[:, mid], np.sort(x, axis=-1)[:, mid])


def compiled_warp_steps(text: str, regs: int) -> list[tuple[tuple, ...]]:
    """The steps of ``warp_sort<regs>`` as the header text spells them: one
    line a step, each op as `networks.warp_schedule` writes it."""
    start = text.index(f"__device__ __forceinline__ void warp_sort<{regs}>(")
    body = text[text.index("\n", start) + 1:text.index("\n}", start)]
    names = {"WCX": "cx", "WSH": "sh", "WSHM": "shm"}
    steps = []
    for line in body.splitlines():
        ops = []
        for call in line.split(")")[:-1]:
            name, args = call.strip().split("(")
            ops.append((names[name], *(int(a) for a in args.split(","))))
        steps.append(tuple(ops))
    return steps


def warp_exchanges(step, regs: int) -> dict[int, tuple[str, int]]:
    """What each row of the column takes in one step: ``("min" | "max",
    partner row)``, row i being register i % regs of lane i // regs."""
    got = {}
    for op in step:
        for lane in range(networks.WARP):
            keep = "max" if op[0] != "cx" and (lane >> op[-1]) & 1 else "min"
            if op[0] == "cx":
                a, b = lane * regs + op[1], lane * regs + op[2]
                got[a], got[b] = ("min", b), ("max", a)
            elif op[0] == "sh":
                got[lane * regs + op[1]] = (keep, (lane ^ op[2]) * regs + op[1])
            else:
                r, s, m = op[1:4]
                got[lane * regs + r] = (keep, (lane ^ m) * regs + s)
                got[lane * regs + s] = (keep, (lane ^ m) * regs + r)
    return got


def run_exchanges(exchanges, x: np.ndarray) -> np.ndarray:
    """The steps ``exchanges`` (`warp_exchanges` of each) applied along the
    last axis of ``x``: each row takes the min or the max of its value and
    its partner's, all rows of a step from the values the step started
    from, as the lanes' registers and shuffles do."""
    for ex in exchanges:
        keep, partner = zip(*(ex[i] for i in range(len(ex))), strict=True)
        other = x[..., list(partner)]
        x = np.where(np.array(keep) == "min", np.minimum(x, other), np.maximum(x, other))
    return x


def merge_inputs(k: int, p: int, rng, most: int = 1 << 18) -> np.ndarray:
    """0-1 columns of ``p`` rows whose half blocks (``k / 2`` rows) are each
    ascending: z1 zeros then ones in the first half of a block of k, z2 in
    the second, one (z1, z2) a block.  Every pair (z1, z2) where they fit in
    ``most`` values; else as many, drawn at random."""
    h = k // 2
    pairs = [(z1, z2) for z1 in range(h + 1) for z2 in range(h + 1)]
    if len(pairs) * k > most:
        pairs = [pairs[i] for i in rng.choice(len(pairs), size=most // k, replace=False)]
    pairs += [pairs[i % len(pairs)] for i in range(-len(pairs) % (p // k))]  # whole columns
    blocks = np.ones((len(pairs), k), np.float32)
    for row, (z1, z2) in enumerate(pairs):
        blocks[row, :z1] = 0.0
        blocks[row, h:h + z2] = 0.0
    return blocks.reshape(-1, p)


@pytest.mark.parametrize("regs", networks.WARP_REGS)
def test_warp_networks(regs):
    """The wide path's warp sort of 32 R rows: the header's text is the
    generator's schedule; every step pairs rows as the bitonic sorter does
    (merge k, stride j: row i with i ^ (k - 1) at j = k / 2, with i ^ j
    after, the min to the lower row); a numpy model of the lanes and
    registers running that text sorts random columns with ties, +-inf and
    +-0 as np.sort does; and it sorts every 0-1 input up to 64 rows (so,
    by the 0-1 principle, every input): each merge takes every 0-1 column
    whose half blocks are ascending to ascending blocks (the merges of 128
    rows and more, a sample of 2^18 values of such columns)."""
    p = networks.WARP * regs
    steps = compiled_warp_steps(networks.header(), regs)
    assert tuple(steps) == networks.warp_schedule(regs)
    exchanges = [warp_exchanges(step, regs) for step in steps]
    for ex, (k, j) in zip(exchanges, networks.warp_steps(regs), strict=True):
        partner = [i ^ (k - 1) if j == k // 2 else i ^ j for i in range(p)]
        assert ex == {i: ("min" if i < q else "max", q) for i, q in enumerate(partner)}, (k, j)

    rng = np.random.default_rng(regs)
    x = rng.normal(size=(64, p)).astype(np.float32)
    x[:, : p // 3] = np.round(x[:, : p // 3])  # ties
    x[rng.random(x.shape) < 0.05] = np.inf
    x[rng.random(x.shape) < 0.05] = -np.inf
    x[rng.random(x.shape) < 0.05] = -0.0
    x[rng.random(x.shape) < 0.05] = 0.0
    np.testing.assert_array_equal(run_exchanges(exchanges, x), np.sort(x, axis=-1))

    by_merge = {}
    for ex, (k, _) in zip(exchanges, networks.warp_steps(regs), strict=True):
        by_merge.setdefault(k, []).append(ex)
    for k, merge in by_merge.items():
        bits = merge_inputs(k, p, rng)
        np.testing.assert_array_equal(run_exchanges(merge, bits),
                                      np.sort(bits.reshape(len(bits), -1, k), axis=-1).reshape(bits.shape))
