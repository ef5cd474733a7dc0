"""The sorting networks of the screening kernels, written once.

The screens sort each column of a node's rows in registers with Batcher's
odd-even merge network, the schedule the reference sorts with
(`repro.core.screening._batcher_pairs`, copied here: the port imports
nothing of the JAX package).  A block knows its row count only after it
has compacted its neighbor list, so the kernels hold one network per
*bucket* of row counts (`BUCKETS`) and pick, block-uniformly, the smallest
bucket that holds the count (`bucket`).  A bucket's network is Batcher's
schedule for exactly that many rows: the power-of-two network with every
comparator that would touch a row past the bucket pruned, and the rows
between the count and the bucket hold +inf, which sort last.

The gather tile kernel sorts each node's exact row count up to
`EXACT_ROWS` (`for_rows`: a network of every size 1..24, then the buckets
above), and its median keeps of each exact network only the
compare-exchanges that feed the two middle positions (`median_pairs`, a
selection network).

`header` writes the networks as straight-line C++ (every index a
constant, so a column stays in registers); `build` writes it next to the
library and compiles the kernels against it, so the list a CPU test reads
back from that text is the list the card runs.
"""
from __future__ import annotations

import functools

# Row-count buckets: steps of 8 up to 64, of 16 up to 128 (the kernels'
# largest network, `MAX_ROWS`).
BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128)
MAX_ROWS = BUCKETS[-1]
# Row counts the gather tile kernel sorts with a network of exactly their
# size; the sizes the header compiles.
EXACT_ROWS = 24
SIZES = tuple(sorted(set(range(1, EXACT_ROWS + 1)) | set(BUCKETS)))
HEADER = "screen_networks.cuh"


@functools.cache
def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher's odd-even merge sort schedule for ``n`` rows: the
    compare-exchanges ``(lo, hi)`` in order (the reference's
    ``_batcher_pairs``)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


@functools.cache
def median_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """`batcher_pairs` of ``n`` rows pruned to the compare-exchanges whose
    outputs reach positions ``(n - 1) // 2`` and ``n // 2`` (a backward
    pass over the schedule): a selection network that leaves those two
    positions what the full network leaves there."""
    need, keep = {(n - 1) // 2, n // 2}, []
    for a, b in reversed(batcher_pairs(n)):
        if a in need or b in need:
            keep.append((a, b))
            need |= {a, b}
    return tuple(reversed(keep))


def bucket(rows: int) -> int:
    """The smallest bucket that holds ``rows`` rows (0 <= rows <= MAX_ROWS)."""
    if not 0 <= rows <= MAX_ROWS:
        raise ValueError(f"the screening networks sort 0..{MAX_ROWS} rows, got {rows}")
    return next(b for b in BUCKETS if rows <= b)


def _network(out: list, name: str, n: int, pairs) -> None:
    out.append(f"// {n} rows: {len(pairs)} compare-exchanges")
    out.append("template <>")
    out.append(f"__device__ __forceinline__ void {name}<{n}>(float (&v)[{n}]) {{")
    for i in range(0, len(pairs), 6):
        out.append("  " + " ".join(f"SCREEN_CX({a}, {b})" for a, b in pairs[i:i + 6]))
    out.append("}")
    out.append("")


def _dispatch(out: list, name: str, sizes) -> None:
    out.append("template <int NMAX, class Body>")
    out.append(f"__device__ __forceinline__ void {name}(int rows, Body&& body) {{")
    lower = 0
    for n in sizes:
        out.append(f"  if constexpr (NMAX >= {n}) {{")
        out.append(f"    if (rows <= {n}) {{")
        out.append(f"      body(Bucket<{n}, {lower + 1 if lower else 0}>{{}});")
        out.append("      return;")
        out.append("    }")
        out.append("  }")
        lower = n
    out.append("}")
    out.append("")


def header() -> str:
    """The C++ header the screening kernels include: one ``batcher_sort``
    specialization per size (`SIZES`), one ``median_select`` per exact size,
    ``for_bucket``, the block-uniform dispatch of a row count to its bucket,
    and ``for_rows``, the gather kernel's dispatch to its exact size (up to
    `EXACT_ROWS`) or bucket."""
    out = [
        "// Generated by src/repro_torch/kernels/networks.py at build time; do not edit.",
        "// Batcher's odd-even merge networks over each row count the kernels sort,",
        "// their median selection networks, and the dispatch of a row count.",
        "#pragma once",
        "",
        "namespace screen {",
        "",
        f"constexpr int kMaxNetworkRows = {MAX_ROWS};",
        f"constexpr int kExactRows = {EXACT_ROWS};",
        "",
        "// Ascending compare-exchange of v[i] and v[j] (i < j); the inputs are",
        "// NaN-free (sanitized), so fminf/fmaxf select, they never round.",
        "#define SCREEN_CX(i, j)                   \\",
        "  {                                       \\",
        "    const float lo_ = fminf(v[i], v[j]);  \\",
        "    const float hi_ = fmaxf(v[i], v[j]);  \\",
        "    v[i] = lo_;                           \\",
        "    v[j] = hi_;                           \\",
        "  }",
        "",
        "template <int N>",
        "__device__ __forceinline__ void batcher_sort(float (&v)[N]);",
        "",
        "// v[(N - 1) / 2] and v[N / 2] as batcher_sort<N> leaves them; the rest",
        "// partly sorted.",
        "template <int N>",
        "__device__ __forceinline__ void median_select(float (&v)[N]);",
        "",
    ]
    for n in SIZES:
        _network(out, "batcher_sort", n, batcher_pairs(n))
    for n in range(1, EXACT_ROWS + 1):
        _network(out, "median_select", n, median_pairs(n))
    out += [
        "#undef SCREEN_CX",
        "",
        "// A network size N for row counts in [LO, N]; N == LO: exactly N rows.",
        "template <int N, int LO>",
        "struct Bucket {",
        "  static constexpr int value = N;",
        "  static constexpr int lo = LO;",
        "};",
        "",
        "// Calls body(Bucket<N, LO>{}) for the smallest bucket N >= rows among",
        "// those <= NMAX; rows must be <= NMAX.  `rows` is uniform over the block,",
        "// so the branch does not diverge.",
    ]
    _dispatch(out, "for_bucket", BUCKETS)
    out += [
        "// for_bucket over every size up to kExactRows, then the buckets: rows",
        "// up to 24 get a network of exactly their size.  `rows` must be uniform",
        "// over the warp.",
    ]
    _dispatch(out, "for_rows", SIZES)
    out += ["}  // namespace screen", ""]
    return "\n".join(out)
