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


def bucket(rows: int) -> int:
    """The smallest bucket that holds ``rows`` rows (0 <= rows <= MAX_ROWS)."""
    if not 0 <= rows <= MAX_ROWS:
        raise ValueError(f"the screening networks sort 0..{MAX_ROWS} rows, got {rows}")
    return next(b for b in BUCKETS if rows <= b)


def header() -> str:
    """The C++ header the screening kernels include: one
    ``batcher_sort`` specialization per bucket and ``for_bucket``, the
    block-uniform dispatch on a row count."""
    out = [
        "// Generated by src/repro_torch/kernels/networks.py at build time; do not edit.",
        "// Batcher's odd-even merge networks over each row-count bucket, and the",
        "// dispatch of a row count to its bucket.",
        "#pragma once",
        "",
        "namespace screen {",
        "",
        f"constexpr int kMaxNetworkRows = {MAX_ROWS};",
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
    ]
    for n in BUCKETS:
        pairs = batcher_pairs(n)
        out.append(f"// {n} rows: {len(pairs)} compare-exchanges")
        out.append("template <>")
        out.append(f"__device__ __forceinline__ void batcher_sort<{n}>(float (&v)[{n}]) {{")
        for i in range(0, len(pairs), 6):
            out.append("  " + " ".join(f"SCREEN_CX({a}, {b})" for a, b in pairs[i:i + 6]))
        out.append("}")
        out.append("")
    out += [
        "#undef SCREEN_CX",
        "",
        "template <int N>",
        "struct Bucket {",
        "  static constexpr int value = N;",
        "};",
        "",
        "// Calls body(Bucket<N>{}) for the smallest bucket N >= rows among those",
        "// <= NMAX; rows must be <= NMAX.  `rows` is uniform over the block, so",
        "// the branch does not diverge.",
        "template <int NMAX, class Body>",
        "__device__ __forceinline__ void for_bucket(int rows, Body&& body) {",
    ]
    for n in BUCKETS:
        out.append(f"  if constexpr (NMAX >= {n}) {{")
        out.append(f"    if (rows <= {n}) {{")
        out.append(f"      body(Bucket<{n}>{{}});")
        out.append("      return;")
        out.append("    }")
        out.append("  }")
    out += ["}", "", "}  // namespace screen", ""]
    return "\n".join(out)
