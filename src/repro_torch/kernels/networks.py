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

The wide path (``csrc/screen_wide.cuh``) sorts a column of P = 32 R rows
(R = 1, 2, ..., 64, `WARP_REGS`) across the 32 lanes of a warp, R values a
lane, with a bitonic sorter (`warp_schedule`): every compare-exchange
ascends, since each merge's first step compares the two halves of a block
mirrored (i with i ^ (k - 1)) instead of sorting one half descending, so
no lane needs a direction bit.  Strides below R pair registers of one
lane; strides of R and above pair lanes through a shuffle.

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
# The wide path's warp sorts: R registers a lane, P = WARP * R rows.
WARP = 32
WARP_REGS = (1, 2, 4, 8, 16, 32, 64)


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


@functools.cache
def warp_steps(regs: int) -> tuple[tuple[int, int], ...]:
    """The bitonic sorter's steps over P = 32 ``regs`` rows: ``(k, j)``,
    merge size k = 2, 4, ..., P, then stride j = k/2, ..., 1 in each."""
    p = WARP * regs
    return tuple((k, j) for k in (2 ** e for e in range(1, p.bit_length()))
                 for j in (k >> e for e in range(1, k.bit_length())))


@functools.cache
def warp_schedule(regs: int) -> tuple[tuple[tuple, ...], ...]:
    """The warp sort of 32 ``regs`` rows in the blocked layout (row
    i = lane * regs + r in register r of lane ``lane``), one tuple of ops a
    step of `warp_steps`.  Step (k, j) pairs row i with i ^ (k - 1) when
    j = k / 2 (the mirrored halves of each block of k) and with i ^ j
    after, the min going to the lower row.  Ops, as the header spells them:

    * ``("cx", a, b)``: registers a < b of every lane (j < regs);
    * ``("sh", r, m, bit)``: register r against the same register of lane
      ``lane ^ m`` (j >= regs), the min kept where lane bit ``bit`` is clear;
    * ``("shm", r, s, m, bit)``: registers r and s = regs - 1 - r against
      registers s and r of lane ``lane ^ m`` (a mirror step, k > regs > 1),
      the min kept where lane bit ``bit`` is clear."""
    if regs not in WARP_REGS:
        raise ValueError(f"the warp sorts hold {WARP_REGS} registers a lane, got {regs}")
    steps = []
    for k, j in warp_steps(regs):
        mirror = j == k // 2
        if j < regs:  # inside a lane: blocks of k <= regs, or a half-cleaner
            ops = []
            for r in range(regs):
                s = r ^ (k - 1) if mirror else r ^ j
                if r < s:
                    ops.append(("cx", r, s))
        else:  # across lanes: the lane part of i ^ (k - 1) or i ^ j
            bit = (j // regs).bit_length() - 1  # lane bit of the stride
            if mirror and regs > 1:
                ops = [("shm", r, regs - 1 - r, k // regs - 1, bit) for r in range(regs // 2)]
            elif mirror:  # one register a lane: its mirror is itself
                ops = [("sh", 0, k - 1, bit)]
            else:
                ops = [("sh", r, j // regs, bit) for r in range(regs)]
        steps.append(tuple(ops))
    return tuple(steps)


def _warp_network(out: list, regs: int) -> None:
    steps = warp_schedule(regs)
    lane_steps = sum(1 for k, j in warp_steps(regs) if j >= regs)
    out.append(f"// {regs} register{'s' if regs > 1 else ''} a lane, {WARP * regs} rows: "
               f"{len(steps)} steps, {len(steps) - lane_steps} in registers, {lane_steps} across lanes")
    out.append("template <>")
    out.append(f"__device__ __forceinline__ void warp_sort<{regs}>(float (&v)[{regs}], int lane) {{")
    spell = {"cx": "WCX", "sh": "WSH", "shm": "WSHM"}
    for ops in steps:
        out.append("  " + " ".join(f"{spell[op[0]]}({', '.join(map(str, op[1:]))})" for op in ops))
    out.append("}")
    out.append("")


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
    one ``warp_sort`` per register count (`WARP_REGS`), ``for_bucket``, the
    block-uniform dispatch of a row count to its bucket, and ``for_rows``,
    the gather kernel's dispatch to its exact size (up to `EXACT_ROWS`) or
    bucket."""
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
        "// The wide path's warp sorts (screen_wide.cuh): row i of a column of",
        "// 32 R rows is v[i % R] of lane i / R; warp_sort<R> leaves the column",
        "// ascending.  WCX: registers a < b of this lane.  WSH: register r",
        "// against register r of lane ^ m.  WSHM: registers r and s against",
        "// registers s and r of lane ^ m.  Across lanes the lane whose bit",
        "// `bit` is clear keeps the min, its partner the max.  Every lane of",
        "// the warp runs every step (the shuffles name all 32).",
        "#define WCX(a, b)                         \\",
        "  {                                       \\",
        "    const float lo_ = fminf(v[a], v[b]);  \\",
        "    const float hi_ = fmaxf(v[a], v[b]);  \\",
        "    v[a] = lo_;                           \\",
        "    v[b] = hi_;                           \\",
        "  }",
        "#define WKEEP(x, o, bit) ((lane >> (bit)) & 1 ? fmaxf(x, o) : fminf(x, o))",
        "#define WSH(r, m, bit)                                       \\",
        "  {                                                          \\",
        "    const float o_ = __shfl_xor_sync(0xffffffffu, v[r], m);  \\",
        "    v[r] = WKEEP(v[r], o_, bit);                             \\",
        "  }",
        "#define WSHM(r, s, m, bit)                                   \\",
        "  {                                                          \\",
        "    const float or_ = __shfl_xor_sync(0xffffffffu, v[s], m); \\",
        "    const float os_ = __shfl_xor_sync(0xffffffffu, v[r], m); \\",
        "    v[r] = WKEEP(v[r], or_, bit);                            \\",
        "    v[s] = WKEEP(v[s], os_, bit);                            \\",
        "  }",
        "",
        "template <int R>",
        "__device__ __forceinline__ void warp_sort(float (&v)[R], int lane);",
        "",
    ]
    for regs in WARP_REGS:
        _warp_network(out, regs)
    out += [
        "#undef WCX",
        "#undef WKEEP",
        "#undef WSH",
        "#undef WSHM",
        "",
        f"constexpr int kWarpRegsMax = {WARP_REGS[-1]};",
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
