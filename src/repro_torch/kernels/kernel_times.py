"""Device times of the screening, decode and distance kernels at the main
path's shapes, on one CUDA card; a script, not part of the package's API.

    python src/repro_torch/kernels/kernel_times.py                     # this checkout
    python src/repro_torch/kernels/kernel_times.py --src OTHER/src     # another checkout's kernels
    python src/repro_torch/kernels/kernel_times.py --compare OTHER/src # OTHER, this, this, OTHER
    python src/repro_torch/kernels/kernel_times.py [--compare OTHER/src] --decide  # decide forms
    python src/repro_torch/kernels/kernel_times.py --sweep             # every pairwise plan
    python src/repro_torch/kernels/kernel_times.py --sweep-gather [--parent OTHER/src]

Each time is the median over 25 repetitions of the mean device time of 10
calls (CUDA events, the stream parked first so the events time the device),
as `chip_smoke.py` times.  The inputs are seeded with numpy, so two
checkouts time the same data: the dense screens at M = 50, d = 7850 on
``erdos_renyi(50, 0.5, 4)`` (float rows and the int8 codec's codewords), on
two single-bucket graphs of the same M (every in-degree 24, every in-degree
31) and on all 49 senders; the gather screens and the decodes at M = 512,
d = 7850 on ``small_world(512, 6, 2)`` (K = 16), the gather screens also on
``small_world(512, 8, 2)`` (K = 20) and on a table of 8-16 random senders a
node (K = 16, few rows shared); the distances at ``[50, 7850]``,
``[100, 7850]`` and ``[512, 7850]``, and batched (`batched_shapes`: each
node's mailbox views and itself at sparse M = 512, K = 16, at M = 20 and at
dense M = 50, that one also with a batch stride of 0, and a K / B grid
group, E = 8, M = 50) beside ``torch.bmm`` with the same epilogue and,
where the checkout has two bodies, its cluster body forced; and, where
the checkout has the wide screening path, the register screens at
M = 128 and the wide path's four screens (float and codeword rows,
trimmed mean and median) at dense M = 129 and 513 and gather K = 64 and
200 (random tables, M = 512), with the medians' library call beside
them; the decode also at the main path's ``[50, 3925]`` (topk50_int8's
kept values); where the checkout has them, the screens' decide forms
(`decide_times`) at strides 1 and 16.  ``--compare`` runs each checkout in a process of its own,
in the order other, this, this, other, so a drift of the card over the
run shows as a difference between a checkout's two runs, and prints each
wide and batched time's bound (`wide_bounds`, `batched_bound`).
``--sweep`` times every plan the distance kernel takes
(`pairwise.candidates`) at those shapes and at ``[20, 7850]`` and
``[40, 7850]`` (the variants table's M = 20, uncompressed and with a
lossy codec), each checked against the plain version first, and marks
`pairwise.split_plan`'s choice; then every plan of the batched kernel
(`pairwise.batch_candidates`: the cluster body and, for elements of at
most 17 rows, the batch body) at the batched shapes and on edge-case
operands, each first checked bit for bit against the cluster body and
element by element against the unbatched kernel, with
`pairwise.batch_plan`'s choice marked.
``--sweep-gather`` times the gather tile kernel (rows 3 and 8) under
several plans (tiles, chunks, columns a lane), on the three gather tables,
each checked equal to the plain version first; beside each it gives the
launch's traffic between L2 and the SMs (every node's valid rows and its
own row read, the table, the output written) and that traffic's time at the
card's L2-resident read rate, measured first by summing the rows of a 16 MB
buffer that L2 holds, 8 times in one launch (a copy of it, which also
writes 16 MB, is timed beside).  ``--parent`` adds the parent checkout's
gather times, timed in a process of its own.
Output: one JSON line per run, and a table.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
D = 7850


def cuda_ms(fn, *, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def regular_adjacency(m: int, degree: int, seed: int) -> np.ndarray:
    """Every node with ``degree`` in-neighbors drawn from the others."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        adj[j, rng.choice([i for i in range(m) if i != j], size=degree, replace=False)] = True
    return adj


def random_adjacency(m: int, lo: int, hi: int, seed: int) -> np.ndarray:
    """Every node with ``lo`` to ``hi`` in-neighbors drawn at random: a
    table whose consecutive nodes share few rows."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for j in range(m):
        others = np.array([i for i in range(m) if i != j])
        adj[j, rng.choice(others, size=int(rng.integers(lo, hi + 1)), replace=False)] = True
    return adj


def gather_tables(dev) -> dict:
    """The gather screens' tables at M = 512: the sparse path's (K = 16),
    sparse BRIDGE-K / B's (K = 20) and one that shares few rows (K = 16)."""
    from repro_torch.core.graph import small_world
    from repro_torch.core.neighbors import NeighborTable

    return {"K=16": NeighborTable.from_adjacency(small_world(512, 6, 2, rewire_prob=0.2, seed=0),
                                                 device=dev),
            "K=20": NeighborTable.from_adjacency(small_world(512, 8, 2, rewire_prob=0.2, seed=0),
                                                 device=dev),
            "random K=16": NeighborTable.from_adjacency(random_adjacency(512, 8, 16, 4), k=16,
                                                        device=dev)}


def kernel_times(decide_only: bool = False) -> dict:
    """Times of every kernel entry of the checkout on ``sys.path`` (with
    ``decide_only``, the decide forms and the plain screens beside them)."""
    from repro_torch.comm import codec as codec_lib
    from repro_torch.core.graph import erdos_renyi
    from repro_torch.kernels import dequant, dequant_screen, gather_screen, median, pairwise
    from repro_torch.kernels import trimmed_mean

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    m, b = 50, 4
    w = torch.from_numpy(rng.normal(size=(m, D)).astype(np.float32) * 0.05).to(dev)
    msg = codec_lib.get_codec("int8").encode(np.array([0, 7], np.uint32), w)
    q, scale = msg.payload, msg.scale
    graphs = {"er": erdos_renyi(m, 0.5, b, seed=0).adjacency,
              "deg24": regular_adjacency(m, 24, 1), "deg31": regular_adjacency(m, 31, 2),
              "deg49": regular_adjacency(m, 49, 3)}
    times = {}
    if decide_only:
        graphs = {"er": graphs["er"]}
    for tag, adj_np in graphs.items():
        adj = torch.from_numpy(adj_np).to(dev)
        times[f"screen_trimmed_mean_dense {tag}"] = cuda_ms(
            lambda a=adj: trimmed_mean.trimmed_mean_dense(w, a, w, b))
        times[f"screen_median_dense {tag}"] = cuda_ms(lambda a=adj: median.median_dense(w, a, w))
        if tag == "er":
            times["dequant_screen_trimmed_mean_dense er"] = cuda_ms(
                lambda a=adj: dequant_screen.dequant_screen_trimmed_mean_dense(q, scale, a, w, b))
            times["dequant_screen_median_dense er"] = cuda_ms(
                lambda a=adj: dequant_screen.dequant_screen_median_dense(q, scale, a, w))

    sm = 512
    ws = torch.from_numpy(rng.normal(size=(sm, D)).astype(np.float32)).to(dev)
    smsg = codec_lib.get_codec("int8").encode(np.array([0, 8], np.uint32), ws * 0.05)
    sq, ss = smsg.payload, smsg.scale
    for tag, table in gather_tables(dev).items():
        if decide_only and tag != "K=16":
            continue
        idx, valid = table.safe_idx, table.valid_dev
        sfx = "" if tag == "K=16" else f" {tag}"
        times["gather_screen_trimmed_mean" + sfx] = cuda_ms(
            lambda i=idx, v=valid: gather_screen.gather_screen_trimmed_mean(ws, i, v, ws, 2))
        times["gather_screen_median" + sfx] = cuda_ms(
            lambda i=idx, v=valid: gather_screen.gather_screen_median(ws, i, v, ws))
        times["gather_dequant_screen_trimmed_mean" + sfx] = cuda_ms(
            lambda i=idx, v=valid: gather_screen.gather_dequant_screen_trimmed_mean(sq, ss, i, v,
                                                                                  ws, 2))
        times["gather_dequant_screen_median" + sfx] = cuda_ms(
            lambda i=idx, v=valid: gather_screen.gather_dequant_screen_median(sq, ss, i, v, ws))
    has_decide = importlib.util.find_spec("repro_torch.kernels.screen_decide") is not None
    if decide_only:
        return {**times, **(decide_times(dev, w, ws) if has_decide else {})}
    if importlib.util.find_spec("repro_torch.kernels.screen_wide") is not None:
        times.update(wide_times(dev, rng))
    times["dequant"] = cuda_ms(lambda: dequant.dequant(sq, ss))
    # the main path's decode: topk50_int8's kept values at dense M = 50
    kept = codec_lib.get_codec("int8").encode(np.array([0, 11], np.uint32),
                                                ws[:50, : D // 2].contiguous() * 0.05)
    times["dequant [50, 3925]"] = cuda_ms(lambda: dequant.dequant(kept.payload, kept.scale))
    times["dequant_carry"] = cuda_ms(lambda: dequant.dequant_carry(sq, ss, ws, ws))

    for n in (50, 100, 512):
        x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32) * 0.05).to(dev)
        times[f"pairwise_sq_dists [{n}, {D}]"] = cuda_ms(lambda x=x: pairwise.pairwise_sq_dists(x))
    times.update(batched_times(dev))
    if has_decide:
        times.update(decide_times(dev, w, ws))
    return times


def decide_times(dev, w: torch.Tensor, ws: torch.Tensor) -> dict:
    """The screens' decide form (`screen_decide`) at strides 1 and 16: dense
    M = 50 on ``erdos_renyi(50, 0.5, 4)``, gather and views at M = 512,
    K = 16 (the views: each node's gathered rows), dense views M = W = 50."""
    from repro_torch.core.graph import erdos_renyi
    from repro_torch.kernels import ref, screen_decide

    adj = torch.from_numpy(erdos_renyi(50, 0.5, 4, seed=0).adjacency).to(dev)
    table = gather_tables(dev)["K=16"]
    idx, valid = table.safe_idx, table.valid_dev
    views_s = ref.gather(ws, idx).contiguous()
    views_d = w[None].expand(50, 50, D).contiguous()
    times = {}
    for s in (1, 16):
        times[f"screen_trimmed_mean_dense_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.trimmed_mean_dense_decide(w, adj, w, 4, s))
        times[f"screen_median_dense_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.median_dense_decide(w, adj, w, s))
        times[f"gather_screen_trimmed_mean_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.gather_screen_trimmed_mean_decide(ws, idx, valid, ws, 2, s))
        times[f"gather_screen_median_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.gather_screen_median_decide(ws, idx, valid, ws, s))
        times[f"views_screen_trimmed_mean_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.views_screen_trimmed_mean_decide(views_s, valid, ws, 2, s))
        times[f"views_screen_median_decide s{s}"] = cuda_ms(
            lambda s=s: screen_decide.views_screen_median_decide(views_s, valid, ws, s))
        times[f"views_screen_trimmed_mean_decide dense s{s}"] = cuda_ms(
            lambda s=s: screen_decide.views_screen_trimmed_mean_decide(views_d, adj, w, 4, s))
    return times


def batched_shapes(dev) -> dict:
    """The batched distance kernel's main-path operands, seeded: each node's
    mailbox views and its own value at sparse M = 512, K = 16 (n = 17), at
    the net phase's M = 20 (W = 20, n = 21) and at dense M = W = 50
    (n = 51), the last also as one broadcast expanded over the receivers
    (a batch stride of 0); and a K / B grid group's ``[E, M, d]`` rows
    (E = 8, M = 50, no self row).  ``{tag: (x, self_vals or None)}``."""
    rng = np.random.default_rng(20)
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32) * 0.05).to(dev)
    return {"sparse B=512 n=17": (mk(512, 16, D), mk(512, D)),
            "M=20 B=20 n=21": (mk(20, 20, D), mk(20, D)),
            "dense B=50 n=51": (mk(50, 50, D), mk(50, D)),
            "dense stride 0 B=50 n=51": (mk(1, 50, D).expand(50, 50, D), mk(50, D)),
            "grid E=8 n=50": (mk(8, 50, D), None)}


def batched_cost(x: torch.Tensor, self_vals) -> tuple[int, int]:
    """Bytes (the distinct rows once, the self rows, the output) and fp32
    operations (each element's n (n + 1) / 2 dot products of d FMAs) of a
    batched call, as `chip_smoke.py` counts them."""
    bsz, nx, d = x.shape
    n = nx + (self_vals is not None)
    rows = nx * d if x.stride(0) == 0 else bsz * nx * d
    return (rows + (0 if self_vals is None else bsz * d) + bsz * n * n) * 4, bsz * n * (n + 1) * d


def batched_bound(x: torch.Tensor, self_vals) -> tuple[float, str]:
    nbytes, ops = batched_cost(x, self_vals)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bmm_dists(x: torch.Tensor) -> torch.Tensor:
    """The library yardstick: ``torch.bmm(x, x.mT)`` with the kernel's
    epilogue, over the stacked ``[B, n, d]`` rows (TF32 off)."""
    g = torch.bmm(x, x.mT)
    sq = torch.diagonal(g, dim1=1, dim2=2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * g
    return torch.where(d2 < 0, 0.0, d2)


def stacked(x: torch.Tensor, self_vals) -> torch.Tensor:
    return x.contiguous() if self_vals is None else torch.cat([x, self_vals[:, None]], dim=1)


def batched_times(dev) -> dict:
    """The batched distance kernel at `batched_shapes` under the checkout's
    own choice of body, ``torch.bmm`` with the same epilogue beside each
    and, where the checkout has the batch body, its cluster body forced."""
    from repro_torch.kernels import pairwise

    times = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag, (x, s) in batched_shapes(dev).items():
        times[f"pairwise_sq_dists_batched {tag}"] = cuda_ms(
            lambda x=x, s=s: pairwise.pairwise_sq_dists_batched(x, s))
        if hasattr(pairwise, "batch_plan"):
            plan = pairwise.BatchPlan(pairwise.split_plan(x.shape[1] + (s is not None), D))
            times[f"pairwise_sq_dists_batched {tag} cluster body"] = cuda_ms(
                lambda x=x, s=s, p=plan: pairwise.pairwise_sq_dists_batched(x, s, p))
        st = stacked(x, s)
        times[f"library bmm {tag}"] = cuda_ms(lambda st=st: bmm_dists(st), reps=11, inner=2)
    return times


def wide_shapes() -> dict:
    """The wide path's shapes, by the key prefix of their times: the dense
    screens at M = 129 and 513 on ``erdos_renyi(M, 0.5, 4)`` and the gather
    screens at K = 64 and 200 on tables of K/2 to K random senders a node
    (M = 512): ``(adjacency, K or None)``."""
    from repro_torch.core.graph import erdos_renyi

    shapes = {f"dense M={m}": (erdos_renyi(m, 0.5, 4, seed=0).adjacency, None) for m in (129, 513)}
    shapes.update({f"gather K={k}": (random_adjacency(512, k // 2, k, k), k) for k in (64, 200)})
    return shapes


def wide_times(dev, rng) -> dict:
    """The wide path at `wide_shapes`, float and codeword rows, trimmed mean
    (b = 4 dense, 2 gather) and median; the register kernels at dense
    M = 128 on ``erdos_renyi(128, 0.5, 4)``, the largest M they take (the
    median there sorts M + 1 = 129 rows, so it runs the wide path); and
    the medians' library call, ``torch.nanquantile(q=0.5)`` over the masked
    ``[M, M+1, d]`` rows at M = 129 and the gathered ``[M, K+1, d]`` rows at
    K = 64 (NaN for absent rows)."""
    from repro_torch.comm import codec as codec_lib
    from repro_torch.core.graph import erdos_renyi
    from repro_torch.core.neighbors import NeighborTable
    from repro_torch.kernels import dequant_screen, gather_screen, median, trimmed_mean

    times = {}
    w = torch.from_numpy(rng.normal(size=(128, D)).astype(np.float32) * 0.05).to(dev)
    adj = torch.from_numpy(erdos_renyi(128, 0.5, 4, seed=0).adjacency).to(dev)
    times["screen_trimmed_mean_dense M=128"] = cuda_ms(
        lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, 4), reps=11)
    times["screen_median_dense M=128"] = cuda_ms(lambda: median.median_dense(w, adj, w), reps=11)
    for tag, (adj_np, k) in wide_shapes().items():
        m = adj_np.shape[0]
        w = torch.from_numpy(rng.normal(size=(m, D)).astype(np.float32) * 0.05).to(dev)
        msg = codec_lib.get_codec("int8").encode(np.array([0, 9], np.uint32), w)
        q, sc = msg.payload, msg.scale
        if k is None:
            adj = torch.from_numpy(adj_np).to(dev)
            runs = {"trimmed_mean": lambda: trimmed_mean.trimmed_mean_dense(w, adj, w, 4),
                    "median": lambda: median.median_dense(w, adj, w),
                    "codeword trimmed_mean":
                        lambda: dequant_screen.dequant_screen_trimmed_mean_dense(q, sc, adj, w, 4),
                    "codeword median": lambda: dequant_screen.dequant_screen_median_dense(q, sc, adj, w)}
            rows = torch.where(adj[:, :, None], w[None], torch.nan)
        else:
            table = NeighborTable.from_adjacency(adj_np, k=k, device=dev)
            idx, valid = table.safe_idx, table.valid_dev
            runs = {"trimmed_mean": lambda: gather_screen.gather_screen_trimmed_mean(w, idx, valid, w, 2),
                    "median": lambda: gather_screen.gather_screen_median(w, idx, valid, w),
                    "codeword trimmed_mean": lambda: gather_screen.gather_dequant_screen_trimmed_mean(
                        q, sc, idx, valid, w, 2),
                    "codeword median": lambda: gather_screen.gather_dequant_screen_median(
                        q, sc, idx, valid, w)}
            rows = torch.where(valid[:, :, None], table.gather_rows(w), torch.nan)
        for rule, run in runs.items():
            times[f"screen_wide {tag} {rule}"] = cuda_ms(run, reps=11)
        if tag in ("dense M=129", "gather K=64"):
            rows = torch.cat([rows, w[:, None, :]], dim=1)
            times[f"library nanquantile {tag}"] = cuda_ms(
                lambda r=rows: torch.nanquantile(r, 0.5, dim=1), reps=11, inner=2)
        del rows
    return times


def wide_bounds() -> dict:
    """The least time the card could take for each wide time of
    `wide_times`, as `chip_smoke.py` counts it: the larger of the bytes
    (each input once, the output once) at 3.35 TB/s and the fp32
    operations at 67 TFLOP/s — Batcher's network over each node's true row
    count (two a compare-exchange), the kept ranks' adds and the finish,
    and for codeword rows one FMA (two operations) a decoded value.
    Returns ``{key: (ms, "bytes" | "operations")}``."""
    from repro_torch.kernels import networks

    out = {}
    pairs = lambda n: len(networks.batcher_pairs(n))  # noqa: E731
    for tag, (adj_np, k) in wide_shapes().items():
        m = adj_np.shape[0]
        counts = adj_np.sum(axis=1)
        b = 4 if k is None else 2
        b_eff = np.minimum(b, np.maximum((counts - 1) // 2, 0))
        tm_ops = D * sum(2 * pairs(int(c)) + int(c) - 2 * int(e) + 2
                         for c, e in zip(counts, b_eff, strict=True))
        md_ops = D * sum(2 * pairs(int(c) + 1) + 2 for c in counts)
        decode_ops = 2 * D * int(counts.sum())
        listing = m * m if k is None else m * k * 5  # the mask, or the table
        float_bytes = 2 * m * D * 4 + listing  # w (also self) in, out
        code_bytes = m * D * (1 + 4 + 4) + m * (-(-D // 128)) * 8 + listing
        for rule, nbytes, ops in (("trimmed_mean", float_bytes, tm_ops), ("median", float_bytes, md_ops),
                                  ("codeword trimmed_mean", code_bytes, tm_ops + decode_ops),
                                  ("codeword median", code_bytes, md_ops + decode_ops)):
            t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 67e12 * 1e3
            out[f"screen_wide {tag} {rule}"] = (max(t_bytes, t_ops),
                                                "bytes" if t_bytes >= t_ops else "operations")
    return out


def l2_rate() -> dict:
    """The card's L2-resident rates over a 16 MB buffer, which the 50 MB L2
    holds across the repetitions: reading it (one launch sums each of its
    1024 rows of 16 KB 8 times, so that the gaps between launches weigh
    little; the gather kernels too read far more than they write) and
    copying it into another (16 MB read and 16 MB written)."""
    src = torch.randn(4 * 2**20, device="cuda")
    dst = torch.empty_like(src)
    reads = 8
    rows = src.view(1, 1024, -1).expand(reads, -1, -1)
    sums = torch.empty(reads, 1024, device="cuda")
    nbytes = src.numel() * 4
    read_ms = cuda_ms(lambda: torch.sum(rows, dim=2, out=sums), reps=51)
    copy_ms = cuda_ms(lambda: dst.copy_(src), reps=51)
    return {"read_ms": read_ms, "read_tb_per_s": reads * nbytes / read_ms / 1e9,
            "copy_ms": copy_ms, "copy_moved_tb_per_s": 2 * nbytes / copy_ms / 1e9}


def l2_traffic(table, d: int, row_bytes: int) -> int:
    """Bytes one launch moves between L2 and the SMs: every node reads its
    valid slots' rows (a codeword row also its scale pairs) and its own
    row, the table once, and writes its output row."""
    valid = table.valid
    m = valid.shape[0]
    code_extra = (-(-d // 128)) * 8 if row_bytes == 1 else 0  # scale pairs a row
    return int(valid.sum()) * (d * row_bytes + code_extra) + 2 * m * d * 4 + valid.size * 5


def sweep_gather(parent: str | None) -> dict:
    """The tile kernel under several plans on the three gather tables, rows
    3 (float) and 8 (codewords), each checked equal to the plain version
    and timed; the L2 yardstick first."""
    from repro_torch.comm import codec as codec_lib
    from repro_torch.kernels import gather_screen as gs
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rate = l2_rate()
    rng = np.random.default_rng(5)
    ws = torch.from_numpy(rng.normal(size=(512, D)).astype(np.float32)).to(dev)
    msg = codec_lib.get_codec("int8").encode(np.array([0, 10], np.uint32), ws * 0.05)
    q, sc = msg.payload, msg.scale
    shapes = ((4, 128, 1), (4, 128, 2), (4, 64, 1), (8, 128, 1), (8, 64, 1), (8, 64, 2),
              (16, 128, 1), (16, 64, 1), (16, 32, 1))  # (tile, chunk, columns a lane)
    rows = []
    for tag, table in gather_tables(dev).items():
        if decide_only and tag != "K=16":
            continue
        idx, valid = table.safe_idx, table.valid_dev
        k = table.k
        for rule in ("trimmed_mean", "median"):
            median = rule == "median"
            b = () if median else (2,)
            for row_bytes in (4, 1):
                src = (ws,) if row_bytes == 4 else (q, sc)
                name = ("gather_screen_" if row_bytes == 4 else "gather_dequant_screen_") + rule
                want = getattr(ref, ("gather_" if row_bytes == 4 else "gather_dequant_") + rule)(
                    *src, idx, valid, ws, *b)
                chosen = gs.tile_plan(512, k, D, row_bytes, median)
                traffic = l2_traffic(table, D, row_bytes)
                for t, c, cols in shapes:
                    plan = gs.plan_for(t, c, 512, k, D, row_bytes, median, cols)
                    if plan is None:
                        continue
                    run = lambda p=plan: gs.launch_tile(name, p, src, idx, valid, ws, *b)
                    got = run()
                    torch.cuda.synchronize()
                    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
                    if not bool(same.all()):
                        raise AssertionError(f"gather {rule} {tag} plan {plan}: wrong result")
                    rows.append({"table": tag, "rule": rule,
                                 "rows": "float" if row_bytes == 4 else "code", **plan.__dict__,
                                 "ms": cuda_ms(run, reps=11), "l2_bytes": traffic,
                                 "l2_read_ms": traffic / rate["read_tb_per_s"] / 1e9,
                                 "chosen": plan == chosen})
    out = {"l2": rate, "sweep": rows}
    if parent:
        out["parent"] = {key: ms for key, ms in run_other(parent)["times"].items()
                         if key.startswith("gather")}
    return out


def sweep() -> list[dict]:
    """Every plan of the distance kernel at the main path's shapes, checked
    against the plain version (symmetric, zero diagonal, within the float32
    dot-product bound), then timed."""
    from repro_torch.kernels import pairwise, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows = []
    for n in (20, 40, 50, 100, 512):
        x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32) * 0.05).to(dev)
        want = ref.pairwise_sq_dists(x).double()
        sq = (x.double() ** 2).sum(dim=1)
        bound = 4.0 * D * 2.0 ** -24 * (sq[:, None] + sq[None, :])
        chosen = pairwise.split_plan(n, D)
        for plan in pairwise.candidates(n, D):
            got = pairwise.pairwise_sq_dists(x, plan)
            torch.cuda.synchronize()
            ok = (torch.equal(got, got.T) and bool((torch.diagonal(got) == 0).all())
                  and bool(((got.double() - want).abs() <= bound).all()))
            if not ok:
                raise AssertionError(f"pairwise [{n}, {D}] plan {plan}: wrong result")
            ms = cuda_ms(lambda p=plan, x=x: pairwise.pairwise_sq_dists(x, p), reps=11)
            rows.append({"n": n, "d": D, **plan.__dict__, "ms": ms, "chosen": plan == chosen,
                         "model_us": pairwise.cost(plan, n)})
    return rows


def batch_edge_inputs(dev) -> dict:
    """Operands on which a slip in the order or the staging shows: NaN,
    +-inf and 1e30 rows, a self row with a NaN, a batch stride of 0 over
    200 elements, d = 777 (a split's zero-filled tail), and rows of +-1e-25,
    whose products underflow to signed zeros and subnormals."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    out = {}
    for d in (777, D):
        views = torch.randn((64, 16, d), generator=gen, device=dev)
        views[1, 1] = float("nan")
        views[2, 0, 3], views[3, 2, 0] = float("inf"), -float("inf")
        views[4, 3] = 1e30
        self_vals = torch.randn((64, d), generator=gen, device=dev)
        self_vals[5, 7] = float("nan")
        out[f"edge rows d={d}"] = (views, self_vals)
    signs = torch.randint(0, 2, (96, 40, D), generator=gen, device=dev) * 2.0 - 1.0
    out["underflow n=40"] = (signs * 1e-25, None)
    out["stride 0 n=33"] = (torch.randn((1, 32, D), generator=gen, device=dev).expand(200, 32, D),
                            torch.randn((200, D), generator=gen, device=dev))
    return out


def sweep_batched(dev) -> tuple[list[dict], list[str]]:
    """Every plan of the batched kernel (`pairwise.batch_candidates`) at
    `batched_shapes` and on `batch_edge_inputs`: each checked bit for bit
    against the cluster body and, element by element, against the
    unbatched kernel of its rows, then timed, with `batch_plan`'s choice
    marked.  Returns the rows and the failures (a plan that differs is
    reported, not timed)."""
    from repro_torch.kernels import pairwise

    rows, failures = [], []
    cases = {**batched_shapes(dev), **batch_edge_inputs(dev)}
    for tag, (x, s) in cases.items():
        bsz, nx, d = x.shape
        n = nx + (s is not None)
        order = pairwise.split_plan(n, d)
        want = pairwise.pairwise_sq_dists_batched(x, s, pairwise.BatchPlan(order))
        st = stacked(x, s)
        for e in range(bsz):
            if not torch.equal(want[e].view(torch.int32),
                               pairwise.pairwise_sq_dists(st[e].contiguous()).view(torch.int32)):
                failures.append(f"{tag}: cluster body element {e} != the unbatched kernel")
                break
        chosen = pairwise.batch_plan(bsz, n, d)
        bound, bound_by = batched_bound(x, s)
        for plan in pairwise.batch_candidates(bsz, n, d):
            got = pairwise.pairwise_sq_dists_batched(x, s, plan)
            torch.cuda.synchronize()
            same = got.view(torch.int32) == want.view(torch.int32)
            if not bool(same.all()):
                bad = int((~same).sum())
                failures.append(f"{tag}: the {plan.body} body differs from the cluster body on "
                                f"{bad} entries")
                continue
            row = {"shape": tag, "B": bsz, "n": n, "d": d, "body": plan.body,
                   "chosen": plan == chosen,
                   "model_us": pairwise.batch_cost(plan, bsz, n, d),
                   "bound_ms": bound, "bound_by": bound_by}
            row["ms"] = cuda_ms(
                lambda p=plan, x=x, s=s: pairwise.pairwise_sq_dists_batched(x, s, p), reps=11)
            rows.append(row)
    return rows, failures


def run_other(src: str, extra: tuple = ()) -> dict:
    """This script in a process of its own on the checkout ``src``."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--src", src, *extra],
                          capture_output=True, text=True, check=False, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_times on {src} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=SRC, help="the src/ directory whose repro_torch to time")
    parser.add_argument("--compare", metavar="SRC", help="time SRC, this, this, SRC")
    parser.add_argument("--sweep", action="store_true", help="time every pairwise plan")
    parser.add_argument("--sweep-gather", action="store_true",
                        help="time the gather tile kernel's plans beside their L2 traffic")
    parser.add_argument("--parent", metavar="SRC", help="with --sweep-gather: SRC's gather times")
    parser.add_argument("--decide", action="store_true",
                        help="time the decide forms and the plain screens beside them only")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    if args.compare:
        runs = [("other", args.compare), ("this", SRC), ("this", SRC), ("other", args.compare)]
        results = [run_other(src, ("--decide",) if args.decide else ()) for _, src in runs]
        print(f"card: {card}; columns: other, this, this, other (ms)")
        sys.path.insert(0, SRC)
        bounds = wide_bounds()
        for tag, (x, s) in batched_shapes(torch.device("cuda")).items():
            bounds[f"pairwise_sq_dists_batched {tag}"] = batched_bound(x, s)
        for key in results[1]["times"]:
            cells = [r["times"].get(key) for r in results]
            bound = f"  bound {bounds[key][0]:.5f} ({bounds[key][1]})" if key in bounds else ""
            print(f"{key:48s} " + " ".join("       -" if c is None else f"{c:8.4f}" for c in cells)
                  + bound)
        print(json.dumps({"card": card, "bounds": bounds,
                          "runs": [dict(tag=t, src=s, times=r["times"])
                                   for (t, s), r in zip(runs, results)]}))
        return 0
    sys.path.insert(0, args.src)
    if args.sweep:
        rows = sweep()
        batch_rows, failures = sweep_batched(torch.device("cuda"))
        print(f"card: {card}")
        for r in rows:
            print(f"[{r['n']}, {r['d']}] R={r['rows_per_thread']} C={r['cluster']} "
                  f"L={r['split_len']}: {r['ms']:.4f} ms (model {r['model_us']:.1f} us)"
                  f"{'  <- split_plan' if r['chosen'] else ''}")
        for r in batch_rows:
            ms = f"{r['ms']:.4f} ms"
            print(f"batched {r['shape']} [{r['B']}, {r['n']}, {r['d']}] {r['body']} body: {ms} "
                  f"(model "
                  f"{r['model_us']:.1f} us, bound {r['bound_ms']:.5f} ms {r['bound_by']})"
                  f"{'  <- batch_plan' if r['chosen'] else ''}")
        for f in failures:
            print("FAILED:", f)
        print(json.dumps({"card": card, "sweep": rows, "batched": batch_rows,
                          "failures": failures}))
        return 1 if failures else 0
    if args.sweep_gather:
        res = sweep_gather(args.parent)
        l2 = res["l2"]
        print(f"card: {card}; L2-resident 16 MB: read 8 times (row sums) {l2['read_ms']:.4f} ms, "
              f"{l2['read_tb_per_s']:.2f} TB/s; copy {l2['copy_ms']:.4f} ms, "
              f"{l2['copy_moved_tb_per_s']:.2f} TB/s moved")
        for r in res["sweep"]:
            print(f"{r['table']:12s} {r['rule']:12s} {r['rows']:5s} T={r['tile']:2d} "
                  f"C={r['chunk']:3d} seg={r['segments']:3d} cols={r['cols']}: "
                  f"{r['ms']:.4f} ms, L2 {r['l2_bytes'] / 1e6:.1f} MB, "
                  f"{r['l2_read_ms']:.4f} ms at the read rate"
                  f"{'  <- tile_plan' if r['chosen'] else ''}")
        for key, ms in res.get("parent", {}).items():
            print(f"parent {key}: {ms:.4f} ms")
        print(json.dumps({"card": card, **res}))
        return 0
    print(json.dumps({"card": card, "src": args.src, "times": kernel_times(args.decide)}))
    return 0


if __name__ == "__main__":
    # run as a script: its own directory must not shadow top-level modules
    sys.path[:] = [p for p in sys.path if os.path.abspath(p) != os.path.dirname(os.path.abspath(__file__))]
    sys.exit(main())
