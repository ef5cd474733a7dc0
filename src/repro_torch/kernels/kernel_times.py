"""Device times of the screening, decode and distance kernels at the main
path's shapes, on one CUDA card; a script, not part of the package's API.

    python src/repro_torch/kernels/kernel_times.py                     # this checkout
    python src/repro_torch/kernels/kernel_times.py --src OTHER/src     # another checkout's kernels
    python src/repro_torch/kernels/kernel_times.py --compare OTHER/src # OTHER, this, this, OTHER
    python src/repro_torch/kernels/kernel_times.py --sweep             # every pairwise plan

Each time is the median over 25 repetitions of the mean device time of 10
calls (CUDA events, the stream parked first so the events time the device),
as `chip_smoke.py` times. The inputs are seeded with numpy, so two
checkouts time the same data: the dense screens at M = 50, d = 7850 on
``erdos_renyi(50, 0.5, 4)`` (float rows and the int8 codec's codewords),
on two single-bucket graphs of the same M (every in-degree 24, every
in-degree 31) and on all 49 senders; the gather screens and the decodes at
M = 512, d = 7850 on ``small_world(512, 6, 2)``; the distances at
``[50, 7850]``, ``[100, 7850]`` and ``[512, 7850]``.  ``--compare`` runs
each checkout in a process of its own, in the order other, this, this,
other, so a drift of the card over the run shows as a difference between
a checkout's two runs.  ``--sweep`` times every plan the distance kernel
takes (`pairwise.candidates`) at those shapes and at ``[20, 7850]`` and
``[40, 7850]`` (the variants table's M = 20, uncompressed and with a lossy
codec), each checked against the plain version first, and marks
`pairwise.split_plan`'s choice.  Output: one JSON line per run, and a
table.
"""
from __future__ import annotations

import argparse
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


def kernel_times() -> dict:
    """Times of every kernel entry of the checkout on ``sys.path``."""
    from repro_torch.comm import codec as codec_lib
    from repro_torch.core.graph import erdos_renyi, small_world
    from repro_torch.core.neighbors import NeighborTable
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
    table = NeighborTable.from_adjacency(small_world(sm, 6, 2, rewire_prob=0.2, seed=0), device=dev)
    ws = torch.from_numpy(rng.normal(size=(sm, D)).astype(np.float32)).to(dev)
    smsg = codec_lib.get_codec("int8").encode(np.array([0, 8], np.uint32), ws * 0.05)
    sq, ss = smsg.payload, smsg.scale
    idx, valid = table.safe_idx, table.valid_dev
    times["gather_screen_trimmed_mean"] = cuda_ms(
        lambda: gather_screen.gather_screen_trimmed_mean(ws, idx, valid, ws, 2))
    times["gather_screen_median"] = cuda_ms(lambda: gather_screen.gather_screen_median(ws, idx, valid, ws))
    times["gather_dequant_screen_trimmed_mean"] = cuda_ms(
        lambda: gather_screen.gather_dequant_screen_trimmed_mean(sq, ss, idx, valid, ws, 2))
    times["gather_dequant_screen_median"] = cuda_ms(
        lambda: gather_screen.gather_dequant_screen_median(sq, ss, idx, valid, ws))
    times["dequant"] = cuda_ms(lambda: dequant.dequant(sq, ss))
    times["dequant_carry"] = cuda_ms(lambda: dequant.dequant_carry(sq, ss, ws, ws))

    for n in (50, 100, 512):
        x = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32) * 0.05).to(dev)
        times[f"pairwise_sq_dists [{n}, {D}]"] = cuda_ms(lambda x=x: pairwise.pairwise_sq_dists(x))
    return times


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


def run_other(src: str) -> dict:
    """This script in a process of its own on the checkout ``src``."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--src", src],
                          capture_output=True, text=True, check=False, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel_times on {src} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=SRC, help="the src/ directory whose repro_torch to time")
    parser.add_argument("--compare", metavar="SRC", help="time SRC, this, this, SRC")
    parser.add_argument("--sweep", action="store_true", help="time every pairwise plan")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    if args.compare:
        runs = [("other", args.compare), ("this", SRC), ("this", SRC), ("other", args.compare)]
        results = [run_other(src) for _, src in runs]
        print(f"card: {card}; columns: other, this, this, other (ms)")
        for key in results[1]["times"]:
            cells = [r["times"].get(key) for r in results]
            print(f"{key:48s} " + " ".join("       -" if c is None else f"{c:8.4f}" for c in cells))
        print(json.dumps({"card": card, "runs": [dict(tag=t, src=s, times=r["times"])
                                                  for (t, s), r in zip(runs, results)]}))
        return 0
    sys.path.insert(0, args.src)
    if args.sweep:
        rows = sweep()
        print(f"card: {card}")
        for r in rows:
            print(f"[{r['n']}, {r['d']}] R={r['rows_per_thread']} C={r['cluster']} "
                  f"L={r['split_len']}: {r['ms']:.4f} ms (model {r['model_us']:.1f} us)"
                  f"{'  <- split_plan' if r['chosen'] else ''}")
        print(json.dumps({"card": card, "sweep": rows}))
        return 0
    print(json.dumps({"card": card, "src": args.src, "times": kernel_times()}))
    return 0


if __name__ == "__main__":
    # run as a script: its own directory must not shadow top-level modules
    sys.path[:] = [p for p in sys.path if os.path.abspath(p) != os.path.dirname(os.path.abspath(__file__))]
    sys.exit(main())
