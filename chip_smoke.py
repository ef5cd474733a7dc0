"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` next to this
file; exits non-zero (and prints no result line) without them.  Phases, any
failure of which raises:

1. setup — the card's name and power limit; build the screening kernels
   from ``src/repro_torch/kernels/csrc`` and show ptxas' register/spill lines;
2. kernels — each kernel against its plain PyTorch version on the card:
   exact (NaN-aware ``==``) at the main path's shape (M = 50, d = 7850, the
   full width of the linear model) and on edge-case payloads (NaN, +-inf,
   1e30, ties, +-0, starved rows); within the float32 summation bound at
   M = 100, where the plain version sums with a reduction tree.  Times the
   kernel, the plain version and, for the median, ``torch.nanquantile``
   (a yardstick the port never calls) with CUDA events;
3. trainer — the main path: `BridgeTrainer` on the MNIST-like linear task,
   M = 50, b = 4, random attack, 200 ticks, for DGD (mean), BRIDGE-T and
   BRIDGE-M; launch counts are zeroed before and read after, and BRIDGE-T /
   BRIDGE-M must reach 0.95 honest test accuracy while DGD stays <= 0.5;
4. parity — 5 sign-flip ticks from one init on the card and on the CPU agree
   at rtol 1e-4, atol 1e-5.

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch  # noqa: E402

from repro_torch.core.bridge import BridgeConfig, BridgeTrainer  # noqa: E402
from repro_torch.core.graph import erdos_renyi  # noqa: E402
from repro_torch.kernels import build, median, ref, trimmed_mean  # noqa: E402
from repro_torch.sim.tasks import linear_task  # noqa: E402

M, B, D = 50, 4, 7850
TICKS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
EPS32 = float(np.finfo(np.float32).eps)


def batcher_pairs(n: int) -> int:
    """Compare-exchanges of Batcher's odd-even merge network on n rows (the
    reference's ``screening._batcher_pairs`` schedule)."""
    count, p = 0, 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        count += 1
            k //= 2
        p *= 2
    return count


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def edge_case_inputs(m: int, d: int, seed: int):
    """w [m, d] with NaN, +-inf, 1e30, ties and +-0 payloads, and an
    adjacency whose first rows are starved (0, 1 and 2 in-neighbors)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, d)).astype(np.float32)
    w[:, : d // 8] = np.round(w[:, : d // 8])  # ties
    for frac, val in ((0.04, np.nan), (0.03, np.inf), (0.03, -np.inf), (0.05, 1e30),
                      (0.03, -1e30), (0.04, -0.0), (0.04, 0.0)):
        w[rng.random((m, d)) < frac] = val
    adj = rng.random((m, m)) < 0.5
    for j, deg in enumerate((0, 1, 2)):
        adj[j] = False
        adj[j, rng.choice([i for i in range(m) if i != j], size=deg, replace=False)] = True
    np.fill_diagonal(adj, False)
    self_vals = rng.normal(size=(m, d)).astype(np.float32)
    self_vals[rng.random((m, d)) < 0.05] = np.nan
    return w, adj, self_vals


def cuda_ms(fn, *, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` calls.
    Each rep first parks the stream in a ~1 ms spin, so the host has
    enqueued all ``inner`` calls before the first one runs and the events
    time the device, not the launch path."""
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


def check_kernel_vs_plain(name, kernel, plain, w, adj, self_vals, *, exact: bool):
    out_k = kernel(w, adj, self_vals)
    out_p = plain(w, adj, self_vals)
    torch.cuda.synchronize()
    same = nan_equal(out_k, out_p)
    if exact:
        if not bool(same.all()):
            raise AssertionError(f"{name}: kernel != plain on {int((~same).sum())} entries "
                                 f"(M={w.shape[0]})")
        return
    # summation-order tolerance: |sequential - tree| <= 2 n eps (count + 1) max|x| / den
    n = w.shape[0]
    finite = torch.where(torch.isfinite(w), w.abs(), 0.0)
    colmax = torch.maximum(finite.max(dim=0).values[None, :],
                           torch.where(torch.isfinite(self_vals), self_vals.abs(), 0.0))
    count = adj.sum(dim=1).to(torch.float32)[:, None]
    tol = 2.0 * n * EPS32 * colmax * (count + 1.0)
    both_finite = torch.isfinite(out_k) & torch.isfinite(out_p)
    ok = torch.where(both_finite, (out_k - out_p).abs() <= tol, same)
    if not bool(ok.all()):
        raise AssertionError(f"{name}: kernel vs plain beyond the summation bound on "
                             f"{int((~ok).sum())} entries (M={n})")


def kernel_phase(dev):
    topo = erdos_renyi(M, 0.5, B, seed=0)
    adj = torch.as_tensor(topo.adjacency, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    w = torch.randn((M, D), generator=gen, device=dev)
    tm_kernel = lambda w_, a_, s_: trimmed_mean.trimmed_mean_dense(w_, a_, s_, B)
    tm_plain = lambda w_, a_, s_: ref.trimmed_mean_dense(w_, a_, s_, B)
    cases = {
        "trimmed_mean": (tm_kernel, tm_plain),
        "median": (median.median_dense, ref.median_dense),
    }
    # correctness: main shape, edge payloads at n <= 64 (exact), n = 100 (bound)
    for name, (kern, plain) in cases.items():
        check_kernel_vs_plain(name, kern, plain, w, adj, w, exact=True)
        for m, d, seed, exact in ((M, D, 1, True), (20, 1000, 2, True), (64, 999, 3, True),
                                  (5, 130, 4, True), (100, 2000, 5, name == "median")):
            ew, eadj, eself = (torch.as_tensor(x, device=dev) for x in edge_case_inputs(m, d, seed))
            check_kernel_vs_plain(name, kern, plain, ew, eadj, eself, exact=exact)
            check_kernel_vs_plain(name, kern, plain, ew, eadj, ew, exact=exact)
    print("kernels: equal to their plain versions (exact at M <= 64, summation bound at M = 100)")

    counts = topo.adjacency.sum(axis=1)
    b_eff = np.minimum(B, np.maximum((counts - 1) // 2, 0))
    tm_ops = D * sum(2 * batcher_pairs(int(c)) + int(c) - 2 * int(e) + 2
                     for c, e in zip(counts, b_eff, strict=True))
    med_ops = D * sum(2 * batcher_pairs(int(c) + 1) + 2 for c in counts)
    # bytes: w (also self) read once, the mask read once, the output written once
    nbytes = 2 * M * D * 4 + M * M

    rows = torch.cat([torch.where(adj[:, :, None], w[None], torch.nan), w[:, None, :]], dim=1)
    records = []
    for name, (kern, plain), ops, replaces, lib_fn in (
        ("screen_trimmed_mean_dense", cases["trimmed_mean"], tm_ops,
         "src/repro/kernels/trimmed_mean.py:109", None),
        ("screen_median_dense", cases["median"], med_ops, "src/repro/kernels/median.py:87",
         lambda: torch.nanquantile(rows, 0.5, dim=1)),
    ):
        out_k, out_p = kern(w, adj, w), plain(w, adj, w)
        max_err = float((out_k - out_p).abs().max())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        rec = {
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/screen.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": max_err,
            "ms": cuda_ms(lambda k=kern: k(w, adj, w)),
            "plain_ms": cuda_ms(lambda p=plain: p(w, adj, w), reps=21, inner=2),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib_fn is None else cuda_ms(lib_fn, reps=21, inner=2),
        }
        records.append(rec)
        print(f"kernel {name}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"library {rec['library_ms']}, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}: "
              f"{nbytes} bytes, {ops} fp32 ops)")
    print("library: the trimmed mean has no single PyTorch call; the median's is "
          "torch.nanquantile(q=0.5) over the masked [M, M+1, d] rows (NaN for absent rows)")
    return records


def trainer_phase(dev):
    """The main path; returns the kernel launches it made per rule."""
    task = linear_task(M, partition="iid", num_train=6000, num_test=1000, batch=32, device=dev)
    topo = erdos_renyi(M, 0.5, B, seed=0)
    rules = ("mean", "trimmed_mean", "median")
    cfgs = {rule: BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack="random", t0=30)
            for rule in rules}
    for rule in rules:  # warm-up: first use of each library call, outside the timed run
        warm = BridgeTrainer(cfgs[rule], task.grad_fn, device=dev)
        warm.step(warm.init(task.init_fn(0)), task.batch_fn(0))
    kernels = {"trimmed_mean": trimmed_mean.trimmed_mean_dense, "median": median.median_dense}
    for fn in kernels.values():
        fn.launches = 0
    results = {}
    for rule in rules:
        trainer = BridgeTrainer(cfgs[rule], task.grad_fn, device=dev)
        state = trainer.init(task.init_fn(0), seed=1)
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_s = 0.0
        for i in range(TICKS):
            tb = time.perf_counter()
            batch = task.batch_fn(i)
            batch_s += time.perf_counter() - tb
            state, metrics = trainer.step(state, batch)
        torch.cuda.synchronize()
        ms_tick = (time.perf_counter() - t0) / TICKS * 1e3
        ms_batch = batch_s / TICKS * 1e3
        acc = task.eval_accuracy(state.params, trainer.honest_mask)
        cons = float(metrics["consensus_dist"])
        grew = {k: fn.launches - before[k] for k, fn in kernels.items()}
        for k, n in grew.items():
            want = TICKS if k == rule else 0
            if n != want:
                raise AssertionError(f"{rule}: kernel {k} launched {n} times in {TICKS} ticks, "
                                     f"expected {want}")
        results[rule] = acc
        print(f"trainer {rule}: honest test accuracy {acc:.4f}, consensus {cons:.6g}, "
              f"{ms_tick:.3f} ms/tick over {TICKS} ticks, of which {ms_batch:.3f} ms host batch "
              f"draw and copy (M={M}, b={B}, random attack)")
    launches = {k: fn.launches for k, fn in kernels.items()}
    for rule in ("trimmed_mean", "median"):
        if not results[rule] >= 0.95:
            raise AssertionError(f"{rule} accuracy {results[rule]} < 0.95")
    if not results["mean"] <= 0.5:
        raise AssertionError(f"DGD accuracy {results['mean']} > 0.5: the attack did not bite")
    return launches


def parity_phase(dev):
    task_gpu = linear_task(M, partition="iid", num_train=6000, num_test=1000, device=dev)
    task_cpu = linear_task(M, partition="iid", num_train=6000, num_test=1000, device="cpu")
    topo = erdos_renyi(M, 0.5, B, seed=0)
    init = task_cpu.init_fn(0)
    for rule in ("trimmed_mean", "median"):
        cfg = BridgeConfig(topology=topo, rule=rule, num_byzantine=B, attack="sign_flip", t0=30)
        finals = []
        for device, task in ((dev, task_gpu), ("cpu", task_cpu)):
            trainer = BridgeTrainer(cfg, task.grad_fn, device=device)
            state = trainer.init({k: v.clone() for k, v in init.items()})
            for i in range(5):
                state, _ = trainer.step(state, task.batch_fn(i))
            finals.append({k: v.cpu() for k, v in state.params.items()})
        for k in finals[0]:
            torch.testing.assert_close(finals[0][k], finals[1][k], rtol=1e-4, atol=1e-5)
    print("parity: 5 sign-flip ticks agree on the card and the CPU (rtol 1e-4, atol 1e-5)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    secs = build.build()
    print(f"build: {secs:.2f} s nvcc ({build.library_path().name})")
    for line in build.ptxas_report().splitlines():
        if "spill" in line or "registers" in line:
            print("ptxas:", line.strip())

    records = kernel_phase(dev)
    launches = trainer_phase(dev)
    by_name = {"screen_trimmed_mean_dense": launches["trimmed_mean"],
               "screen_median_dense": launches["median"]}
    for rec in records:
        rec["launches"] = by_name[rec["name"]]
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the main path")
    parity_phase(dev)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
