"""Batch invariance on the card: what the batched grids rely on for every
cell to equal its own trainer run bit for bit.

    python tools/first_probe.py        # on a machine with one CUDA card

Builds the kernels, then checks on the card, printing OK / FAIL a line:

* the batched distance kernel equals the unbatched kernel of each element's
  rows (materialized, with a batch stride of 0 and with a self row), and
  prints its largest difference from the plain version;
* the dense, gather and wide screens over ``[E, M, d]`` (per-experiment b,
  shared and per-experiment masks) equal E calls of their ``[M, d]`` form;
* whether the linear model's two products, a sum over the node axis and a
  sum over the last axis give, batched over E cells, each cell's own
  ``[M]`` result (printed, not asserted: the answer for the card's cuBLAS
  and reduction kernels at these shapes).

Its first run found every kernel form equal and the products and the
node-axis sums batch-invariant, the last-axis sums not at M = 12 and 129
(`PERF.md`, the grids' findings).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core.graph import erdos_renyi, small_world  # noqa: E402
from repro_torch.core.neighbors import NeighborTable  # noqa: E402
from repro_torch.kernels import build, gather_screen, median, pairwise, ref, trimmed_mean  # noqa: E402

D = 7850


def main() -> int:
    if not torch.cuda.is_available():
        print("first_probe: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=g).to(dev)
    ok = True

    def check(tag, cond):
        nonlocal ok
        print(tag, "OK" if cond else "FAIL")
        ok &= bool(cond)

    for bsz, n, d in ((3, 50, D), (2, 12, D), (4, 17, 300), (2, 129, D)):
        x = rand(bsz, n, d)
        got = pairwise.pairwise_sq_dists_batched(x)
        want = torch.stack([pairwise.pairwise_sq_dists(x[i].contiguous()) for i in range(bsz)])
        check(f"batched pairwise {bsz}x[{n},{d}] == unbatched", torch.equal(got, want))
    base, selfv = rand(50, D), rand(50, D)
    views = base[None].expand(50, 50, D)
    got = pairwise.pairwise_sq_dists_batched(views, selfv)
    want = torch.stack([pairwise.pairwise_sq_dists(torch.cat([base, selfv[i:i + 1]]).contiguous())
                        for i in range(50)])
    check("views stride 0 + self == unbatched", torch.equal(got, want))
    print("views vs plain max err", float((got - ref.pairwise_sq_dists_batched(views, selfv))
                                          .abs().max()))

    for m in (12, 50, 129):
        topo = erdos_renyi(m, 0.9, 2, seed=0) if m == 12 else erdos_renyi(m, 0.5, 4, seed=0)
        adj = torch.as_tensor(topo.adjacency, device=dev)
        e = 5
        w, s = rand(e, m, D), rand(e, m, D)
        b = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32, device=dev)
        got = trimmed_mean.trimmed_mean_dense(w, adj, s, b)
        want = torch.stack([trimmed_mean.trimmed_mean_dense(w[i], adj, s[i], int(b[i]))
                            for i in range(e)])
        check(f"dense trimmed mean E={e} M={m}", torch.equal(got, want))
        got = median.median_dense(w, adj, s)
        want = torch.stack([median.median_dense(w[i], adj, s[i]) for i in range(e)])
        check(f"dense median E={e} M={m}", torch.equal(got, want))
        sel = rand(e, m, m) < 0.5
        got = trimmed_mean.trimmed_mean_dense(w, sel, s, b)
        want = torch.stack([trimmed_mean.trimmed_mean_dense(w[i], sel[i].contiguous(), s[i],
                                                            int(b[i])) for i in range(e)])
        check(f"dense trimmed mean, a mask an experiment, M={m}", torch.equal(got, want))
    for m, topo in ((512, small_world(512, 6, 2, seed=0)),
                    (128, small_world(128, 30, 2, max_degree=64, seed=0))):
        tab = NeighborTable.from_adjacency(topo.adjacency, device=dev)
        e = 3
        w, s = rand(e, m, D), rand(e, m, D)
        b = torch.tensor([2, 0, 1], dtype=torch.int32, device=dev)
        idx, valid = tab.safe_idx, tab.valid_dev
        got = gather_screen.gather_screen_trimmed_mean(w, idx, valid, s, b)
        want = torch.stack([gather_screen.gather_screen_trimmed_mean(w[i], idx, valid, s[i],
                                                                     int(b[i]))
                            for i in range(e)])
        check(f"gather trimmed mean E={e} M={m} K={tab.k}", torch.equal(got, want))
        got = gather_screen.gather_screen_median(w, idx, valid, s)
        want = torch.stack([gather_screen.gather_screen_median(w[i], idx, valid, s[i])
                            for i in range(e)])
        check(f"gather median E={e} M={m}", torch.equal(got, want))

    for m in (12, 50, 129, 512):
        for e in (2, 4, 8, 16):
            x = rand(m, 32 if m < 512 else 8, 784)
            wt, gs = rand(e, m, 784, 10), rand(e, m, x.shape[1], 10)
            scores = torch.equal(torch.matmul(x, wt),
                                 torch.stack([torch.matmul(x, wt[i]) for i in range(e)]))
            grad = torch.equal(torch.matmul(x.transpose(1, 2), gs),
                               torch.stack([torch.matmul(x.transpose(1, 2), gs[i])
                                            for i in range(e)]))
            big = rand(e, m, D)
            nodes = torch.equal(torch.sum(big, dim=1),
                                torch.stack([torch.sum(big[i], dim=0) for i in range(e)]))
            last = torch.equal(torch.sum(big * big, dim=2),
                               torch.stack([torch.sum(big[i] * big[i], dim=1) for i in range(e)]))
            print(f"M={m} E={e}: products {scores} / {grad}, node-axis sum {nodes}, "
                  f"last-axis sum {last}")
    print("ALL_OK" if ok else "SOME_FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
