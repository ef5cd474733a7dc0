"""Which arithmetic XLA-CPU compiles the reference trainer's divisions into,
measured as the share of coordinates on which each candidate form equals
the jitted reference (the findings behind ROADMAP Queue 3's divisor items).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xla_divisor_forms.py

The trainer form closes over the adjacency and passes ``b`` as an operand
(`repro.core.bridge`), at M = 50 on ``erdos_renyi(50, 0.5, 4)``, d = 7850:

* ``mean``: ``total / (count + 1)`` against ``total * (1 / (count + 1))``;
* ``geomedian``'s first step (``iters=0``): ``S / sum(fm)`` against the
  reciprocal multiply;
* ``clipped_mean`` on integer-valued rows (its squared norms are then
  exact in any order), fed XLA's own ``rsqrt``: division, reciprocal
  multiply, and the multiply fused with the add of self (one rounding);
* XLA's ``rsqrt`` against a correctly rounded ``1 / sqrt`` and ``1 / sqrtf``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import graph, screening
from repro_torch.kernels import ref

M, D, B = 50, 7850, 4


def main() -> None:
    adj = graph.erdos_renyi(M, 0.5, B, seed=0).adjacency
    adj_j, adj_t = jnp.asarray(adj), torch.from_numpy(adj)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(M, D)).astype(np.float32)
    wi = rng.integers(-3, 4, size=(M, D)).astype(np.float32)

    def trainer_form(rule, x):
        fn = jax.jit(lambda w_, b_: screening.screen_all_banked(w_, adj_j, (rule,), 0, b_,
                                                                self_vals=w_))
        return np.asarray(fn(jnp.asarray(x), jnp.int32(B)))

    def share(got, want):
        return float((np.asarray(got) == want).mean())

    def chain(x):  # the reference's left-to-right sum over dim 1
        total = x[:, 0]
        for i in range(1, x.shape[1]):
            total = total + x[:, i]
        return total

    tw = torch.from_numpy(w)
    count = adj_t.sum(dim=1).to(torch.float32)[:, None]
    total = chain(torch.where(adj_t[:, :, None], tw[None], 0.0)) + tw
    want = trainer_form("mean", w)
    print(f"mean: division {share(total / (count + 1), want):.4f}, "
          f"reciprocal multiply {share(total * (1.0 / (count + 1)), want):.4f}")

    gm0 = jax.jit(lambda w_: jax.vmap(lambda m, s: screening.geometric_median(w_, m, s, iters=0))(
        adj_j, w_))
    want = np.asarray(gm0(jnp.asarray(w)))
    full = torch.cat([adj_t, torch.ones((M, 1), dtype=torch.bool)], dim=1).to(torch.float32)
    stacked = torch.cat([tw[None].expand(M, M, D), tw[:, None]], dim=1)
    s = chain(stacked * full[:, :, None])
    den = full.sum(dim=1)[:, None]
    print(f"geomedian first step: division {share(s / den, want):.4f}, "
          f"reciprocal multiply {share(s * (1.0 / den), want):.4f}")

    ti = torch.from_numpy(wi)
    want = trainer_form("clipped_mean", wi)
    delta = ti[None] - ti[:, None]
    ss = torch.sum(delta * delta, dim=2, keepdim=True) + 1e-12
    rsqrt = torch.tensor(np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(ss.numpy()))))
    clipped = torch.where(adj_t[:, :, None], delta * torch.clamp(rsqrt, max=1.0), 0.0)
    s = chain(clipped)
    c = torch.clamp(adj_t.sum(dim=1), min=1).to(torch.float32)[:, None]
    fused = ref.fma_f32(s, (1.0 / c).expand_as(s).contiguous(), ti)
    print(f"clipped_mean (XLA's rsqrt fed in): division {share(ti + s / c, want):.4f}, "
          f"reciprocal multiply {share(ti + s * (1.0 / c), want):.4f}, "
          f"fused multiply-add {share(fused, want):.4f}")

    x = np.concatenate([np.arange(1, 200001, dtype=np.float32),
                        rng.uniform(0.1, 1e6, 200000).astype(np.float32)])
    r = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    tx = torch.from_numpy(x)
    print(f"XLA rsqrt on {x.size} samples: correctly rounded "
          f"{share((1.0 / torch.sqrt(tx.double())).float(), r):.4f}, "
          f"1 / sqrtf {share(1.0 / torch.sqrt(tx), r):.4f}")


if __name__ == "__main__":
    main()
