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

The decision twins' per-edge trim fraction (``jnp.mean`` over the decided
columns, `repro.core.screening.trimmed_mean_with_decisions`): the count
over the column count, or times its float32 reciprocal.

ByRDiE's block screen (`repro.core.byrdie`) closes over the adjacency and
passes ``b`` static: ``jax.jit(lambda w: screen_all(w, adj, rule=
"trimmed_mean", b=2))`` at M = 20 on ``erdos_renyi(20, 0.5, 2)``, d = 512,
against the kept total divided by ``c = count - 2 b_eff + 1`` and times
``float32(1 / c)``.

The codeword decodes:

* the plain decode with a run-time zero field (random ``(scale, zero)``
  pairs, as ``tests/test_sparse.py`` draws them), jitted ``dequant_ref``
  and the Pallas ``_dequant_rows`` in interpret mode, against
  ``fma(q, s, z)`` and ``q * s + z`` rounded twice;
* the sparse exchange (``topk50_int8``, jitted ``encode_bank`` /
  ``decode_bank``), where a scatter sits between the decode's multiply
  and the carry's adds: ``x_hat`` and the in-support residual on the kept
  coordinates against the separately rounded ``est + q*s`` /
  ``target - q*s`` and the fused ``fma(q, s, est)`` / ``fma(-q, s, target)``;
* the quantizer's ``floor(x / safe * levels + u)`` (jitted int8 and int4
  encoders) on inputs placed where rounding the product before the add of
  the uniform and fusing them give different codes;
* the dense decode under ``scale_abuse`` (jitted ``encode_bank``, the wire
  attack, ``decode_bank``): the residual against the fused
  ``fma(-q, s, target)`` and the decoded-first ``target - fma(q, s, z)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.comm import codec as jcodec
from repro.comm import exchange as jexchange
from repro.core import graph, screening
from repro.kernels import ref as jref
from repro.kernels.dequant_screen import dequant_pallas
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

    byrdie_form()
    decision_forms()
    codeword_forms(rng)

    x = np.concatenate([np.arange(1, 200001, dtype=np.float32),
                        rng.uniform(0.1, 1e6, 200000).astype(np.float32)])
    r = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    tx = torch.from_numpy(x)
    print(f"XLA rsqrt on {x.size} samples: correctly rounded "
          f"{share((1.0 / torch.sqrt(tx.double())).float(), r):.4f}, "
          f"1 / sqrtf {share(1.0 / torch.sqrt(tx), r):.4f}")


def byrdie_form() -> None:
    m, b, d = 20, 2, 512
    adj = graph.erdos_renyi(m, 0.5, b, seed=2).adjacency
    adj_j = jnp.asarray(adj)
    w = np.random.default_rng(1).normal(size=(m, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda w_: screening.screen_all(w_, adj_j, rule="trimmed_mean",
                                                              b=b))(jnp.asarray(w)))
    tw, ta = torch.from_numpy(w), torch.from_numpy(adj)
    div = ref.trimmed_mean_dense(tw, ta, tw, b).numpy()
    rcp = ref.trimmed_mean_dense(tw, ta, tw, b, recip=True).numpy()
    print(f"ByRDiE block screen (closed-over adjacency, static b, M = {m}): division "
          f"{float((div == want).mean()):.4f}, reciprocal multiply {float((rcp == want).mean()):.4f}")


def decision_forms() -> None:
    """The decision twins' per-edge fraction, ``jnp.mean`` of the trimmed
    bits over the ``ceil(d / s)`` decided columns: against the count
    divided by that width and times its float32 reciprocal, at M = 20 on
    ``erdos_renyi(20, 0.5, 2)``, d = 7850, strides 1, 3, 4 and 16, the
    trainer's form (adjacency closed over, b an operand)."""
    m, b = 20, 2
    adj_j = jnp.asarray(graph.erdos_renyi(m, 0.5, b, seed=0).adjacency)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(m, D)).astype(np.float32))
    for s in (1, 3, 4, 16):
        fn = jax.jit(lambda w_, b_, s=s: screening.screen_all_decide_banked(
            w_, adj_j, ("trimmed_mean",), 0, b_, self_vals=w_, decide_stride=s))
        trim = np.asarray(fn(w, jnp.int32(b))[1])
        n = len(range(0, D, s))
        count = np.round(trim.astype(np.float64) * n).astype(np.float32)  # exact integers
        div = count / np.float32(n)
        rcp = count * (np.float32(1) / np.float32(n))
        print(f"decision fraction (stride {s}, {n} columns): division "
              f"{float((div == trim).mean()):.4f}, reciprocal multiply "
              f"{float((rcp == trim).mean()):.4f} (the two differ on {int((div != rcp).sum())} "
              f"of {trim.size} edges)")


def codeword_forms(rng) -> None:
    n, d = 12, 1000
    q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    s = -(-d // 128)
    scale = np.stack([rng.uniform(1e-3, 0.1, size=(n, s)), rng.normal(size=(n, s))],
                     -1).astype(np.float32)
    tq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    sv, zv = (t.numpy() for t in ref.expand_scales(ts, d))
    fused = ref.fma_f32(tq.float(), *ref.expand_scales(ts, d)).numpy()
    twice = q.astype(np.float32) * sv + zv
    jitted = np.asarray(jax.jit(jref.dequant_ref)(jnp.asarray(q), jnp.asarray(scale)))
    pallas = np.asarray(dequant_pallas(jnp.asarray(q), jnp.asarray(scale), block_d=128,
                                       interpret=True))
    for name, got in (("jitted dequant_ref", jitted), ("Pallas _dequant_rows", pallas)):
        print(f"decode with a run-time zero field, {name}: fma(q, s, z) "
              f"{float((fused == got).mean()):.4f}, q * s + z rounded twice "
              f"{float((twice == got).mean()):.4f}")

    c = jcodec.get_codec("topk50_int8")
    x, est, resid = (rng.normal(size=(n, d)).astype(np.float32) * scl for scl in (1.0, 0.5, 0.01))

    @jax.jit
    def roundtrip(key, x, est, resid):
        st = jexchange.CommState(est, resid)
        msg, target = jexchange.encode_bank((c,), 0, key, x, st)
        return (msg, target) + jexchange.decode_bank((c,), 0, msg, target, st, key)

    msg, target, x_hat, st = roundtrip(jax.random.PRNGKey(0), *map(jnp.asarray, (x, est, resid)))
    idx = np.asarray(msg.idx)
    rows = np.arange(n)[:, None]
    qv = np.asarray(msg.payload).astype(np.float32)
    sk = np.repeat(np.asarray(msg.scale)[..., 0], 128, axis=1)[:, : idx.shape[1]]
    e, t = est[rows, idx], np.asarray(target)[rows, idx]
    prod = qv * sk
    x_got, r_got = np.asarray(x_hat)[rows, idx], np.asarray(st.resid)[rows, idx]
    tq, tsk = torch.from_numpy(qv), torch.from_numpy(sk)
    fx = ref.fma_f32(tq, tsk, torch.from_numpy(e)).numpy()
    fr = ref.fma_f32(-tq, tsk, torch.from_numpy(t)).numpy()
    quantizer_forms()
    scale_abuse_form(rng)
    print(f"sparse exchange (topk50_int8) on the kept coordinates: x_hat est + q*s rounded twice "
          f"{float((e + prod == x_got).mean()):.4f}, fma {float((fx == x_got).mean()):.4f}; "
          f"residual target - q*s rounded twice {float((t - prod == r_got).mean()):.4f}, "
          f"fma {float((fr == r_got).mean()):.4f}")


def quantizer_forms() -> None:
    from repro_torch import prng

    m, d = 8, 1024
    for name, levels in (("int8", 127.0), ("int4", 7.0)):
        key = prng.PRNGKey(5)
        u = prng.uniform(prng.split(key)[1], (m, d // 128, 128), "cpu").reshape(m, d)
        rng = np.random.default_rng(int(levels))
        n = torch.from_numpy(rng.integers(-levels + 1, levels, size=(m, d)).astype(np.float64))
        x = ((n - u.double()) / levels).float()
        x = torch.nextafter(x, torch.where(torch.from_numpy(rng.random((m, d)) < 0.5), 1.0, -1.0))
        x[:, ::128] = 1.0  # safe = 1
        fused = torch.floor(ref.fma_f32(x, levels, u))
        twice = torch.floor(x * levels + u)
        differ = (fused != twice).numpy()
        msg = jax.jit(jcodec.get_codec(name).encode)(jnp.asarray(key), jnp.asarray(x.numpy()))
        codes = np.asarray(msg.payload)
        if name == "int4":
            codes = np.asarray(jcodec._unpack_nibbles(msg.payload, d))
        print(f"quantizer ({name}) on the {int(differ.sum())} codes where the forms differ: "
              f"fused {float((fused.numpy()[differ] == codes[differ]).mean()):.4f}, product "
              f"rounded first {float((twice.numpy()[differ] == codes[differ]).mean()):.4f}")


def scale_abuse_form(rng) -> None:
    from repro.core import byzantine as jbyz

    n, d = 12, 1000
    c = jcodec.get_codec("int8")
    x, est, resid = (rng.normal(size=(n, d)).astype(np.float32) * scl for scl in (1.0, 0.5, 0.01))
    byz = np.zeros(n, bool)
    byz[[2, 7]] = True

    @jax.jit
    def roundtrip(key, x, est, resid):
        st = jexchange.CommState(est, resid)
        msg, target = jexchange.encode_bank((c,), 0, key, x, st)
        msg = jbyz.WIRE_ATTACKS["scale_abuse"](msg, jnp.asarray(byz), key, 0, d)
        return (msg, target) + jexchange.decode_bank((c,), 0, msg, target, st, key)

    msg, target, _, st = roundtrip(jax.random.PRNGKey(1), *map(jnp.asarray, (x, est, resid)))
    q = torch.from_numpy(np.array(msg.payload)).float()
    s_, z_ = ref.expand_scales(torch.from_numpy(np.asarray(msg.scale)), d)
    tgt = torch.from_numpy(np.asarray(target))
    fused = ref.fma_f32(-q, s_, tgt).numpy()
    first = (tgt - ref.fma_f32(q, s_, z_)).numpy()
    got = np.asarray(st.resid)
    for rows, label in ((~byz, "honest"), (byz, "Byzantine")):
        print(f"dense int8 decode under scale_abuse, {label} rows: residual fused "
              f"{float((fused[rows] == got[rows]).mean()):.4f}, decoded first "
              f"{float((first[rows] == got[rows]).mean()):.4f}")


if __name__ == "__main__":
    main()
