"""The port's wire codecs and compressed exchange (`repro_torch.comm`,
`repro_torch.kernels.dequant`'s plain versions) against the reference's
`repro.comm` on the CPU: ``int8``, ``int4`` and the sparse ``topk<P>`` /
``randk<P>`` family with its ``_int8`` / ``_int4`` forms.

Tolerances, stated per comparison:
* codes, scales, ``x_hat``, the residual and the public copy: exact — the
  reference's jitted ``encode_bank`` / ``decode_bank`` round the dense
  decode into each output once (a fused multiply-add), and so does the
  port; the sparse decode rounds the product and the adds apart (the
  scatter sits between them), in both;
* indices (topk over ``|x|``, ties to the lower index; randk's shared
  draw), packed nibbles and the in-support residual: exact;
* ``wire_bits``: equal integers;
* the plain ``dequant`` against ``dequant_pallas`` in interpret mode:
  exact, NaN-aware (inf scales included);
* the residual norm: rtol 1e-6 (a sum of 94k squares, reduced in another
  order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codec as jcodec
from repro.comm import exchange as jexchange
from repro.kernels.dequant_screen import dequant_pallas
from repro_torch import prng
from repro_torch.comm import codec, exchange
from repro_torch.kernels import dequant, ref
from test_torch_kernels import codeword, nan_equal

M, D = 12, 7850


def carry_inputs(seed: int, m: int = M, d: int = D):
    """An iterate of per-row magnitudes 1e-4..1e2 (one all-zero block),
    a public copy and a residual."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 10.0 ** rng.uniform(-4, 2, size=(m, 1))).astype(np.float32)
    x[0, :300] = 0.0
    est = (rng.normal(size=(m, d)) * 0.5).astype(np.float32)
    resid = (rng.normal(size=(m, d)) * 0.01).astype(np.float32)
    return x, est, resid


@pytest.fixture(scope="module")
def jax_roundtrip():
    c = jcodec.get_codec("int8")

    @jax.jit
    def run(key, x, est, resid):
        st = jexchange.CommState(est, resid)
        msg, target = jexchange.encode_bank((c,), 0, key, x, st)
        x_hat, st2 = jexchange.decode_bank((c,), 0, msg, target, st, key)
        return msg, target, x_hat, st2

    return run


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_roundtrip_exact(jax_roundtrip, seed):
    x, est, resid = carry_inputs(seed)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 0x636D6D30)
    msg, target, x_hat, st = jax_roundtrip(jkey, *(jnp.asarray(a) for a in (x, est, resid)))
    c = codec.get_codec("int8")
    state = exchange.CommState(torch.from_numpy(est), torch.from_numpy(resid))
    tmsg, ttarget = exchange.encode(c, np.asarray(jkey), torch.from_numpy(x), state)
    assert tmsg.payload.dtype == torch.int8 and tmsg.scale.shape == (M, 62, 2)
    np.testing.assert_array_equal(tmsg.payload.numpy(), np.asarray(msg.payload))
    np.testing.assert_array_equal(tmsg.scale.numpy(), np.asarray(msg.scale))
    np.testing.assert_array_equal(ttarget.numpy(), np.asarray(target))
    tx_hat, tstate = exchange.decode(c, tmsg, ttarget, state)
    np.testing.assert_array_equal(tx_hat.numpy(), np.asarray(x_hat))
    np.testing.assert_array_equal(tstate.est.numpy(), np.asarray(st.est))
    np.testing.assert_array_equal(tstate.resid.numpy(), np.asarray(st.resid))


def test_codec_encode_decode_match_reference():
    """`Codec.encode` / ``decode`` alone, without the carry."""
    x, _, _ = carry_inputs(5, m=4, d=300)
    jkey = jax.random.PRNGKey(9)
    jc = jcodec.get_codec("int8")
    jmsg = jax.jit(jc.encode)(jkey, jnp.asarray(x))
    c = codec.get_codec("int8")
    msg = c.encode(np.asarray(jkey), torch.from_numpy(x))
    np.testing.assert_array_equal(msg.payload.numpy(), np.asarray(jmsg.payload))
    np.testing.assert_array_equal(msg.scale.numpy(), np.asarray(jmsg.scale))
    assert msg.idx.shape == (4, 0)
    want = np.asarray(jax.jit(lambda m: jc.decode(m, 300))(jmsg))
    np.testing.assert_array_equal(c.decode(msg, 300).numpy(), want)
    ident = codec.get_codec("identity")
    imsg = ident.encode(np.asarray(jkey), torch.from_numpy(x))
    np.testing.assert_array_equal(imsg.payload.numpy(),
                                  np.asarray(jcodec.get_codec("identity").encode(jkey, x).payload))
    np.testing.assert_array_equal(ident.decode(imsg, 300).numpy(), x)


ALL_CODECS = ["identity", "int8", "int4", "topk25", "randk25", "topk25_int8", "topk50_int8",
              "randk10_int4", "topk7_int4", "randk50_int8", "topk50", "topk1", "randk99_int4"]


@pytest.mark.parametrize("d", [1, 128, 300, 7850])
@pytest.mark.parametrize("name", ALL_CODECS)
def test_wire_accounting_matches_reference(name, d):
    c, jc = codec.get_codec(name), jcodec.get_codec(name)
    assert c.wire_bits(d) == jc.wire_bits(d)
    assert c.payload_bytes(d) == jc.payload_bytes(d)
    assert c.nscales(d) == jc.nscales(d)
    assert c.kept(d) == jc.kept(d)
    assert c.index_bits(d) == jc.index_bits(d)
    assert c.lossless == jc.lossless
    assert (c.mode, c.bits, c.k_frac) == (jc.mode, jc.bits, jc.k_frac)


@pytest.mark.parametrize("name", ["int4", "topk25", "randk10", "topk25_int8", "randk5_int4"])
def test_unported_codecs_raise(name):
    """The codecs the earlier slices left out now resolve to the reference's
    codec; only names the reference refuses raise."""
    jc = jcodec.get_codec(name)
    c = codec.get_codec(name)
    assert (c.name, c.mode, c.bits, c.k_frac) == (jc.name, jc.mode, jc.bits, jc.k_frac)
    for bad in ("int9", "topk0", "randk100", "topk5_int2", "topk"):
        with pytest.raises(ValueError):
            jcodec.get_codec(bad)
        with pytest.raises(ValueError):
            codec.get_codec(bad)


def test_codec_names_match_reference():
    assert codec.codec_names() == jcodec.codec_names()
    d = 7850
    for name in codec.codec_names():
        assert codec.get_codec(name).wire_bits(d) == jcodec.get_codec(name).wire_bits(d)


@pytest.fixture(scope="module")
def jax_bank_roundtrip():
    cache = {}

    def run(name, key, x, est, resid):
        c = jcodec.get_codec(name)
        if name not in cache:
            @jax.jit
            def fn(key, x, est, resid):
                st = None if c.lossless else jexchange.CommState(est, resid)
                msg, target = jexchange.encode_bank((c,), 0, key, x, st)
                x_hat, st2 = jexchange.decode_bank((c,), 0, msg, target, st, key)
                return msg, target, x_hat, st2
            cache[name] = fn
        return cache[name](key, *(jnp.asarray(a) for a in (x, est, resid)))

    return run


@pytest.mark.parametrize("name", ALL_CODECS)
def test_codec_roundtrip_exact(jax_bank_roundtrip, name):
    """Codes, scales, indices, ``x_hat`` and the (in-support) residual of
    every codec equal the reference's jitted exchange, at the model's
    d = 7850 and at a ragged d = 300."""
    for d, seed in ((7850, 0), (300, 1)):
        x, est, resid = carry_inputs(seed + d, m=4 if d == 7850 else M, d=d)
        x[1, : d // 3] = np.round(x[1, : d // 3] * 4.0) / 4.0  # ties in |x|
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 0x636D6D30)
        msg, target, x_hat, st = jax_bank_roundtrip(name, jkey, x, est, resid)
        c = codec.get_codec(name)
        state = None if c.lossless else exchange.CommState(torch.from_numpy(est),
                                                           torch.from_numpy(resid))
        tmsg, ttarget = exchange.encode(c, np.asarray(jkey), torch.from_numpy(x), state)
        for field in ("payload", "scale", "idx"):
            np.testing.assert_array_equal(getattr(tmsg, field).numpy(),
                                          np.asarray(getattr(msg, field)), err_msg=field)
        tx_hat, tstate = exchange.decode(c, tmsg, ttarget, state, np.asarray(jkey))
        np.testing.assert_array_equal(tx_hat.numpy(), np.asarray(x_hat))
        if not c.lossless:
            np.testing.assert_array_equal(tstate.est.numpy(), np.asarray(st.est))
            np.testing.assert_array_equal(tstate.resid.numpy(), np.asarray(st.resid))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizer_rounds_the_multiply_into_the_uniform(bits):
    """Inputs placed where ``floor(x * levels + u)`` rounded twice and the
    fused ``floor(fma(x, levels, u))`` give different codes: the
    reference's jitted encoder takes the fused form, and so does the port."""
    m, d = 8, 1024
    name = "int8" if bits == 8 else "int4"
    levels = 127.0 if bits == 8 else 7.0
    key = prng.PRNGKey(5)
    u = prng.uniform(prng.split(key)[1], (m, d // 128, 128), "cpu").reshape(m, d).double()
    rng = np.random.default_rng(bits)
    n = torch.from_numpy(rng.integers(-levels + 1, levels, size=(m, d)).astype(np.float64))
    x = ((n - u) / levels).float()
    x = torch.nextafter(x, torch.where(torch.from_numpy(rng.random((m, d)) < 0.5), 1.0, -1.0))
    x[:, ::128] = 1.0  # one coordinate of |x| = 1 a block: safe = 1
    fused = torch.floor(ref.fma_f32(x, levels, u.float()))
    twice = torch.floor(x * levels + u.float())
    assert int((fused != twice).sum()) > 20
    jmsg = jax.jit(jcodec.get_codec(name).encode)(jnp.asarray(key), jnp.asarray(x.numpy()))
    msg = codec.get_codec(name).encode(key, x)
    np.testing.assert_array_equal(msg.payload.numpy(), np.asarray(jmsg.payload))


def test_nibble_packing_matches_reference():
    rng = np.random.default_rng(0)
    for k in (1, 2, 7, 300):
        q = rng.integers(-8, 8, size=(3, k)).astype(np.int8)
        packed = codec.pack_nibbles(torch.from_numpy(q))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jcodec._pack_nibbles(jnp.asarray(q))))
        np.testing.assert_array_equal(codec.unpack_nibbles(packed, k).numpy(), q)
        b = rng.integers(-128, 128, size=(3, k)).astype(np.int8)  # garbage bytes
        np.testing.assert_array_equal(codec.unpack_nibbles(torch.from_numpy(b), 2 * k - 1).numpy(),
                                      np.asarray(jcodec._unpack_nibbles(jnp.asarray(b), 2 * k - 1)))


def test_top_indices_break_ties_like_lax_top_k():
    rng = np.random.default_rng(1)
    v = np.round(rng.normal(size=(5, 400)) * 3.0).astype(np.float32)  # many ties
    v[0] = 0.0
    for k in (1, 17, 200, 400):
        _, want = jax.jit(lambda a, k=k: jax.lax.top_k(a, k))(jnp.asarray(v))
        np.testing.assert_array_equal(codec.top_indices(torch.from_numpy(v), k).numpy(),
                                      np.asarray(want))


def test_scatter_last_writer_wins_like_xla():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 50, size=(4, 3, 40)).astype(np.int32)  # repeats
    vals = rng.normal(size=(4, 3, 40)).astype(np.float32)
    want = jax.jit(lambda i, v: jcodec._scatter_last(i, v, 50))(jnp.asarray(idx), jnp.asarray(vals))
    got = codec.scatter_last(torch.from_numpy(idx), torch.from_numpy(vals), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["topk25_int8", "randk25", "randk10_int4", "topk50"])
def test_sparse_decode_matches_reference(name):
    """`Codec.decode` alone (no carry): the kept values scattered into
    zeros; randk re-derives its indices from the key."""
    x, _, _ = carry_inputs(8, m=4, d=300)
    jkey = jax.random.PRNGKey(4)
    jc, c = jcodec.get_codec(name), codec.get_codec(name)
    jmsg = jax.jit(jc.encode)(jkey, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda m_, k_: jc.decode(m_, 300, k_))(jmsg, jkey))
    msg = c.encode(np.asarray(jkey), torch.from_numpy(x))
    np.testing.assert_array_equal(c.decode(msg, 300, np.asarray(jkey)).numpy(), want)
    if c.mode == "randk":
        np.testing.assert_array_equal(c.randk_indices(np.asarray(jkey), (4,), 300, "cpu").numpy(),
                                      np.asarray(jc.randk_indices(jkey, (4,), 300)))


@pytest.mark.parametrize("n,d", [(4, 300), (12, 7850)])
def test_dequant_plain_vs_pallas(n, d):
    q, scale = codeword(n, d, seed=d)
    want = np.asarray(dequant_pallas(jnp.asarray(q), jnp.asarray(scale), block_d=128, interpret=True))
    before = dequant.dequant.launches
    got = dequant.dequant(torch.from_numpy(q), torch.from_numpy(scale)).numpy()
    assert dequant.dequant.launches == before
    assert np.isposinf(got[:2, :5]).all()  # an inf scale times a zero code
    assert nan_equal(got, want).all()


def test_dequant_carry_zero_term_forms():
    """A zero of 0 gives the fused forms; any other zero decodes first —
    each as the reference's program computes it (zero folded away as a
    constant, or a run-time operand)."""
    n, d = 6, 300
    q, scale = codeword(n, d, seed=1)
    scale[0, 0, 0] = 0.01
    scale[1, 0, 0] = 0.02
    _, est, target = carry_inputs(3, m=n, d=d)
    jc = jcodec.get_codec("int8")
    st = jexchange.CommState(jnp.asarray(est), jnp.zeros((n, d), jnp.float32))
    jx, jst = jax.jit(lambda m, t, s: jexchange.decode_bank((jc,), 0, m, t, s))(
        jcodec.WireMsg(jnp.asarray(q), jnp.asarray(scale), jnp.zeros((n, 0), jnp.int32)),
        jnp.asarray(target), st)
    x_hat, resid = dequant.dequant_carry(torch.from_numpy(q), torch.from_numpy(scale),
                                         torch.from_numpy(est), torch.from_numpy(target))
    nonzero = np.repeat(scale[..., 1] != 0, 128, axis=1)[:, :d]
    np.testing.assert_array_equal(x_hat.numpy()[nonzero], np.asarray(jx)[nonzero])
    np.testing.assert_array_equal(resid.numpy()[nonzero], np.asarray(jst.resid)[nonzero])
    qf, s = q.astype(np.float64), np.repeat(scale[..., 0], 128, axis=1)[:, :d].astype(np.float64)
    fused = (qf * s + est.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(x_hat.numpy()[~nonzero], fused[~nonzero])


def test_dequant_wrappers_reject_bad_operands():
    q = torch.zeros(4, 300, dtype=torch.int8)
    scale = torch.zeros(4, 3, 2)
    est = torch.zeros(4, 300)
    with pytest.raises(TypeError):
        dequant.dequant(q.float(), scale)
    with pytest.raises(ValueError):
        dequant.dequant(q, torch.zeros(4, 2, 2))
    with pytest.raises(ValueError):
        dequant.dequant_carry(q, scale, est[:3].contiguous(), est[:3].contiguous())
    assert ref.dequant(q, scale).shape == (4, 300)


def test_comm_state_and_residual_norm():
    c = codec.get_codec("int8")
    assert exchange.init_residual((3, 5), codec.get_codec("identity"), device="cpu") is None
    st = exchange.init_residual((M, D), c, device="cpu")
    assert st.est.shape == st.resid.shape == (M, D) and not st.est.any()
    x, est, resid = carry_inputs(4)
    state = exchange.CommState(torch.from_numpy(est), torch.from_numpy(resid))
    msg, target = exchange.encode(c, np.asarray(jax.random.PRNGKey(0)), torch.from_numpy(x), state)
    _, new = exchange.decode(c, msg, target, state)
    r = new.resid.numpy().astype(np.float64)
    np.testing.assert_allclose(float(torch.sqrt(torch.sum(new.resid * new.resid))),
                               np.sqrt((r * r).sum()), rtol=1e-6)


def test_lossy_exchange_without_carry_raises():
    """A lossy codec with no carry would send the raw iterate and drop the
    error feedback; encode and decode refuse it instead."""
    c = codec.get_codec("int8")
    x = torch.from_numpy(carry_inputs(6, m=3, d=300)[0])
    key = np.asarray(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="CommState"):
        exchange.encode(c, key, x, None)
    msg = c.encode(key, x)
    with pytest.raises(ValueError, match="CommState"):
        exchange.decode(c, msg, x, None)
    ident = codec.get_codec("identity")
    imsg, target = exchange.encode(ident, key, x, None)
    out, state = exchange.decode(ident, imsg, target, None)
    assert torch.equal(out, x) and state is None


def test_codec_decode_is_the_dequant_function():
    """`Codec.decode` over any leading shape is ``dequant`` of the
    flattened codeword (its plain version here, by the CPU tensor)."""
    q, scale = codeword(6, 300, seed=4)
    msg = codec.WireMsg(torch.from_numpy(q).reshape(2, 3, 300),
                        torch.from_numpy(scale).reshape(2, 3, 3, 2), torch.zeros(2, 3, 0))
    before = dequant.dequant.launches
    got = codec.get_codec("int8").decode(msg, 300)
    assert dequant.dequant.launches == before
    assert got.shape == (2, 3, 300)
    want = ref.dequant(torch.from_numpy(q), torch.from_numpy(scale))
    assert nan_equal(got.reshape(6, 300).numpy(), want.numpy()).all()
    assert np.isposinf(got.reshape(6, 300).numpy()[:2, :5]).all()
