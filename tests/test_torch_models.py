"""The model zoo's dense family in the port (`repro_torch.models`,
`repro_torch.configs`) on the CPU against the reference's
(`repro.models`, `repro.configs`), computed in-process.

Tolerances, and why:

* configs, parameter counts, shapes, the leaf order and the stream's
  blocks: exact (host data);
* each `layers` function on the same inputs: rtol 2e-6 (IEEE ``sqrt`` and
  division where XLA's ``rsqrt`` multiplies, ROADMAP "rsqrt"; XLA's own
  ``exp`` / ``tanh`` / ``erf`` and summation orders), the norms' outputs
  and the losses included;
* `init_params` and `prng.truncated_normal`: within `prng.normal`'s bound
  of ``jax.random`` (rtol 5.8e-6, atol 2.2e-5: ``torch.erfinv``);
* ``train_loss`` and its gradient of each reduced dense arch, weights
  carried by `repro_torch.convert`: loss rtol 1e-5, gradients rtol 1e-4 and
  atol 1e-6 (measured: loss within 8e-8 relative, gradients within 3.3e-5
  relative beyond atol);
* decode against the port's own forward: rtol 1e-5 (attention over a cache
  sums in another order than the chunked prefill).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import api as japi
from repro.models import layers as JL
from repro.stream.blocks import BlockSpec as JBlockSpec
from repro_torch import convert, prng
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.core import replicate
from repro_torch.models import api, dense
from repro_torch.models import layers as L
from repro_torch.stream import BlockSpec

DENSE = ("starcoder2-3b", "qwen3-4b", "mistral-nemo-12b", "gemma3-12b")
RTOL = 2e-6
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
NORMAL_RTOL, NORMAL_ATOL = 5.8e-6, 2.2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: small ops beside the suite's other
    workers, where torch's thread pool oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=rtol, atol=atol)


def reduced(arch):
    """The tests' reduced config; gemma3's window (8) and query chunk (4)
    shorter than the tests' sequences, so the band slicing and padding
    run."""
    kw = dict(sliding_window=8, q_chunk=4, kv_chunk=8) if arch == "gemma3-12b" else {}
    return jget(arch).reduced(**kw), get_config(arch).reduced(**kw)


@pytest.fixture(scope="module")
def models():
    """Each reduced dense arch's reference parameters (a key of its own),
    the port's copy of them through `convert`, and the jitted reference
    gradient: shared by the tests of this file."""
    out = {}
    for i, arch in enumerate(DENSE):
        jc, tc = reduced(arch)
        ja = japi.build(jc)
        key = jax.random.PRNGKey(10 + i)
        jp = ja.init_params(key, jc)
        tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        out[arch] = dict(jc=jc, tc=tc, ja=ja, key=key, jp=jp, tp=tp,
                         grad=jax.jit(ja.grad_fn()))
    return out


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------


def test_configs_are_the_references():
    """The registry, every field of every config, ``reduced()``, the
    analytic counts and the shape table are the reference's."""
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in ARCHS:
        ours, ref = dataclasses.asdict(ARCHS[name]), dataclasses.asdict(JARCHS[name])
        assert ours == ref, name
        assert dataclasses.asdict(get_config(name).reduced()) == dataclasses.asdict(
            jget(name).reduced())
        assert ARCHS[name].param_count() == JARCHS[name].param_count()
        assert ARCHS[name].active_param_count() == JARCHS[name].active_param_count()
        assert ARCHS[name].tdtype == torch.float32
    from repro.configs import shapes as jshapes

    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for name in ARCHS:
        for s in tshapes.SHAPES:
            assert tshapes.shape_applicable(ARCHS[name], tshapes.SHAPES[s])[0] == \
                jshapes.shape_applicable(JARCHS[name], jshapes.SHAPES[s])[0]
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("nope")


@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_and_leaf_order(arch):
    """`api.param_count` (shapes only) is the reference's ``eval_shape``
    count at full and reduced size; the port's sorted flat keys are the
    reference's pytree leaves in order, with their shapes; the full-width
    qwen3-4b cut to 2 layers holds 979,776,512 parameters."""
    full = get_config(arch)
    assert api.param_count(full) == japi.param_count(jget(arch))
    jc, tc = reduced(arch)
    shapes = jax.eval_shape(lambda k: japi.build(jc).init_params(k, jc), jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ref_keys = ["/".join(p.key for p in path) for path, _ in paths]
    ours = api.build(tc).param_shapes(tc)
    assert sorted(ours) == ref_keys
    assert [tuple(ours[k]) for k in sorted(ours)] == [tuple(s.shape) for _, s in paths]
    if arch == "qwen3-4b":
        assert api.param_count(dataclasses.replace(full, num_layers=2)) == 979_776_512


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_build_accepts_every_arch(name):
    """`build` succeeds for all ten archs, its entries the family module's,
    and `param_count` is the reference's at full and reduced size."""
    cfg = ARCHS[name]
    built = api.build(cfg)
    assert built.cfg == cfg and callable(built.decode_step) and callable(built.param_shapes)
    assert api.param_count(cfg) == japi.param_count(JARCHS[name])
    assert api.param_count(cfg.reduced()) == japi.param_count(jget(name).reduced())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_rope_and_mlps():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    bvec = rng.normal(size=(16,)).astype(np.float32)
    close(L.rms_norm(t(x), t(w)), JL.rms_norm(j(x), j(w)))
    close(L.layer_norm(t(x), t(w), t(bvec)), JL.layer_norm(j(x), j(w), j(bvec)))
    close(L.apply_norm({"w": t(w), "b": t(bvec)}, t(x), "layernorm"),
          JL.apply_norm({"w": j(w), "b": j(bvec)}, j(x), "layernorm"))
    close(L.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6))
    pos = np.arange(5)
    close(L.apply_rope(t(x), t(pos), 1e4), JL.apply_rope(j(x), j(pos), 1e4))
    close(L.apply_rope(t(x), t(pos), 1e4, rot_dim=8), JL.apply_rope(j(x), j(pos), 1e4, rot_dim=8))
    pos3 = np.stack([pos, pos + 1, 2 * pos])
    close(L.apply_mrope(t(x), t(pos3), 1e6, (2, 3, 3)),
          JL.apply_mrope(j(x), j(pos3), 1e6, (2, 3, 3)))
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    for act, bias in (("swiglu", False), ("gelu", True)):
        shapes = L.mlp_shapes(16, 24, act=act, bias=bias)
        p = {k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in shapes.items()}
        close(L.mlp({k: t(v) for k, v in p.items()}, t(h), act),
              JL.mlp({k: j(v) for k, v in p.items()}, j(h), act))
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    close(L.softmax_xent(t(logits), t(labels)), JL.softmax_xent(j(logits), j(labels)))
    close(L.softmax_xent(t(logits), t(labels), t(mask)),
          JL.softmax_xent(j(logits), j(labels), j(mask)))


def test_attention_forms():
    """The chunked attention (GQA, padded last chunk, causal and not, a q
    offset, a bias mask), the sliding window with its band shorter than the
    sequence, decode against a cache (scalar and per-row lengths, a window)
    and the projections (bias, qk-norm)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    for causal in (True, False):
        close(L.chunked_attention(t(q), t(k), t(v), causal=causal, kv_chunk=5),
              JL.chunked_attention(j(q), j(k), j(v), causal=causal, kv_chunk=5))
    close(L.chunked_attention(t(q[:, :3]), t(k), t(v), kv_chunk=4, q_offset=6),
          JL.chunked_attention(j(q[:, :3]), j(k), j(v), kv_chunk=4, q_offset=6))
    even = lambda qp, kp: (kp[None, :] % 2) == 0
    close(L.chunked_attention(t(q), t(k), t(v), kv_chunk=4, bias_mask=even),
          JL.chunked_attention(j(q), j(k), j(v), kv_chunk=4, bias_mask=even))
    for window, qc in ((3, 4), (5, 12), (8, 3)):
        close(L.sliding_window_attention(t(q), t(k), t(v), window=window, q_chunk=qc),
              JL.sliding_window_attention(j(q), j(k), j(v), window=window, q_chunk=qc))
    qd = q[:, :1]
    for cl, window in ((7, None), (np.array([3, 12]), None), (9, 4), (np.array([2, 11]), 5)):
        close(L.decode_attention(t(qd), t(k), t(v), t(cl), window=window),
              JL.decode_attention(j(qd), j(k), j(v), j(cl), window=window))
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    shapes = L.attention_shapes(16, 4, 2, 8, qk_norm=True, bias=True)
    p = {kk: rng.normal(size=s).astype(np.float32) * 0.3 for kk, s in shapes.items()}
    jp = convert.unflatten_tree({kk: j(vv) for kk, vv in p.items()})
    tp = {kk: t(vv) for kk, vv in p.items()}
    for got, want in zip(L.qkv_project(tp, t(x), 4, 2, 8, qk_norm=True),
                         JL.qkv_project(jp, j(x), 4, 2, 8, qk_norm=True), strict=True):
        close(got, want)
    o = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    close(L.attn_output(tp, t(o)), JL.attn_output(jp, j(o)))


def test_draws_truncated_normal_and_ranges(monkeypatch):
    """`prng.truncated_normal` and `L.dense_init` within the normal bound
    of the reference's; a draw made range by range (`prng.RANGE`) equals
    the whole draw bit for bit."""
    key = jax.random.PRNGKey(5)
    close(prng.truncated_normal(np.asarray(key), -2.0, 2.0, (300, 70), "cpu"),
          jax.random.truncated_normal(key, -2.0, 2.0, (300, 70), jnp.float32),
          rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    close(L.dense_init(np.asarray(key), (64, 30), torch.float32, "cpu"),
          JL.dense_init(key, (64, 30), jnp.float32), rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    host = np.asarray(key)
    whole = [prng.bits(host, (7, 301), "cpu"), prng.uniform(host, (7, 301), "cpu", -1.0, 3.0),
             prng.normal(host, (7, 301), "cpu"), prng.truncated_normal(host, -2, 2, (7, 301),
                                                                      "cpu")]
    monkeypatch.setattr(prng, "RANGE", 100)
    ranged = [prng.bits(host, (7, 301), "cpu"), prng.uniform(host, (7, 301), "cpu", -1.0, 3.0),
              prng.normal(host, (7, 301), "cpu"), prng.truncated_normal(host, -2, 2, (7, 301),
                                                                       "cpu")]
    for a, b in zip(whole, ranged, strict=True):
        assert torch.equal(a, b)
    # replicate's perturbation drawn by ranges too: the reference's values
    p = {"w": torch.ones((40, 9))}
    close(replicate(p, 3, perturb=0.01, key=host)["w"],
          jax.tree_util.tree_leaves(__import__("repro.core", fromlist=["replicate"]).replicate(
              {"w": jnp.ones((40, 9))}, 3, perturb=0.01, key=key))[0],
          rtol=NORMAL_RTOL, atol=NORMAL_ATOL)


# ---------------------------------------------------------------------------
# the dense family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_matches_the_reference(models, arch):
    """`dense.init_params` from the same key: every leaf within the normal
    bound of the reference's, its dtype and shape the reference's."""
    m = models[arch]
    ours = dense.init_params(np.asarray(m["key"]), m["tc"], device="cpu")
    assert sorted(ours) == sorted(m["tp"])
    for k, v in ours.items():
        assert v.dtype == m["tp"][k].dtype and v.shape == m["tp"][k].shape
        close(v, m["tp"][k], rtol=NORMAL_RTOL, atol=NORMAL_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_and_gradients_match_the_reference(models, arch):
    """Each reduced dense arch's loss and gradient on two sequences of 16
    tokens (gemma3: local layers over a window of 8 and global ones), the
    port's `ModelApi.grad_fn` over two nodes against the reference's
    jitted ``value_and_grad`` per node."""
    m = models[arch]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, m["tc"].vocab_size, (2, 2, 17)).astype(np.int32)
    stacked = {k: torch.stack([v, v * 1.01]) for k, v in m["tp"].items()}
    losses, grads = api.build(m["tc"]).grad_fn()(stacked, {"tokens": t(toks)})
    assert losses.shape == (2,)
    for node in range(2):
        jp = convert.unflatten_tree({k: j(v[node].numpy()) for k, v in stacked.items()})
        jl, jg = m["grad"](jp, {"tokens": j(toks[node])})
        np.testing.assert_allclose(float(losses[node]), float(jl), rtol=LOSS_RTOL)
        for k, g in convert.flatten_tree(jg).items():
            close(grads[k][node], g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if arch == "qwen3-4b":  # cfg.remat: each group's activations recomputed, the same values
        remat = dataclasses.replace(m["tc"], remat=True)
        l2, g2 = api.build(remat).grad_fn()(stacked, {"tokens": t(toks)})
        assert torch.equal(l2, losses) and all(torch.equal(g2[k], grads[k]) for k in grads)


@pytest.mark.parametrize("arch", ["gemma3-12b", "starcoder2-3b"])
def test_decode_matches_forward_and_the_reference(models, arch):
    """Prefill of a prefix then token-by-token `decode_step` against the
    port's `forward` over the whole sequence (gemma3's window shorter than
    it), ``last_only`` against the last row; one decode step against the
    reference's from the same cache."""
    m = models[arch]
    cfg, tp = m["tc"], m["tp"]
    rng = np.random.default_rng(4)
    toks = t(rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    full = dense.forward(tp, toks, cfg)
    close(dense.forward(tp, toks, cfg, last_only=True), full[:, -1:], rtol=1e-6)
    cache = dense.init_cache(cfg, 2, 16, device="cpu")
    for i in range(12):
        logits, cache = dense.decode_step(tp, cache, toks[:, i:i + 1], cfg)
        close(logits[:, 0], full[:, i], rtol=1e-5, atol=1e-5)
    assert int(cache["pos"]) == 12
    jcache = {k: j(v.numpy()) for k, v in cache.items()}
    jl, jc = dense_ref_step(m, jcache, toks[:, :1])
    tl, tc = dense.decode_step(tp, cache, toks[:, :1], cfg)
    close(tl, jl, rtol=1e-5, atol=1e-5)
    close(tc["k"], jc["k"], rtol=1e-5, atol=1e-6)
    assert int(tc["pos"]) == int(jc["pos"]) == 13


def dense_ref_step(m, jcache, tok):
    from repro.models import dense as jdense

    return jdense.decode_step(m["jp"], jcache, j(tok.numpy()), m["jc"])


def test_stream_blocks_of_rank_four_leaves(models):
    """The stream's partition of the stacked model (blocks ``[M, G, P,
    ...]``, each viewed as ``[M, s]``) leaf by leaf the reference's: the
    order, sizes, offsets, blocks and the coordinate matrices."""
    m = models["gemma3-12b"]
    stacked = replicate(m["tp"], 3)
    jstacked = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (3,) + x.shape), m["jp"])
    for chunk in (None, 1000, 4096):
        ours, ref = BlockSpec.from_params(stacked, chunk), JBlockSpec.from_params(jstacked, chunk)
        assert ours.chunk == ref.chunk and ours.block_sizes() == ref.block_sizes()
        assert [(p.shape, p.size, p.offset, p.block0, p.num_full, p.tail) for p in ours.leaves] \
            == [(p.shape, p.size, p.offset, p.block0, p.num_full, p.tail) for p in ref.leaves]
        assert any(len(p.shape) == 3 for p in ours.leaves)  # [G, P, ...] a node: rank 4
        for a, b in zip(ours.leaf_mats(stacked), ref.leaf_mats(jstacked), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
