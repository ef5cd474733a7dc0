"""The rest of the model zoo in the port (`repro_torch.models.moe`, ``ssm``,
``hybrid``, ``encdec``, ``vlm``) and serving
(`repro_torch.examples.serve`) on the CPU against the reference's
(`repro.models`, ``examples/serve.py``), computed in-process from seeded
numpy inputs: each reduced config of the MoE (deepseek-v2, deepseek-v3
with its MTP head), RWKV6, hybrid (zamba2, and zamba2 with 5 layers, so
that a remainder block runs), enc-dec (whisper) and VLM (qwen2-vl)
families, sequences of 16, batch 2.

Tolerances, and why:

* configs, parameter counts, shapes, the leaf order, the MoE's routing and
  dispatch, the constant leaves and Mamba2's ``a_log``: exact (the port
  writes XLA's ``linspace`` and ``log`` forms for ``a_log``);
* the drawn leaves (``dense_init``'s truncated normals, Mamba2's
  ``conv_w``, Whisper's ``enc_pos`` / ``dec_pos`` normals): within
  `prng.normal`'s bound of ``jax.random`` (rtol 5.8e-6, atol 2.2e-5:
  ``torch.erfinv``);
* ``train_loss`` and its gradients on the reference's parameters: the
  dense family's bounds (``tests/test_torch_models.py``), loss rtol 1e-5,
  gradients rtol 1e-4 and atol 1e-6; but the embedding's gradient, whose
  rows sum a token's uses and cancel in a few entries (measured: 1-5 of
  65536 entries past 1e-4 relative in the MoE, RWKV and hybrid families,
  all within 1.8e-6 of the leaf's largest), within 1e-5 of its largest
  entry;
* decode logits against the reference's from the same cache, and the
  port's decode against its own forward: 2e-4 of the logits' largest
  magnitude, the reference's own bound (``tests/test_models.py``);
* the MoE combine: bit for bit the reference's scatter-add over the same
  contributions; the whole ``moe_ffn`` within 1e-5 of its largest output
  (matmul orders differ).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.models import api as japi
from repro_torch import convert, prng
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import api, encdec, hybrid, moe, ssm, vlm

ZOO = ("deepseek-v2-236b", "deepseek-v3-671b", "rwkv6-3b", "zamba2-1.2b", "whisper-medium",
       "qwen2-vl-2b", "zamba2-rem")
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
EMBED_GRAD_BOUND = 1e-5
NORMAL_RTOL, NORMAL_ATOL = 5.8e-6, 2.2e-5
DECODE_BOUND = 2e-4
B, S = 2, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread (the suite's other workers share the
    CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def bounded(got, want, bound=DECODE_BOUND):
    """``max |got - want|`` within ``bound`` of ``max |want|``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.max(np.abs(got - want)) <= bound * (np.max(np.abs(want)) + 1e-9)


def configs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``
    (``zamba2-rem``: zamba2 at 5 layers, a group of 2 twice and a
    remainder block)."""
    if arch == "zamba2-rem":
        arch, kw = "zamba2-1.2b", dict(kw, num_layers=5)
    return jget(arch).reduced(**kw), get_config(arch).reduced(**kw)


@functools.lru_cache(maxsize=None)
def model(arch):
    """The reference's parameters of a reduced arch (a key of its own) and
    the port's copy of them through `convert`."""
    jc, tc = configs(arch)
    key = jax.random.PRNGKey(20 + ZOO.index(arch))
    jp = japi.build(jc).init_params(key, jc)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return dict(jc=jc, tc=tc, ja=japi.build(jc), ta=api.build(tc), key=key, jp=jp, tp=tp)


def make_batch(cfg, seed=3, lead=()):
    """Tokens ``[*lead, B, S + 1]`` and the family's embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (*lead, B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.normal(size=(*lead, B, S, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(size=(*lead, B, 4, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# configs, counts, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_param_counts_and_leaf_order(arch):
    """`api.param_count` is the reference's ``eval_shape`` count at reduced
    size (at full size: ``tests/test_torch_models.py``'s
    ``test_build_accepts_every_arch``); the sorted flat keys are the
    reference's leaves in order (its ``None`` subtrees have none), with
    their shapes."""
    jc, tc = configs(arch)
    assert api.param_count(tc) == japi.param_count(jc)
    shapes = jax.eval_shape(lambda k: japi.build(jc).init_params(k, jc), jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    ours = api.build(tc).param_shapes(tc)
    assert sorted(ours) == ["/".join(p.key for p in path) for path, _ in paths]
    assert [tuple(ours[k]) for k in sorted(ours)] == [tuple(s.shape) for _, s in paths]


@pytest.mark.parametrize("arch", ZOO)
def test_init_params_matches_the_reference(arch):
    """The family's `init_params` from the same key: the constant leaves and
    ``a_log`` bit for bit, the drawn ones within the normal bound; each
    leaf's dtype and shape the reference's."""
    m = model(arch)
    ours = m["ta"].init_params(np.asarray(m["key"]), m["tc"], device="cpu")
    assert sorted(ours) == sorted(m["tp"])
    const = 0
    for k, v in ours.items():
        want = m["tp"][k]
        assert v.dtype == want.dtype and v.shape == want.shape, k
        drawn = torch.unique(want).numel() > 1 and not k.endswith("a_log")
        if drawn:
            close(v, want, NORMAL_RTOL, NORMAL_ATOL)
        else:
            assert torch.equal(v, want), k
            const += 1
    assert const > 0
    if m["tc"].family == "hybrid":
        assert any(k.endswith("a_log") for k in ours)


@pytest.mark.parametrize("nh", [8, 16, 40, 64, 128])
def test_a_log_is_the_references_float_form(nh):
    """Mamba2's ``log(linspace(1, 16, nh))``: XLA's linspace and log forms
    written on the host, bit for bit (``torch.log`` and numpy's differ in
    some entries)."""
    assert np.array_equal(ssm._xla_linspace(1.0, 16.0, nh), np.asarray(jnp.linspace(1.0, 16.0, nh)))
    assert np.array_equal(ssm.a_log_init(nh), np.asarray(jnp.log(jnp.linspace(1.0, 16.0, nh))))


def test_build_accepts_the_new_families_with_their_extras():
    """`build` returns each family's entries and the reference's ``extra``
    keys; the launch CLI's families needing more than tokens are listed."""
    for name, cfg in ARCHS.items():
        ours, ref = api.build(cfg), japi.build(JARCHS[name])
        assert sorted(ours.extra) == sorted(ref.extra), name
    assert api.build(get_config("whisper-medium")).extra["prefill_cache"] is encdec.prefill_cache
    assert api.build(get_config("qwen2-vl-2b")).extra["make_mrope_positions"] is \
        vlm.make_mrope_positions
    assert api.build(get_config("deepseek-v3-671b")).extra["moe_ffn"] is moe.moe_ffn
    from repro_torch.launch.train import NEEDS

    assert NEEDS == {"encdec": "audio_embeds", "vlm": "image_embeds"}


# ---------------------------------------------------------------------------
# loss, gradients, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_train_loss_and_gradients_match_the_reference(arch):
    """Each reduced arch's loss and gradient over two nodes (the port's
    `ModelApi.grad_fn`) against the reference's jitted ``value_and_grad``
    per node; MoE with its aux loss (and v3's MTP term), the VLM with its
    image prefix masked, whisper through its encoder."""
    m = model(arch)
    batch = make_batch(m["tc"], lead=(2,))
    stacked = {k: torch.stack([v, v * 1.01]) for k, v in m["tp"].items()}
    losses, grads = m["ta"].grad_fn()(stacked, {k: t(v) for k, v in batch.items()})
    grad = jax.jit(m["ja"].grad_fn())
    for node in range(2):
        jp = convert.unflatten_tree({k: j(v[node].numpy()) for k, v in stacked.items()},
                                    api.none_subtrees(m["tc"]))
        jl, jg = grad(jp, {k: j(v[node]) for k, v in batch.items()})
        np.testing.assert_allclose(float(losses[node]), float(jl), rtol=LOSS_RTOL)
        for k, g in convert.flatten_tree(jg).items():
            if k == "embed":
                # a row sums its token's uses, a few with cancellation down
                # to 1e-3 of the leaf's largest: held to the leaf's scale
                bounded(grads[k][node], g, EMBED_GRAD_BOUND)
            else:
                close(grads[k][node], g, GRAD_RTOL, GRAD_ATOL)


def ref_cache(cache):
    """The port's cache as the reference's tree (None subtrees kept)."""
    return jax.tree_util.tree_map(lambda v: j(v.numpy()), cache)


def prefilled(m, audio=None):
    """Both packages' fresh caches for 2 rows and ``S`` steps (whisper's
    cross caches filled from ``audio``)."""
    tc, jc = m["tc"], m["jc"]
    tcache = m["ta"].init_cache(tc, B, S, device="cpu")
    jcache = m["ja"].init_cache(jc, B, S)
    if tc.family == "encdec":
        tcache = m["ta"].extra["prefill_cache"](m["tp"], tcache, t(audio), tc)
        jcache = m["ja"].extra["prefill_cache"](m["jp"], jcache, j(audio), jc)
    return tcache, jcache


@pytest.mark.parametrize("arch", ZOO)
def test_decode_steps_match_the_reference(arch):
    """Four `decode_step`s from a fresh cache (whisper's prefilled from the
    same audio): each step's logits against the reference's, and the final
    cache's leaves."""
    m = model(arch)
    batch = make_batch(m["tc"])
    tcache, jcache = prefilled(m, batch.get("audio_embeds"))
    step = jax.jit(lambda p, c, x: m["ja"].decode_step(p, c, x, m["jc"]))  # as its serve jits
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        tl, tcache = m["ta"].decode_step(m["tp"], tcache, t(tok), m["tc"])
        jl, jcache = step(m["jp"], jcache, j(tok))
        assert tl.shape == (B, 1, m["tc"].vocab_size)
        bounded(tl, jl)
    assert jax.tree_util.tree_structure(ref_cache(tcache)) == \
        jax.tree_util.tree_structure(jcache)
    for a, b in zip(jax.tree_util.tree_leaves(ref_cache(tcache)),
                    jax.tree_util.tree_leaves(jcache), strict=True):
        bounded(a, b)
    assert int(tcache["pos"]) == 4


CONSISTENCY = ("rwkv6-3b", "zamba2-1.2b", "zamba2-rem", "deepseek-v2-236b", "deepseek-v3-671b",
               "whisper-medium", "qwen2-vl-2b")


@pytest.mark.parametrize("arch", CONSISTENCY)
def test_prefill_decode_consistency(arch):
    """The port's step-by-step decode over 12 tokens against its own
    forward over them (the reference's slow check, port side): MoE at
    ``capacity_factor`` 8 (no token dropped), whisper against
    ``decode_train`` over the encoder's output, the VLM against the dense
    backbone's forward with text positions (t = h = w)."""
    kw = {"capacity_factor": 8.0} if arch.startswith("deepseek") else {}
    _, cfg = configs(arch, **kw)
    a = api.build(cfg)
    params = a.init_params(prng.PRNGKey(1), cfg, device="cpu")
    rng = np.random.default_rng(5)
    n = 12
    toks = t(rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32))
    cache = a.init_cache(cfg, B, n, device="cpu")
    if cfg.family == "encdec":
        audio = t(rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32))
        cache = encdec.prefill_cache(params, cache, audio, cfg)
        full = encdec.decode_train(params, encdec.encode(params, audio, cfg), toks, cfg)
    elif cfg.family == "moe":
        full = moe.forward(params, toks, cfg)[0]
    elif cfg.family == "vlm":
        pos3 = torch.arange(n, dtype=torch.int32)[None, None].expand(3, B, n)
        full = vlm.dense.forward(params, toks, cfg, mrope_positions=pos3)
    else:
        full = {"rwkv": ssm.forward, "hybrid": hybrid.forward}[cfg.family](params, toks, cfg)
    outs = []
    for i in range(n):
        lg, cache = a.decode_step(params, cache, toks[:, i:i + 1], cfg)
        outs.append(lg[:, 0])
    bounded(torch.stack(outs, 1), full)


def test_hybrid_ring_buffer_past_its_window():
    """zamba2 with a window of 8 decoded 12 steps: past the window the ring
    holds keys out of order, only the count masks them; every step's logits
    and the final ring against the reference's."""
    jc, tc = configs("zamba2-1.2b", sliding_window=8)
    key = jax.random.PRNGKey(6)
    jp = japi.build(jc).init_params(key, jc)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tcache = hybrid.init_cache(tc, B, 32, device="cpu")
    jcache = japi.build(jc).init_cache(jc, B, 32)
    assert tcache["attn_k"].shape[2] == jcache["attn_k"].shape[2] == 8
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (B, 12)).astype(np.int32)
    step = jax.jit(lambda p, c, x: japi.build(jc).decode_step(p, c, x, jc))
    for i in range(12):
        tl, tcache = hybrid.decode_step(tp, tcache, t(toks[:, i:i + 1]), tc)
        jl, jcache = step(jp, jcache, j(toks[:, i:i + 1]))
        bounded(tl, jl)
    bounded(tcache["attn_k"], jcache["attn_k"])
    assert int(tcache["pos"]) == 12


# ---------------------------------------------------------------------------
# the MoE dispatch and combine, RWKV's chunk
# ---------------------------------------------------------------------------


def ref_dispatch(gate_idx, cap, e, k):
    """The reference's dispatch (`repro.models.moe.moe_ffn`'s lines) in
    jnp: each choice's slot, kept flag and each slot's token."""
    t_ = gate_idx.shape[0]
    flat_e = gate_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    lin = jnp.arange(t_ * k)
    is_new = jnp.concatenate([jnp.ones((1,), bool), sorted_e[1:] != sorted_e[:-1]])
    seg_start = jax.lax.cummax(jnp.where(is_new, lin, 0))
    rank = jnp.zeros((t_ * k,), jnp.int32).at[order].set((lin - seg_start).astype(jnp.int32))
    keep = rank < cap
    slot = jnp.where(keep, flat_e * cap + rank, e * cap)
    slot_tok = jnp.full((e * cap + 1,), t_, jnp.int32).at[slot].set(
        (lin // k).astype(jnp.int32))[: e * cap]
    return slot, keep, slot_tok


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_dispatch_and_combine(cf):
    """At a capacity that drops choices (0.5) and one that drops none (8):
    the top-k, slots, kept flags and slot tokens equal the reference's; the
    combine equals the reference's ``zeros.at[slot_tok].add(contrib)`` bit
    for bit over the same contributions; ``moe_ffn`` and its aux loss
    within 1e-5 of the reference's."""
    from repro.models import moe as jmoe

    jc, tc = configs("deepseek-v2-236b", capacity_factor=cf)
    jp = jmoe.init_moe_ffn(jax.random.PRNGKey(1), jc)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(2).normal(size=(B, S, jc.d_model)).astype(np.float32)
    tokens = B * S
    cap = moe._capacity(tokens, tc)
    assert cap == jmoe._capacity(tokens, jc)
    logits = x.reshape(tokens, -1) @ np.asarray(jp["router"])
    _, tg, ti = moe.route_topk(t(logits), tc)
    _, jg, ji = jmoe.route_topk(j(logits), jc)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg, 1e-6, 0)
    slot, keep, slot_tok = moe.dispatch(ti, cap, tc)
    jslot, jkeep, jslot_tok = ref_dispatch(ji, cap, jc.num_experts, jc.top_k)
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert np.array_equal(slot_tok.numpy(), np.asarray(jslot_tok))
    if cf < 1:
        assert not bool(keep.all())
    contrib = np.random.default_rng(3).normal(size=(jc.num_experts * cap, jc.d_model)).astype(
        np.float32) * (slot_tok.numpy() < tokens)[:, None]
    ours = moe.combine(t(contrib), slot, keep, tokens)
    ref = jax.jit(lambda c, st: jnp.zeros((tokens + 1, jc.d_model), jnp.float32).at[st].add(c))(
        j(contrib), jslot_tok)[:tokens]
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    to, ta = moe.moe_ffn(tp, t(x), tc)
    jo, ja = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, jc))(jp, j(x))
    bounded(to, jo, 1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_ties_go_to_the_lower_expert():
    """Equal router probabilities: the stable descending sort picks the
    lower expert index, as ``lax.top_k`` does."""
    from repro.models import moe as jmoe

    jc, tc = configs("deepseek-v2-236b")
    logits = np.zeros((3, tc.num_experts), np.float32)
    logits[1, 2:] = 1.0
    _, _, ti = moe.route_topk(t(logits), tc)
    _, _, ji = jmoe.route_topk(j(logits), jc)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti.tolist() == [[0, 1], [2, 3], [0, 1]]


def test_wkv6_at_chunk_128_over_256_steps():
    """``wkv6_chunked`` at the blocks' chunk of 128 over 256 steps, ``w_log``
    in [-0.5, -1e-6] (``|cum|`` up to 64): finite and within 1e-5 of the
    reference's largest output."""
    from repro.models import ssm as jssm

    rng = np.random.default_rng(3)
    b, s, d, nh = 2, 256, 64, 4
    r, k, v = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(-0.5, -1e-6, size=(b, s, d)).astype(np.float32)
    bonus = (rng.normal(size=(nh, d // nh)) * 0.1).astype(np.float32)
    ours = ssm.wkv6_chunked(*(t(a) for a in (r, k, v, w)), t(bonus), nh, chunk=128)
    ref = jssm.wkv6_chunked(*(j(a) for a in (r, k, v, w)), j(bonus), nh, chunk=128)
    assert bool(torch.isfinite(ours).all())
    bounded(ours, ref, 1e-5)
    with pytest.raises(ValueError, match="multiple of its chunk"):
        ssm.wkv6_chunked(*(t(a[:, :200]) for a in (r, k, v, w)), t(bonus), nh, chunk=128)


# ---------------------------------------------------------------------------
# the interchange of trees with None subtrees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,none", [
    ("deepseek-v2-236b", {"first_dense_layers": 0}, "dense_blocks"),
    ("zamba2-1.2b", {}, "mamba_rem"),
])
def test_none_subtrees_cross_both_ways(arch, kw, none):
    """A reference tree with a ``None`` subtree crosses `params_from_jax`
    (no entry) and `params_to_jax(params, cfg)` back to an equal tree, the
    ``None`` in its place."""
    jc, tc = configs(arch, **kw)
    tree = jax.tree_util.tree_map(np.asarray, japi.build(jc).init_params(
        jax.random.PRNGKey(2), jc))
    assert tree[none] is None
    params = convert.params_from_jax(tree, device="cpu")
    assert not any(k.startswith(none) for k in params)
    back = convert.params_to_jax(params, tc)
    assert back[none] is None
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree),
                    strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(params) == sorted(api.build(tc).param_shapes(tc))
    with pytest.raises(ValueError, match="None subtree"):
        convert.unflatten_tree({f"{none}/x": 1}, (none,))


def test_moe_checkpoint_crosses_between_the_packages(tmp_path):
    """A reference plain-path `BridgeState` of a reduced MoE (no dense
    layers, so ``dense_blocks`` is None; M = 3) resumes in the port through
    `convert.state_from_checkpoint`, every leaf equal; the port's file
    restores in the reference."""
    from repro import checkpoint as jckpt
    from repro.core import BridgeConfig as JConfig
    from repro.core import BridgeTrainer as JTrainer
    from repro.core import erdos_renyi as jerdos_renyi
    from repro_torch import checkpoint
    from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate

    jc, tc = configs("deepseek-v2-236b", first_dense_layers=0)
    one = convert.params_to_jax(api.build(tc).init_params(prng.PRNGKey(4), tc, device="cpu"), tc)
    rng = np.random.default_rng(4)  # three distinct nodes
    jp = jax.tree_util.tree_map(lambda x: j(x[None] + 0.01 * rng.normal(size=(3, *x.shape)).astype(
        x.dtype)), one)
    jstate = JTrainer(JConfig(topology=jerdos_renyi(3, 1.0, 0, seed=0)),
                      japi.build(jc).grad_fn()).init(jp, seed=9)
    jstate = jstate._replace(t=jnp.asarray(5, jnp.int32))
    jckpt.save(str(tmp_path / "ref"), 5, jstate)
    tt = BridgeTrainer(BridgeConfig(topology=erdos_renyi(3, 1.0, 0, seed=0)),
                       api.build(tc).grad_fn(), device="cpu")
    fresh = tt.init(replicate(api.build(tc).init_params(prng.PRNGKey(0), tc, device="cpu"), 3),
                    seed=0)
    via = convert.state_from_checkpoint(str(tmp_path / "ref"), fresh)
    assert via.t == 5 and np.array_equal(via.key, np.asarray(jstate.key))
    ref = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert sorted(via.params) == sorted(ref)
    for k, v in ref.items():
        assert np.array_equal(via.params[k].numpy(), v), k
    checkpoint.save(str(tmp_path / "port"), 6, via)
    restored, step = jckpt.restore(str(tmp_path / "port"), tuple(jstate))
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert restored[0]["dense_blocks"] is None


# ---------------------------------------------------------------------------
# serving and the training CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b", "whisper-medium"])
def test_serve_matches_the_references_tokens(arch, capsys):
    """``python -m repro_torch.examples.serve --device cpu --tokens 4`` at
    its reduced defaults: the reference script's greedy tokens (its loop,
    jitted, in-process), one decode time a token, the reference's two
    lines."""
    from repro_torch.examples import serve

    gen = serve.main(["--arch", arch, "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} decoded 4 tokens x batch 4 (") and "on CPU" in out[0]
    assert out[1] == f"sample token ids: {gen.ids[0].tolist()}"
    assert gen.finite and len(gen.step_s) == 4 and gen.ids.shape == (4, 4)
    cfg = jget(arch).reduced()
    ja = japi.build(cfg)
    params = ja.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    cache = ja.init_cache(cfg, 4, 36)
    step = jax.jit(lambda p, c, x: ja.decode_step(p, c, x, cfg))
    if cfg.family == "encdec":
        audio = jnp.asarray(rng.normal(size=(4, 32, cfg.d_model)), jnp.float32)
        cache = ja.extra["prefill_cache"](params, cache, audio, cfg)
        tok = jnp.full((4, 1), 1, jnp.int32)
    else:
        prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)), jnp.int32)
        for i in range(32):
            logits, cache = step(params, cache, prompt[:, i:i + 1])
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = []
    for _ in range(4):
        logits, cache = step(params, cache, tok)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok)[:, 0])
    assert np.array_equal(gen.ids, np.stack(want, axis=1))


def test_launch_train_new_families_and_refusals():
    """``launch.train --device cpu --reduce``: zamba2 trains 2 steps with a
    finite loss; whisper and qwen2-vl are refused before the first step,
    the error naming the inputs the token pipeline lacks."""
    from repro_torch.launch import train

    state, loss = train.main("--arch zamba2-1.2b --reduce --steps 2 --batch 1 --seq 16 "
                             "--nodes 4 --log-every 1 --device cpu".split())
    assert np.isfinite(loss) and state.t == 2
    for arch, need in (("whisper-medium", "audio_embeds"), ("qwen2-vl-2b", "image_embeds")):
        with pytest.raises(ValueError, match=need):
            train.main(f"--arch {arch} --reduce --steps 1 --device cpu".split())
