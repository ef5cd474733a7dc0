"""The chunk-streaming trainer in the port (`repro_torch.stream`) on the CPU,
against the port's flat trainer and the reference's `repro.stream`.

Tolerances, and why:

* `BlockSpec`: exact (host integers);
* a single block against the flat `BridgeTrainer`: bit for bit for every
  attack and codec, stochastic ones included (the block's key is the
  step's subkey);
* many blocks, deterministic attacks and codecs: bit for bit at any chunk
  width (the coordinate-wise rules decompose over blocks, and ``alie``'s
  and ``shift``'s honest statistics add the nodes in one order at every
  width, `repro_torch.core.byzantine.node_sum`), trust's feedback within
  2e-5 (the reference's bound);
* the ideal channel against the broadcast: bit for bit;
* against the reference's `StreamBridgeTrainer` on the same inputs
  (deterministic attacks, the int8 codec's uniform draws and the
  channel's are the reference's streams): parameters within rtol 1e-6,
  the channel's statistics exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BridgeConfig as JConfig
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.stream import StreamBridgeTrainer as JStream
from repro.stream import StreamChannelConfig as JChannel
from repro.trust import TrustSpec as JTrustSpec
from repro_torch import convert, prng
from repro_torch.core import (BridgeConfig, BridgeTrainer, byzantine, erdos_renyi, replicate,
                              screening)
from repro_torch.core.bridge import stack_flatten
from repro_torch.net.mailbox import BlockMailboxState
from repro_torch.obs import MetricSpec, TraceSpec
from repro_torch.obs.trace import BLOCK_TRIM_STREAM
from repro_torch.stream import BlockSpec, StreamBridgeTrainer, StreamChannelConfig
from repro_torch.trust import TrustSpec

M, B = 8, 1
TOPO = erdos_renyi(M, 0.9, B, seed=1)


def params_single(d=24):
    return replicate({"w": prng.normal(prng.PRNGKey(0), (d,), "cpu")}, M, perturb=0.1,
                     key=prng.PRNGKey(1))


def params_multi():
    """Three leaves, mixed bf16 / f32, sizes no small chunk divides."""
    return replicate({"emb": prng.normal(prng.PRNGKey(0), (5, 3), "cpu"),
                      "w": prng.normal(prng.PRNGKey(2), (7,), "cpu").to(torch.bfloat16),
                      "b": prng.normal(prng.PRNGKey(3), (), "cpu")},
                     M, perturb=0.1, key=prng.PRNGKey(1))


def targets_of(params):
    return {k: prng.normal(prng.PRNGKey(9), v.shape, "cpu").to(v.dtype)
            for k, v in params.items()}


def qgrad(params, batch):
    """0.5 |p - target|^2 over every leaf, per node; grads in each leaf's
    dtype."""
    diffs = {k: params[k].to(torch.float32) - batch[k].to(torch.float32) for k in params}
    loss = sum(0.5 * torch.sum((v * v).reshape(v.shape[0], -1), dim=-1)
               for v in diffs.values())
    return loss, {k: v.to(params[k].dtype) for k, v in diffs.items()}


def run(trainer, params, batch, steps=4):
    state = trainer.init(params, seed=0)
    metrics = None
    for _ in range(steps):
        state, metrics = trainer.step(state, batch)
    return state, metrics


def bitwise(a, b) -> bool:
    return all(torch.equal(torch.nan_to_num(a[k].float()), torch.nan_to_num(b[k].float()))
               for k in a)


def flat_vs_stream(params, steps=4, channel=None, flat_chunk=None, **kw):
    kw.setdefault("lr", 0.05)
    kw.setdefault("num_byzantine", B)
    cfg = BridgeConfig(topology=TOPO, **kw)
    fcfg = cfg if flat_chunk is None else dataclasses.replace(cfg, screen_chunk=flat_chunk)
    batch = targets_of(params)
    fs, fm = run(BridgeTrainer(fcfg, qgrad, device="cpu"), params, batch, steps)
    ss, sm = run(StreamBridgeTrainer(cfg, qgrad, channel=channel, device="cpu"), params, batch,
                 steps)
    return fs, ss, fm, sm


# ---------------------------------------------------------------------------
# BlockSpec
# ---------------------------------------------------------------------------


def test_blockspec_partition_covers_stack_flatten_order():
    params = params_multi()
    spec = BlockSpec.from_params(params, 4)
    sizes = spec.block_sizes()
    assert sum(sizes) == spec.total_dim == 1 + 15 + 7
    assert len(sizes) == spec.num_blocks and max(sizes) == spec.max_block <= 4
    assert [p.key for p in spec.leaves] == ["b", "emb", "w"]
    assert [p.offset for p in spec.leaves] == [0, 1, 16]
    for p in spec.leaves:
        assert p.num_full * min(spec.chunk, p.size) + p.tail == p.size
    # the blocks in order are stack_flatten's columns
    flat, _ = stack_flatten(params)
    mats = spec.leaf_mats(params)
    cols = torch.cat([mats[li][:, s:s + c].float() for li, p in enumerate(spec.leaves)
                      for _, s, c in p.blocks(spec.chunk)], dim=1)
    assert torch.equal(cols, flat)
    back = spec.unflatten(mats)
    assert all(back[k].dtype == params[k].dtype and torch.equal(back[k], params[k])
               for k in params)


def test_blockspec_chunk_none_is_per_leaf_and_rejections():
    spec = BlockSpec.from_params(params_multi(), None)
    assert spec.num_blocks == len(spec.leaves)
    assert all(p.num_full == 1 and p.tail == 0 for p in spec.leaves)
    with pytest.raises(ValueError, match="non-float"):
        BlockSpec.from_params({"w": torch.zeros((M, 4), dtype=torch.int32)}, 4)
    with pytest.raises(ValueError, match="not coordinate-decomposable"):
        screening.check_streamable(("trimmed_mean", "krum"))
    for rule in ("geomedian", "clipped_mean", "krum"):
        with pytest.raises(ValueError, match="not coordinate-decomposable"):
            StreamBridgeTrainer(BridgeConfig(topology=erdos_renyi(M, 1.0, B, seed=1),
                                             rule=rule, num_byzantine=B), qgrad, device="cpu")
    with pytest.raises(NotImplementedError):
        StreamBridgeTrainer(BridgeConfig(topology=TOPO, num_byzantine=B, adversary="ipm"),
                            qgrad, device="cpu")
    with pytest.raises(ValueError, match="echo"):
        StreamBridgeTrainer(BridgeConfig(topology=TOPO, rule="rep_trimmed_mean",
                                         num_byzantine=B, trust=TrustSpec(echo=True)),
                            qgrad, channel=StreamChannelConfig(), device="cpu")
    assert screening.STREAMABLE_RULES <= set(screening.RULES)
    assert set(screening.RULES) - screening.STREAMABLE_RULES == {"krum", "bulyan", "geomedian",
                                                                  "clipped_mean"}


# ---------------------------------------------------------------------------
# against the flat trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attack", ["none", "random", "sign_flip", "alie", "same_value",
                                    "shift", "scale_abuse", "garbage_codeword"])
def test_single_block_bitwise_all_attacks(attack):
    codec = "int8" if attack in ("scale_abuse",) else "identity"
    fs, ss, fm, sm = flat_vs_stream(params_single(), attack=attack, codec=codec)
    assert bitwise(fs.params, ss.params)
    assert torch.equal(fm["loss"], sm["loss"])


@pytest.mark.parametrize("codec", ["identity", "int8", "int4", "topk50", "randk25"])
def test_single_block_bitwise_all_codecs(codec):
    fs, ss, fm, sm = flat_vs_stream(params_single(), attack="random", codec=codec)
    assert bitwise(fs.params, ss.params)
    assert fm["wire_bits_per_edge"] == sm["wire_bits_per_edge"]
    if fs.comm is not None:
        assert torch.equal(fs.comm.resid, ss.comm[0].resid)


@pytest.mark.parametrize("rule", ["median", "mean", "rep_trimmed_mean", "rep_median"])
def test_single_block_bitwise_rules(rule):
    fs, ss, _, _ = flat_vs_stream(params_single(), attack="random", rule=rule)
    assert bitwise(fs.params, ss.params)


@pytest.mark.parametrize("attack", ["none", "sign_flip", "same_value", "alie", "shift"])
def test_multi_block_bitwise_deterministic_attacks(attack):
    fs, ss, _, _ = flat_vs_stream(params_multi(), attack=attack, screen_chunk=4)
    assert all(ss.params[k].dtype == v.dtype for k, v in params_multi().items())
    assert bitwise(fs.params, ss.params)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunk_width_invariance(chunk):
    fs, ss, _, _ = flat_vs_stream(params_multi(), attack="alie", rule="median",
                                  screen_chunk=chunk)
    assert bitwise(fs.params, ss.params)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_node_sum_is_width_invariant_and_the_reference_order(lead):
    """`byzantine.node_sum` over a block of columns is that block of the sum
    over every column, bit for bit, at any width; at the reference's sizes
    it is XLA's sum over the node axis bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(*lead, M, 64)).astype(np.float32)
    x[..., ::3, :] *= np.float32(1e-3)
    whole = byzantine.node_sum(torch.from_numpy(x))
    for c in (1, 5, 64):
        parts = [byzantine.node_sum(torch.from_numpy(np.ascontiguousarray(x[..., lo:lo + c])))
                 for lo in range(0, 64, c)]
        assert torch.equal(torch.cat(parts, dim=-1), whole)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-2))(jnp.asarray(x)))
    np.testing.assert_array_equal(whole.numpy(), want)


@pytest.mark.parametrize("params,chunk,attack", [(params_single, None, "random"),
                                                 (params_multi, 3, "sign_flip")])
def test_sparse_streaming_bitwise(params, chunk, attack):
    fs, ss, _, _ = flat_vs_stream(params(), attack=attack, rule="trimmed_mean", sparse=True,
                                  screen_chunk=chunk)
    assert bitwise(fs.params, ss.params)


def test_trust_single_block_bitwise_and_multi_block_close():
    fs, ss, fm, sm = flat_vs_stream(params_single(), attack="sign_flip",
                                    rule="rep_trimmed_mean", sparse=True,
                                    trust=TrustSpec(echo=False, warmup=1))
    assert bitwise(fs.params, ss.params)
    assert float(fm["trust_evicted_frac"]) == float(sm["trust_evicted_frac"])
    assert torch.equal(fs.trust.suspicion, ss.trust.suspicion)
    fs, ss, _, _ = flat_vs_stream(params_multi(), attack="sign_flip", rule="rep_trimmed_mean",
                                  sparse=True, trust=TrustSpec(echo=False, warmup=1),
                                  screen_chunk=4, flat_chunk=1 << 20)
    for k in fs.params:
        np.testing.assert_allclose(fs.params[k].float().numpy(), ss.params[k].float().numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_forensics_streams_and_emits_block_stream(sparse):
    params = params_multi()
    kw = dict(rule="trimmed_mean", num_byzantine=B, attack="sign_flip", lr=0.05,
              screen_chunk=4, sparse=sparse)
    tr = StreamBridgeTrainer(BridgeConfig(topology=TOPO, trace=TraceSpec(), **kw), qgrad,
                             device="cpu")
    state, metrics = run(tr, params, targets_of(params), steps=2)
    assert metrics[BLOCK_TRIM_STREAM].shape == (tr.spec.num_blocks,)
    assert "obs_trim_frac" in metrics and state.obs.edge_seen.shape[0] == M
    off, _ = run(StreamBridgeTrainer(BridgeConfig(topology=TOPO, **kw), qgrad, device="cpu"),
                 params, targets_of(params), steps=2)
    assert bitwise(state.params, off.params)
    # a single block: the trace's counters those of the flat trainer's trace
    fs, ss, fm, sm = flat_vs_stream(params_single(), attack="sign_flip", sparse=sparse,
                                    trace=TraceSpec())
    assert torch.equal(fs.obs.edge_trim, ss.obs.edge_trim)
    assert torch.equal(fm["obs_trim_frac"], sm["obs_trim_frac"])


def test_metrics_on_streams_bit_inert_and_run_chunks():
    params = params_multi()
    batch = targets_of(params)
    cfg = BridgeConfig(topology=TOPO, num_byzantine=B, attack="sign_flip", lr=0.05,
                       screen_chunk=4)
    off, _ = run(StreamBridgeTrainer(cfg, qgrad, device="cpu"), params, batch, steps=6)
    tr = StreamBridgeTrainer(dataclasses.replace(cfg, metrics=MetricSpec(capacity=4)), qgrad,
                             device="cpu")
    on, ms = tr.run_chunks(tr.init(params), lambda i: batch, 6)
    assert bitwise(off.params, on.params) and int(on.mets.count) == 6
    assert ms["grad_norm"].shape == (6,)


# ---------------------------------------------------------------------------
# the network path
# ---------------------------------------------------------------------------


def test_network_ideal_channel_matches_broadcast_and_mailbox_is_per_leaf():
    params = params_multi()
    cfg = BridgeConfig(topology=TOPO, rule="trimmed_mean", num_byzantine=B, attack="sign_flip",
                       lr=0.05, screen_chunk=4)
    batch = targets_of(params)
    sync, _ = run(StreamBridgeTrainer(cfg, qgrad, device="cpu"), params, batch)
    tr = StreamBridgeTrainer(cfg, qgrad, channel=StreamChannelConfig(drop_prob=0.0),
                             device="cpu")
    net, nm = run(tr, params, batch)
    assert bitwise(sync.params, net.params)
    assert float(nm["delivered_frac"]) == 1.0 and float(nm["screened_frac"]) == 1.0
    assert isinstance(net.net, BlockMailboxState)
    assert tuple(v.shape[-1] for v in net.net.values) == tuple(p.size for p in tr.spec.leaves)
    assert all(v.shape[:2] == (M, tr.neighbors.k) for v in net.net.values)


def test_network_drop_channel_trains_and_reports():
    params = params_multi()
    cfg = BridgeConfig(topology=TOPO, rule="trimmed_mean", num_byzantine=B, attack="sign_flip",
                       lr=0.05, screen_chunk=4, metrics=MetricSpec(capacity=8))
    ch = StreamChannelConfig(drop_prob=0.4, staleness_bound=2)
    state, m = run(StreamBridgeTrainer(cfg, qgrad, channel=ch, device="cpu"), params,
                   targets_of(params), steps=6)
    assert np.isfinite(float(m["loss"]))
    assert 0.0 < float(m["delivered_frac"]) < 1.0 and float(m["mean_staleness"]) >= 0.0
    assert all(torch.isfinite(v.float()).all() for v in state.params.values())
    assert np.isfinite(state.mets.buf[:6, 9].numpy()).all()  # stale_p50 filled


# ---------------------------------------------------------------------------
# against the reference's StreamBridgeTrainer
# ---------------------------------------------------------------------------


def jparams_multi():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    p0 = {"emb": jax.random.normal(k1, (5, 3), jnp.float32),
          "w": jax.random.normal(k2, (7,), jnp.bfloat16),
          "b": jax.random.normal(k3, ())}
    return jreplicate(p0, M, perturb=0.1, key=jax.random.PRNGKey(1))


def to_port(tree):
    return {k: torch.as_tensor(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in tree.items()}


def jgrad(p, batch):
    diffs = {k: p[k].astype(jnp.float32) - batch[k].astype(jnp.float32) for k in p}
    loss = sum(0.5 * jnp.sum(d * d) for d in diffs.values())
    return loss, {k: diffs[k].astype(p[k].dtype) for k in p}


@pytest.mark.parametrize("kw,channel", [
    (dict(attack="sign_flip", screen_chunk=4), None),
    (dict(attack="sign_flip", codec="int8", screen_chunk=4, sparse=True), None),
    (dict(attack="alie", rule="median", screen_chunk=None), None),
    (dict(attack="sign_flip", rule="rep_trimmed_mean", screen_chunk=4, sparse=True,
          trust=True), None),
    (dict(attack="sign_flip", screen_chunk=4), 0.3),
])
def test_stream_runs_match_the_reference(kw, channel):
    """Five ticks of the port's stream and the reference's on the same
    mixed bf16 / f32 replicas and targets."""
    jp = jparams_multi()
    jtg = {k: (jax.random.normal(jax.random.PRNGKey(9), v.shape[1:], jnp.float32)
               .astype(v.dtype)[None].repeat(M, 0)) for k, v in jp.items()}
    trust = kw.pop("trust", False)
    common = dict(num_byzantine=B, lr=0.05, **kw)
    jcfg = JConfig(topology=jerdos_renyi(M, 0.9, B, seed=1),
                   trust=JTrustSpec(echo=False, warmup=1) if trust else None, **common)
    cfg = BridgeConfig(topology=TOPO, trust=TrustSpec(echo=False, warmup=1) if trust else None,
                       **common)
    jtr = JStream(jcfg, jgrad, channel=None if channel is None else JChannel(drop_prob=channel))
    tr = StreamBridgeTrainer(cfg, qgrad, device="cpu",
                             channel=None if channel is None
                             else StreamChannelConfig(drop_prob=channel))
    jst, st = jtr.init(jp), tr.init(to_port(jp))
    batch = to_port(jtg)
    for _ in range(5):
        jst, jm = jtr.step(jst, jtg)
        st, m = tr.step(st, batch)
    for k in st.params:
        np.testing.assert_allclose(st.params[k].float().numpy(),
                                   np.asarray(jst.params[k], np.float32), rtol=1e-6, atol=1e-7)
    if channel is not None:
        for k in ("delivered_frac", "mean_staleness", "screened_frac"):
            assert float(m[k]) == float(jm[k]), k
        assert torch.equal(st.net.send_tick, torch.as_tensor(np.array(jst.net.send_tick)))
    # the reference's state carries over and the port continues from it
    if kw.get("codec") == "int8":
        comm = tuple((np.asarray(c.est), np.asarray(c.resid)) for c in jst.comm)
        back = convert.stream_state_from_jax({k: np.asarray(v, np.float32)
                                              for k, v in jst.params.items()}, 5,
                                             key=np.asarray(jst.key), comm=comm, device="cpu")
        assert torch.equal(back.comm[1].resid, st.comm[1].resid)
