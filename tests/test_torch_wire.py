"""The port's wire tier — `repro_torch.prng.randint`, the codeword attacks
of `repro_torch.core.byzantine` and the trainer's wire stage
(`BridgeTrainer._wire_roundtrip`) — against the reference on the CPU.

Tolerances, stated per comparison:
* ``randint``: bit for bit with ``jax.random.randint`` (int32 draws);
* each wire attack on a `WireMsg`: payload, scale and indices bit for bit
  with the reference's attack on the reference's codeword (the codewords
  themselves are bit for bit, ``test_torch_comm.py``);
* one trainer step from the reference's carried state, for each codec x
  wire attack pair the card's smoke test runs and a few more: the
  convention of ``test_torch_bridge.py`` (rtol 1e-5, atol 1e-6 on honest
  nodes, the codec carry exact on every row, honest rows under
  ``random``).  Under ``random`` the port is handed the reference's normal
  draws: with int4 and top-k codecs a Byzantine sender's decoded value can
  land among the honest ones and survive the trim, and it would carry
  normal's relative 5.8e-6 (``test_torch_prng.py``) into honest rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codec as jcodec
from repro.core import byzantine as jbyz
from repro_torch import prng
from repro_torch.comm import codec, exchange
from repro_torch.core import byzantine
from test_torch_bridge import M, check_one_step, jtask, port_trainer  # noqa: F401 (fixture)


@pytest.mark.parametrize("lo,hi", [(-128, 128), (0, 7850), (0, 300), (0, 1), (5, 3),
                                   (-(2 ** 31), 2 ** 31 - 1), (-7, 1_000_003)])
@pytest.mark.parametrize("seed", [0, 11])
def test_randint_matches_jax(seed, lo, hi):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x77697230)
    shape = (13, 257)
    want = np.asarray(jax.random.randint(key, shape, lo, hi, jnp.int32))
    got = prng.randint(np.asarray(key), shape, lo, hi, torch.int32, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_other_draws():
    key = prng.PRNGKey(0)
    with pytest.raises(TypeError):
        prng.randint(key, (3,), 0, 5, torch.int8, "cpu")
    with pytest.raises(ValueError):
        prng.randint(key, (3,), 0, 2 ** 31, torch.int32, "cpu")
    assert prng.randint(key, (4, 0), -128, 128, torch.int32, "cpu").shape == (4, 0)


def codewords(name: str, m: int = 9, d: int = 300, seed: int = 0):
    """The reference's and the port's codeword of one seeded bank."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 10.0 ** rng.uniform(-2, 1, size=(m, 1))).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    jmsg = jax.jit(jcodec.get_codec(name).encode)(key, jnp.asarray(x))
    msg = codec.get_codec(name).encode(np.asarray(key), torch.from_numpy(x))
    return jmsg, msg


def assert_msg_equal(msg, jmsg):
    for field in ("payload", "scale", "idx"):
        got, want = getattr(msg, field).numpy(), np.asarray(getattr(jmsg, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", ["identity", "int8", "int4", "topk25", "topk50_int8",
                                  "randk25_int4"])
@pytest.mark.parametrize("attack", ["none", "garbage_codeword", "scale_abuse", "index_lie"])
def test_wire_attack_on_codeword_bitwise(attack, name):
    jmsg, msg = codewords(name, seed=len(name))
    assert_msg_equal(msg, jmsg)
    byz_np = np.zeros(9, bool)
    byz_np[[1, 4, 7]] = True
    key, t, d = jax.random.PRNGKey(3), 17, 300
    want = jbyz.WIRE_ATTACKS[attack](jmsg, jnp.asarray(byz_np), key, t, d)
    got = byzantine.wire_attack_for(attack)(msg, torch.from_numpy(byz_np), np.asarray(key), t, d)
    assert_msg_equal(got, want)
    # honest senders' fields are never touched
    for field in ("payload", "scale", "idx"):
        assert torch.equal(getattr(got, field)[~torch.from_numpy(byz_np)],
                           getattr(msg, field)[~torch.from_numpy(byz_np)])


def test_garbage_codeword_draws_nonfinite_floats_and_full_int8_range():
    """Under the identity codec the bytes bitcast to arbitrary float32
    patterns, NaN and huge values included (inf is 2 patterns in 2**32);
    quantized codes cover -128..127, which
    no honest encoder writes."""
    _, msg = codewords("identity", m=16, d=1000)
    byz = torch.ones(16, dtype=torch.bool)
    got = byzantine.wire_attack_for("garbage_codeword")(msg, byz, prng.PRNGKey(1), 0, 1000)
    vals = codec.get_codec("identity").decode(got, 1000)
    assert torch.isnan(vals).any() and bool((vals.abs() > 1e30).any())
    _, msg8 = codewords("int8", m=16, d=1000)
    codes = byzantine.wire_attack_for("garbage_codeword")(msg8, byz, prng.PRNGKey(1), 0, 1000).payload
    assert int(codes.min()) == -128 and int(codes.max()) == 127


def test_attack_tiers():
    for name in ("garbage_codeword", "scale_abuse", "index_lie"):
        assert byzantine.get_attack(name).name == "none"
        assert byzantine.wire_attack_for(name).name == name
    for name in ("none", "random", "sign_flip", "alie"):
        assert byzantine.wire_attack_for(name).name == "none"
    assert set(byzantine.WIRE_ATTACKS) == set(jbyz.WIRE_ATTACKS)
    assert byzantine.SCALE_ABUSE_FACTOR == 1e4
    with pytest.raises(ValueError, match="index_lie"):
        byzantine.get_attack("no_such_attack")


def test_randk_decode_ignores_forged_indices():
    """randk ships no indices: its decoder re-derives them from the key, so
    an index lie changes nothing, as in the reference."""
    c = codec.get_codec("randk25_int8")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 300)).astype(np.float32))
    key = prng.PRNGKey(4)
    msg = c.encode(key, x)
    lied = byzantine.wire_attack_for("index_lie")(msg, torch.ones(5, dtype=torch.bool), key, 0, 300)
    assert not torch.equal(lied.idx, msg.idx)
    assert torch.equal(c.decode(lied, 300, key), c.decode(msg, 300, key))


# the codec x wire attack pairs `chip_smoke.py` trains, and more
WIRE_PAIRS = [
    ("int8", "scale_abuse", False), ("int8", "garbage_codeword", False),
    ("identity", "garbage_codeword", False), ("int4", "random", False),
    ("topk50_int8", "random", False), ("int8", "scale_abuse", True),
    ("topk25", "index_lie", False), ("topk50_int8", "garbage_codeword", True),
    ("randk25_int4", "index_lie", False),
]


def reference_normal(key, shape, device):
    """``jax.random.normal`` itself, in place of the port's draw."""
    out = np.asarray(jax.random.normal(jnp.asarray(key, jnp.uint32), tuple(shape)))
    return torch.from_numpy(out.copy()).to(device)


@pytest.mark.parametrize("codec_name,attack,sparse", WIRE_PAIRS)
def test_one_step_parity_wire(jtask, monkeypatch, codec_name, attack, sparse):  # noqa: F811
    if attack == "random":
        monkeypatch.setattr(prng, "normal", reference_normal)
    check_one_step(jtask, "trimmed_mean", attack, 2, sparse=sparse, codec=codec_name)


@pytest.mark.parametrize("rule,codec,attack", [("median", "int8", "garbage_codeword"),
                                               ("krum", "int4", "scale_abuse")])
def test_one_step_parity_wire_other_rules(jtask, rule, codec, attack):  # noqa: F811 (fixture)
    check_one_step(jtask, rule, attack, 3, codec=codec)


def test_wire_stage_skipped_only_when_nothing_can_alter_the_payload():
    """The identity codec skips the wire under a broadcast attack (the
    uncompressed trainer, structurally), and runs it under a wire attack,
    whose garbage then reaches screening as inf and NaN."""
    t = port_trainer("trimmed_mean", "sign_flip")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(M, 30)).astype(np.float32))
    out, comm = t._wire_roundtrip(prng.PRNGKey(0), x, None, 0)
    assert out is x and comm is None
    t = port_trainer("trimmed_mean", "garbage_codeword")
    out, comm = t._wire_roundtrip(prng.PRNGKey(0), x, None, 0)
    assert comm is None
    byz = t.byz_mask
    assert torch.equal(out[~byz], x[~byz])
    assert not torch.equal(out[byz], x[byz])
    t8 = port_trainer("trimmed_mean", "scale_abuse", codec="int8")
    state = exchange.init_residual(tuple(x.shape), t8.codec, device="cpu")
    out, comm = t8._wire_roundtrip(prng.PRNGKey(0), x, state, 0)
    ratio = (out[t8.byz_mask].abs().amax(dim=1) / x[t8.byz_mask].abs().amax(dim=1))
    assert bool((ratio > 1e3).all())
