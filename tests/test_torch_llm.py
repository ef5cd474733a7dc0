"""The training side of the model zoo in the port on the CPU: the token
pipeline (`repro_torch.data.tokens`), the optimizers and schedules
(`repro_torch.optim`), the checkpoint interchange
(`repro_torch.checkpoint`) and the two training entry points
(``python -m repro_torch.launch.train``, ``python -m
repro_torch.examples.train_llm``) with ``sweep --mode net``, against the
reference's computed in-process.

Tolerances, and why:

* token batches, checkpoint bytes and leaves, resumed states: exact;
* the schedules and the optimizer steps: rtol 1e-6 (XLA fuses the
  moments' multiply-adds and computes ``pow`` and ``cos`` its own way).
"""
import os
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import get_config as jget
from repro.core import BridgeConfig as JConfig
from repro.core import BridgeTrainer as JTrainer
from repro.core import erdos_renyi as jerdos_renyi
from repro.core import replicate as jreplicate
from repro.data.tokens import TokenPipeline as JPipe
from repro.data.tokens import synthetic_token_batch as jsynthetic
from repro.models import api as japi
from repro_torch import checkpoint, convert, optim, prng
from repro_torch.checkpoint import msgpack_ckpt as mc
from repro_torch.configs import get_config
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi
from repro_torch.data.tokens import TokenPipeline, device_batch, synthetic_token_batch
from repro_torch.models import api


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: these tests run many small ops beside
    the suite's other workers, where torch's thread pool oversubscribes the
    CPU (the reference's XLA pool is not affected)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def states_equal(a, b) -> bool:
    la, sa = mc.flatten(a)
    lb, sb = mc.flatten(b)
    if sa != sb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb, strict=True):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.dtype != y.dtype or not np.array_equal(x.reshape(-1).view(np.uint8),
                                                    y.reshape(-1).view(np.uint8)):
            return False
    return True


def test_token_pipeline_is_the_references():
    for args in ((512, 9, 2, 3, 0), (70000, 5, 1, 4, 7)):
        ours, ref = TokenPipeline(*args), JPipe(*args)
        for step in (0, 3):
            np.testing.assert_array_equal(ours.batch(step)["tokens"], ref.batch(step)["tokens"])
    np.testing.assert_array_equal(synthetic_token_batch(5000, (2, 7), seed=3),
                                  jsynthetic(5000, (2, 7), seed=3))
    dev = device_batch(TokenPipeline(512, 9, 2, 3).batch(1), torch.device("cpu"))
    assert dev["tokens"].dtype == torch.int32 and dev["tokens"].shape == (3, 2, 10)


def test_schedules_and_optimizer_steps():
    """The step-size schedules over ticks and three AdamW and momentum
    steps on a two-leaf dict, against the reference's under ``jax.jit``."""
    for ours, ref in ((optim.bridge_schedule(2.0, 30.0), joptim.bridge_schedule(2.0, 30.0)),
                      (optim.constant_schedule(0.03), joptim.constant_schedule(0.03)),
                      (optim.cosine_schedule(0.1, 50, 5), joptim.cosine_schedule(0.1, 50, 5))):
        for step in (0, 1, 4, 5, 17, 49, 60):
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = optim.adamw_init(tp), joptim.adamw_init(jp)
    tm, jm = optim.momentum_init(tp), joptim.momentum_init(jp)
    jadam = jax.jit(lambda p_, g_, s_: joptim.adamw_update(p_, g_, s_, lr=0.01,
                                                           weight_decay=0.1))
    jmom = jax.jit(lambda g_, s_: joptim.momentum_update(g_, s_, beta=0.8))
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        tp, ts = optim.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                                    lr=0.01, weight_decay=0.1)
        jp, js = jadam(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tm, _ = optim.momentum_update({k: torch.from_numpy(v) for k, v in g.items()}, tm,
                                      beta=0.8)
        jm, _ = jmom({k: jnp.asarray(v) for k, v in g.items()}, jm)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-6)
    assert int(ts.count) == int(js.count) == 3


def test_msgpack_subset_writes_msgpacks_bytes():
    """The port's encoder against ``msgpack.packb(use_bin_type=True)`` on
    every form the layout can hold (fix, 8-, 16- and 32-bit lengths,
    integers of every width, nil, bools); its decoder reads them back."""
    import io

    objs = [{"a": 1, "n": None, "t": True, "f": False},
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
             -32769, -(2 ** 31) - 1],
            {"s": "x" * 31, "s8": "y" * 200, "s16": "z" * 70000, "b": b"", "b8": b"\x01" * 255,
             "b16": b"\x02" * 256, "b32": b"\x03" * 70000},
            {str(i): list(range(i)) for i in range(20)}]
    for obj in objs:
        f = io.BytesIO()
        mc.pack(obj, f)
        assert f.getvalue() == msgpack.packb(obj, use_bin_type=True)
        back = mc.unpack(f.getvalue())
        assert back == msgpack.unpackb(f.getvalue(), raw=False)


@pytest.fixture(scope="module")
def plain_states():
    """The same plain-path state (a reduced qwen3, M = 3, identity codec)
    in both packages: the reference's trainer state and the port's."""
    jc, tc = jget("qwen3-4b").reduced(num_layers=2), get_config("qwen3-4b").reduced(num_layers=2)
    key = jax.random.PRNGKey(4)
    jp = jreplicate(japi.build(jc).init_params(key, jc), 3, perturb=0.01, key=key)
    jt = JTrainer(JConfig(topology=jerdos_renyi(3, 1.0, 0, seed=0)), japi.build(jc).grad_fn())
    jstate = jt.init(jp, seed=9)
    jstate = jstate._replace(t=jnp.asarray(5, jnp.int32))
    tt = BridgeTrainer(BridgeConfig(topology=erdos_renyi(3, 1.0, 0, seed=0)),
                       api.build(tc).grad_fn(), device="cpu")
    tstate = tt.init(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                             device="cpu"), seed=9)
    return jstate, tstate._replace(t=5), tt


def test_checkpoints_cross_between_the_packages(plain_states, tmp_path, monkeypatch):
    """The port's file restored by `repro.checkpoint` into the reference's
    template, and the reference's file restored by the port (through
    `convert.state_from_checkpoint` too), every leaf equal; the port works
    with ``msgpack`` unimportable, imports it nowhere, and refuses a file
    of another structure it wrote."""
    jstate, tstate, _ = plain_states
    monkeypatch.setitem(sys.modules, "msgpack", None)  # any import of it now fails
    path = checkpoint.save(str(tmp_path / "port"), 5, tstate)
    assert os.path.basename(path) == "step_00000005.msgpack"
    assert checkpoint.latest_step(str(tmp_path / "port")) == 5
    monkeypatch.setitem(sys.modules, "msgpack", msgpack)
    restored, step = jckpt.restore(str(tmp_path / "port"), tuple(jstate))
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    jckpt.save(str(tmp_path / "ref"), 7, jstate)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    back, step = checkpoint.restore(str(tmp_path / "ref"), tstate)
    assert step == 7 and states_equal(back, tstate)
    fresh = tstate._replace(t=0, key=prng.PRNGKey(0))
    via = convert.state_from_checkpoint(str(tmp_path / "ref"), fresh)
    assert states_equal(via, tstate) and isinstance(via.t, int)
    renamed = {("ln_g/w" if k == "ln_f/w" else k): v for k, v in tstate.params.items()}
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore(str(tmp_path / "port"), tstate._replace(params=renamed))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path / "ref"), (tstate.params, tstate.t))
    src = os.path.join(os.path.dirname(convert.__file__))
    for root, _, files in os.walk(src):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(root, name)).read()
                assert "import msgpack" not in text and "from msgpack" not in text, name


def test_nested_trees_cross_through_convert():
    tree = {"blocks": {"attn": {"wq": np.ones((2, 3)), "q_norm": {"w": np.zeros(2)}}},
            "embed": np.arange(4.0)}
    flat = convert.flatten_tree(tree)
    assert sorted(flat) == ["blocks/attn/q_norm/w", "blocks/attn/wq", "embed"]
    back = convert.unflatten_tree(flat)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    params = convert.params_from_jax(tree, device="cpu")
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), convert.params_to_jax(params), tree))
    with pytest.raises(ValueError, match="separator"):
        convert.flatten_tree({"a/b": 1})


LAUNCH = ("--arch qwen3-4b --reduce --nodes 5 --byzantine 1 --attack random --batch 1 "
          "--seq 8 --log-every 100 --device cpu --net --net-drop 0.3 --net-latency 2").split()


def test_launch_train_resumes_bit_for_bit(tmp_path):
    """``launch.train --device cpu`` through the lossy network runtime: 4
    steps with a checkpoint every 2, then, the step-4 file removed, a rerun
    resumed from step 2: the same state bit for bit (parameters,
    mailboxes, key, tick); the loss is finite.  Then a traced, trusting,
    metered run writes the reference's artifacts."""
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    args = LAUNCH + ["--steps", "4", "--ckpt", ck, "--ckpt-every", "2"]
    full, loss = train.main(args)
    os.remove(os.path.join(ck, "step_00000004.msgpack"))
    assert checkpoint.latest_step(ck) == 2
    res, _ = train.main(args)
    assert np.isfinite(loss) and full.t == 4 and states_equal(full, res)
    run = str(tmp_path / "run")
    _, loss = train.main(["--arch", "starcoder2-3b", "--reduce", "--nodes", "5", "--attack",
                          "sign_flip", "--steps", "2", "--batch", "1", "--seq", "8",
                          "--device", "cpu", "--trace", run, "--metrics", run,
                          "--metrics-capacity", "2", "--trust", "--sparse"])
    assert np.isfinite(loss)
    assert {"events.jsonl", "metrics.jsonl", "manifest.json",
            "obs_summary.json"} <= set(os.listdir(run))


def test_train_llm_small_resumes_bit_for_bit(tmp_path):
    """``train_llm --small`` (the stream trainer at chunk 65536, sign_flip):
    2 ticks with a checkpoint a tick, then, the tick-2 file removed,
    ``--resume`` from tick 1 to 2: bit for bit (flat against stream at this
    config is ``chip_smoke.py``'s phase 25(c); `tests/test_torch_stream.py`
    holds it at small widths)."""
    from repro_torch.examples import train_llm

    ck = str(tmp_path / "ck")
    args = ["--small", "--seq", "8", "--batch", "1", "--attack", "sign_flip", "--device", "cpu",
            "--ckpt", ck, "--steps", "2", "--ckpt-every", "1"]
    full, loss = train_llm.main(args)
    os.remove(os.path.join(ck, "step_00000002.msgpack"))
    res, _ = train_llm.main(args + ["--resume"])
    assert np.isfinite(loss) and full.t == res.t == 2 and states_equal(full, res)


def test_sweep_net_mode_runs_the_train_cli(tmp_path, monkeypatch):
    """``sweep --mode net``: two scenario jobs of 2 steps through ``python
    -m repro_torch.launch.train``, each recorded ok; a second sweep finds
    them cached."""
    from repro_torch.launch import sweep

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = ["--mode", "net", "--out", str(tmp_path), "--rules", "trimmed_mean", "--attacks",
            "alie", "--scenarios", "ideal,lossy", "--net-steps", "2", "--jobs", "2",
            "--device", "cpu"]
    done = sweep.main(args)
    assert [s.split()[0] for _, s in done] == ["ok", "ok"], done
    assert sorted(os.listdir(tmp_path)) == ["net_trimmed_mean_alie_ideal.json",
                                            "net_trimmed_mean_alie_lossy.json"]
    assert [s for _, s in sweep.main(args)] == ["cached", "cached"]
