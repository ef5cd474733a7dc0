"""The sharded path of the port (`repro_torch.launch.mesh`, `.sharding`,
`.steps`, `repro_torch.core.gossip`) on the CPU against the reference's
(`repro.launch`, `repro.core.gossip`).

The port runs on gloo ranks spawned with `torch.multiprocessing`
(`tests/torch_sharded_ranks.py`: one world of four ranks for every case,
then a world of one); the reference's multi-device outputs come from one
subprocess with ``--xla_force_host_platform_device_count=4``, as
`tests/test_sharded.py` runs it; its single-device ones in-process.  Both
read the same seeded numpy inputs; the train step's parameters are the
reference's ``init_params`` carried by `repro_torch.convert`.

Tolerances, and why:

* specs: equal to the reference's ``PartitionSpec`` as tuples;
* trimmed mean, median, mean: bit for bit (the same rows, the int8 codes
  the reference's, the screens its rules'), but the int8 all_gather's
  trimmed mean and its unattacked mean, within 4 ulp of the largest
  input: XLA fuses the reference's own decoded row into the last add
  (`_self_fma`);
* the ``random`` attack: rtol 5.8e-6, atol 2.2e-4 (`prng.normal` within a
  relative 5.8e-6, absolute 2.2e-5, of ``jax.random.normal``, times the
  attack's 10);
* Krum and Bulyan: the same picks, outputs within 1e-5 (the Gram matrix
  sums in another order);
* the train step: losses and parameters rtol 1e-5 (matmul order);
* the prefill and serve steps: logits and the decode cache within 2e-4 of
  their largest magnitude, the zoo's decode bound
  (`tests/test_torch_zoo.py`, the reference's own in `tests/test_models.py`).

Inputs named ``M<m>nan`` put a NaN in node ``2 % M``'s row: its int8
block's scale is NaN, so the decode of that block is NaN
in the reference, and the port's ``dequant`` must keep it NaN (its default
form maps NaN to +inf, which DGD's mean would carry).
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.core import gossip as jgossip
from repro.core import screening as jscreening
from repro.core.bridge import replicate as jreplicate
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh_compat as jmesh
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import api

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANDOM_RTOL, RANDOM_ATOL = 5.8e-6, 2.2e-4
VECTOR_ATOL = 1e-5
TRAIN_RTOL = 1e-5
DECODE_BOUND = 2e-4
KEY, TICK = 7, 3  # tests/torch_sharded_ranks.py's


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

MESHES = {  # name -> (shape, axes, node axes, M)
    "d4": ((4, 1), ("data", "model"), ("data",), 4),
    "d2m2": ((2, 2), ("data", "model"), ("data",), 2),
    "p2d2": ((2, 2, 1), ("pod", "data", "model"), ("pod", "data"), 4),
}
COORD = ("trimmed_mean", "median", "mean")


def _case(mesh: str, rule: str, schedule: str, attack: str, quantize: bool, data: str = "",
          **kw) -> dict:
    shape, axes, nax, m = MESHES[mesh] if mesh in MESHES else kw.pop("spec")
    return dict(name=f"{mesh}-{rule}-{schedule}-{attack}-{'int8' if quantize else 'f32'}{data}",
                kind="gossip", world=int(np.prod(shape)), mesh=list(shape), axes=list(axes),
                node_axes=list(nax), M=m, rule=rule, schedule=schedule, attack=attack,
                quantize=quantize, b=1, byz=[1 if m > 1 else 0], src=f"M{m}{data}", **kw)


def _cases() -> list:
    out = []
    for rule in COORD:
        for sched in ("all_gather", "all_to_all"):
            for attack, q in (("none", False), ("random", False), ("sign_flip", True)):
                out.append(_case("d4", rule, sched, attack, q))
            out.append(_case("d2m2", rule, sched, "none", False))
            out.append(_case("d2m2", rule, sched, "random", True))
    for rule in ("trimmed_mean", "median"):
        for sched in ("all_gather", "all_to_all"):
            out.append(_case("p2d2", rule, sched, "sign_flip", False))
            out.append(_case("p2d2", rule, sched, "random", True))
    out.append(_case("p2d2", "mean", "all_gather", "none", False))
    for mesh in MESHES:
        out.append(_case(mesh, "krum", "all_gather", "none", False))
    # a NaN payload: its int8 block decodes to NaN, as in the reference
    out += [_case("d4", rule, sched, "none", True, data="nan")
            for rule, sched in (("mean", "all_gather"), ("mean", "all_to_all"),
                                ("median", "all_gather"))]
    out += [_case("d4", "bulyan", "all_gather", "none", False),
            _case("d4", "bulyan", "all_to_all", "random", False),
            _case("d2m2", "bulyan", "all_gather", "random", False),
            _case("p2d2", "bulyan", "all_to_all", "sign_flip", False)]
    # where the reference fails: two nodes a rank
    two = ((2, 2), ("data", "model"), ("data",), 4)
    out += [_case("d2m2x2", "trimmed_mean", "all_to_all", "none", False, spec=two),
            _case("d2m2x2", "trimmed_mean", "all_gather", "none", True, spec=two)]
    # a world of one: M = 4 nodes on one rank, and the all_to_all's one legal shape, M = 1
    one4 = ((1, 1), ("data", "model"), ("data",), 4)
    one1 = ((1, 1), ("data", "model"), ("data",), 1)
    for rule in COORD:
        for attack, q in (("none", False), ("random", False), ("sign_flip", True)):
            out.append(_case("one4", rule, "all_gather", attack, q, spec=one4))
        for attack, q in (("none", False), ("random", True)):
            out.append(_case("one1", rule, "all_to_all", attack, q, spec=one1))
    out += [_case("one4", "mean", "all_gather", "none", True, data="nan", spec=one4),
            _case("one1", "mean", "all_to_all", "none", True, data="nan", spec=one1)]
    out += [_case("one4", "krum", "all_gather", "none", False, spec=one4),
            _case("one4", "bulyan", "all_gather", "random", False, spec=one4)]
    train = dict(kind="train", M=4, rule="trimmed_mean")
    out += [dict(train, name="train-d4", world=4, mesh=[4, 1], axes=["data", "model"],
                 node_axes=["data"]),
            dict(train, name="train-d2m2", world=4, mesh=[2, 2], axes=["data", "model"],
                 node_axes=["data"]),
            dict(train, name="train-one", world=1, mesh=[1, 1], axes=["data", "model"],
                 node_axes=["data"])]
    return out


CASES = _cases()
GOSSIP = [c for c in CASES if c["kind"] == "gossip"]
RAISES = {"d2m2x2-trimmed_mean-all_to_all-none-f32", "d2m2x2-trimmed_mean-all_gather-none-int8"}


def _adjacency(m: int) -> np.ndarray:
    """Seeded in-neighbor masks: M = 4 misses the edges 0 <- 2 and 3 <- 1."""
    adj = ~np.eye(m, dtype=bool)
    if m == 4:
        adj[0, 2] = adj[3, 1] = False
    return adj


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for m in (1, 2, 4):
        out[f"M{m}/a"] = rng.normal(size=(m, 6, 10)).astype(np.float32)
        out[f"M{m}/b"] = rng.normal(size=(m, 12)).astype(np.float32)
        out[f"M{m}/adj"] = _adjacency(m)
        for k in ("a", "b"):
            x = out[f"M{m}/{k}"].copy()
            x[2 % m].flat[3] = np.nan
            out[f"M{m}nan/{k}"] = x
    cfg = jget("qwen3-4b").reduced()
    jp = jax.jit(lambda k: jreplicate(japi.build(cfg).init_params(k, cfg), 4, perturb=0.01,
                                      key=jax.random.PRNGKey(1)))(jax.random.PRNGKey(0))
    for k, v in convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu").items():
        out[f"train/{k}"] = v.numpy()
    out["train/tokens"] = rng.integers(0, cfg.vocab_size, (4, 2, 2, 17)).astype(np.int32)
    return out


REFERENCE = textwrap.dedent("""
    import json, sys, time
    t0 = time.perf_counter()
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.configs import get_config
    from repro.core import gossip_screen_params
    from repro.launch import sharding
    from repro.launch.mesh import make_mesh_compat
    from repro.launch.steps import make_train_step

    path = sys.argv[1]
    inputs = dict(np.load(path + "/inputs.npz"))
    cases = json.load(open(path + "/cases.json"))
    out = {}

    def nest(flat):
        tree = {}
        for k, v in flat.items():
            *head, leaf = k.split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
        return tree

    def flat(tree, prefix=""):
        res = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                res.update(flat(v, prefix + k + "/"))
            else:
                res[prefix + k] = np.asarray(v)
        return res

    groups = {}
    for c in cases:
        if c["world"] != 4:
            continue
        mesh = make_mesh_compat(tuple(c["mesh"]), tuple(c["axes"]))
        nax = tuple(c["node_axes"])
        m = c["M"]
        adj = jnp.asarray(inputs[f"M{m}/adj"])
        if c["kind"] == "train":
            if c["mesh"] != [4, 1]:  # the reference's step needs one node a rank
                continue
            cfg = get_config("qwen3-4b").reduced()
            p = nest({k[6:]: jnp.asarray(v) for k, v in inputs.items()
                      if k.startswith("train/") and k != "train/tokens"})
            toks = jnp.asarray(inputs["train/tokens"])
            ps = sharding.param_specs(cfg, p, node_axes=nax)
            bs = sharding.train_batch_specs({"tokens": toks[:, 0]}, nax)
            step = make_train_step(cfg, mesh, nax, ps, adj, rule="trimmed_mean",
                                   num_byzantine=1)
            js = jax.jit(step, in_shardings=(sharding.named(mesh, ps),
                                             sharding.named(mesh, bs), None))
            for t in range(2):
                p, met = js(p, {"tokens": toks[:, t]}, jnp.float32(t))
                out[f"{c['name']}|loss{t}"] = np.asarray(met["loss"])
            out.update({f"{c['name']}|{k}": v for k, v in flat(p).items()})
            continue
        lead = nax[0] if len(nax) == 1 else nax
        specs = {"a": P(lead, None, "model"), "b": P(lead, "model")}
        byz = np.zeros(m, bool)
        byz[c["byz"]] = True

        def fn(params, adj, byz, key, c=c, specs=specs, nax=nax, mesh=mesh):
            return gossip_screen_params(
                params, specs, mesh=mesh, node_axes=nax, rule=c["rule"], b=c["b"],
                adjacency=adj, schedule=c["schedule"], byz_mask=byz, attack=c["attack"],
                key=key, t=3, quantize=c["quantize"])

        args = ({k: jnp.asarray(inputs[f"{c['src']}/{k}"]) for k in specs}, adj, jnp.asarray(byz),
                jax.random.PRNGKey(7))
        try:  # the reference's refusals happen as it traces
            jax.eval_shape(fn, *args)
        except Exception as e:
            out[f"{c['name']}|raised"] = np.array(type(e).__name__ + ": " + str(e)[:200])
            continue
        groups.setdefault(tuple(c["mesh"]), []).append((c, fn, args))
    # one program a mesh for all its cases (each case's outputs are those of
    # its own jit, bit for bit; one compilation instead of fifty)
    for group in groups.values():
        res = jax.jit(lambda all_args: [f(*a) for (_, f, _), a in zip(group, all_args)])(
            [a for _, _, a in group])
        for (c, _, _), r in zip(group, res):
            out.update({f"{c['name']}|{k}": np.asarray(v) for k, v in r.items()})
    np.savez(path + "/ref.npz", **out)
    print("OK", time.perf_counter() - t0)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs, ``(port, reference, inputs, in_process)``: the
    first two dicts ``case|leaf`` -> full arrays (the port's blocks
    assembled), ``case|raised`` -> a refusal's message; ``in_process`` the
    reference's single-device results, every arch's shapes and both
    packages' prefill and serve steps, computed while the two subprocesses
    run."""
    path = str(tmp_path_factory.mktemp("sharded"))
    inputs = _inputs()
    np.savez(os.path.join(path, "inputs.npz"), **inputs)
    with open(os.path.join(path, "cases.json"), "w") as f:
        json.dump(CASES, f)
    # one compute thread a process: the suite's other workers share the CPU
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for cmd in ([sys.executable, "-c", REFERENCE, path],
                         [sys.executable, os.path.join(HERE, "torch_sharded_ranks.py"), path])]
    try:
        in_process = {"one": _one_rank_references(inputs), "first_row": _first_rows(inputs),
                      "shapes": _arch_shapes(),
                      "steps": {arch: _step_outputs(arch) for arch in STEP_ARCHS}}
        for proc in procs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            proc.kill()
    ranks = [dict(np.load(os.path.join(path, f"rank{r}.npz"))) for r in range(4)]
    got = dict(np.load(os.path.join(path, "world1.npz")))
    for c in CASES:
        if c["world"] != 4:
            continue
        fake = types.SimpleNamespace(shape=dict(zip(c["axes"], c["mesh"], strict=True)))
        for k in (k for k in ranks[0] if k.startswith(c["name"] + "|")):
            leaf = k.split("|", 1)[1]
            if leaf.startswith("loss") or leaf == "raised":
                got[k] = ranks[0][k]
                continue
            full = inputs[f"train/{leaf}" if c["kind"] == "train" else f"M{c['M']}/{leaf}"]
            got[k] = sharding.assemble([torch.from_numpy(r[k]) for r in ranks],
                                       _spec(c, leaf, full.shape), fake, full.shape).numpy()
    return got, dict(np.load(os.path.join(path, "ref.npz"))), inputs, in_process


def _spec(case: dict, leaf: str, shape) -> tuple:
    nax = tuple(case["node_axes"])
    if case["kind"] == "train":
        return sharding.param_specs(get_config("qwen3-4b").reduced(), {leaf: shape},
                                    node_axes=nax)[leaf]
    lead = nax[0] if len(nax) == 1 else nax
    return {"a": (lead, None, "model"), "b": (lead, "model")}[leaf]


def _leaves(res: dict, name: str) -> dict:
    return {k.split("|", 1)[1]: v for k, v in res.items() if k.startswith(name + "|")}


def _self_fma(case: dict) -> bool:
    """Whether XLA contracts the reference's own-row decode into its
    screen: the int8 all_gather's trimmed mean adds its own decoded value
    ``q_j * s_j`` as ``fma(q_j, s_j, total)`` (measured: bit for bit that
    form), and so does its mean when no attack's select stands between
    the decode and the add (measured: the unfused mean differs by an ulp
    on some rows); the port adds the rounded decode."""
    return case["quantize"] and case["schedule"] == "all_gather" and (
        case["rule"] == "trimmed_mean" or (case["rule"] == "mean" and case["attack"] == "none"))


def _self_fma_bound(inputs: dict, case: dict) -> float:
    """One rounding of the total (the decode's, inside it) and one of each
    quotient: 4 ulp of the largest input (the kept values and the own value
    are decodes of the inputs, the total over its divisor no larger)."""
    big = max(float(np.nanmax(np.abs(inputs[f"{case['src']}/{k}"]))) for k in ("a", "b"))
    return 4 * float(np.finfo(np.float32).eps) * big


def _check(case: dict, got: dict, want: dict, inputs: dict) -> None:
    assert set(got) == set(want) and got, (sorted(got), sorted(want))
    for k in want:
        assert got[k].shape == want[k].shape, (case["name"], k)
        if case["rule"] in ("krum", "bulyan"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=VECTOR_ATOL,
                                       err_msg=f"{case['name']} {k}")
        elif case["attack"] == "random":
            np.testing.assert_allclose(got[k], want[k], rtol=RANDOM_RTOL, atol=RANDOM_ATOL,
                                       err_msg=f"{case['name']} {k}")
        elif _self_fma(case):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=_self_fma_bound(inputs, case),
                                       err_msg=f"{case['name']} {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{case['name']} {k}")


# ---------------------------------------------------------------------------
# Gossip at four ranks against the reference on the same mesh
# ---------------------------------------------------------------------------

FOUR = [c for c in GOSSIP if c["world"] == 4 and c["name"] not in RAISES]


@pytest.mark.parametrize("case", FOUR, ids=[c["name"] for c in FOUR])
def test_gossip_four_ranks_match_reference(runs, case):
    got, ref, inputs, _ = runs
    _check(case, _leaves(got, case["name"]), _leaves(ref, case["name"]), inputs)


def test_krum_picks_whole_replicas_like_reference(runs):
    """Krum's output rows are whole replicas: every node's row equals one
    input row exactly (the pick), the reference's pick."""
    got, ref, inputs, _ = runs
    for mesh in MESHES:
        name = f"{mesh}-krum-all_gather-none-f32"
        m = MESHES[mesh][3]
        for leaf in ("a", "b"):
            x = inputs[f"M{m}/{leaf}"].reshape(m, -1)
            g = got[f"{name}|{leaf}"].reshape(m, -1)
            r = ref[f"{name}|{leaf}"].reshape(m, -1)
            picks = [int(np.nonzero((x == row).all(axis=1))[0][0]) for row in g]
            assert picks == [int(np.nonzero((x == row).all(axis=1))[0][0]) for row in r]


@pytest.mark.parametrize("name", sorted(RAISES))
def test_port_raises_where_reference_fails(runs, name):
    """Two nodes a rank: the reference's all_to_all screens only a rank's
    first node and returns one row a rank (the wrong shape), and its
    quantized all_gather cannot broadcast two scales over four rows; the
    port refuses both."""
    got, ref, inputs, _ = runs
    assert f"{name}|raised" in got, sorted(k for k in got if k.startswith(name))
    if f"{name}|raised" in ref:
        assert "TypeError" in str(ref[f"{name}|raised"])
    else:
        assert ref[f"{name}|a"].shape[0] != inputs["M4/a"].shape[0]


# ---------------------------------------------------------------------------
# A world of one against the reference on one device
# ---------------------------------------------------------------------------

ONE = [c for c in GOSSIP if c["world"] == 1]


def _one_rank_references(inputs: dict) -> dict:
    """The reference's result for every one-rank case, a rank holding every
    node: its own pieces (`_quantize_int8` over the rank's block,
    `_inject_attack` at node index 0, `screening.screen_all` over every
    node, `vector_rule_select`), the coordinate-wise cases in one jit (the
    shard_map body is one program too)."""
    out, coord_cases = {}, []
    for case in ONE:
        m = case["M"]
        adj = jnp.asarray(inputs[f"M{m}/adj"])
        byz = np.zeros(m, bool)
        byz[case["byz"]] = True
        params = {k: jnp.asarray(inputs[f"{case['src']}/{k}"]) for k in ("a", "b")}
        if case["rule"] == "krum":
            idx = jgossip.vector_rule_select(params, rule="krum", b=case["b"], adjacency=adj)
            out[case["name"]] = {k: np.asarray(jnp.take(v, idx, axis=0))
                                 for k, v in params.items()}
            continue
        if case["rule"] == "bulyan":
            adj = jgossip.vector_rule_select(params, rule="bulyan", b=case["b"], adjacency=adj)
        coord_cases.append((case, params, adj, jnp.asarray(byz)))

    def coord(case, x, adj, byz):
        m = x.shape[0]
        s = x.reshape(m, -1)
        if case["quantize"]:
            q, scale = jgossip._quantize_int8(s)
            s = q.astype(jnp.float32) * scale
        s = jgossip._inject_attack(s, byz, case["attack"], jax.random.PRNGKey(KEY),
                                   jnp.int32(TICK), 0)
        rule = "trimmed_mean" if case["rule"] == "bulyan" else case["rule"]
        return jscreening.screen_all(s, adj, rule=rule, b=case["b"]).reshape(x.shape)

    res = jax.jit(lambda args: [{k: coord(c, v, adj, byz) for k, v in p.items()}
                                for c, (p, adj, byz) in zip([c for c, *_ in coord_cases], args)])(
        [(p, adj, byz) for _, p, adj, byz in coord_cases])
    for (case, *_), r in zip(coord_cases, res):
        out[case["name"]] = {k: np.asarray(v) for k, v in r.items()}
    return out


def _first_rows(inputs: dict) -> dict:
    """The reference's all_gather on a one-device mesh, M = 4: its one
    output row (row 0, the axis index's) a rule, plain and int8 under
    sign_flip."""
    mesh = jmesh((1, 1), ("data", "model"))
    adj = jnp.asarray(inputs["M4/adj"])
    byz = jnp.zeros(4, bool).at[1].set(True)
    params = {k: jnp.asarray(inputs[f"M4/{k}"]) for k in ("a", "b")}
    specs = {"a": P("data", None, "model"), "b": P("data", "model")}
    runs = [(rule, attack, quantize) for rule in COORD
            for attack, quantize in (("none", False), ("sign_flip", True))]
    # the adjacency an operand, as the gossip takes it (closed over on one
    # device, XLA would fold row 0's divisors into reciprocal multiplies)
    res = jax.jit(lambda p, a: [jgossip.gossip_screen_params(
        p, specs, mesh=mesh, node_axes="data", rule=rule, b=1, adjacency=a, byz_mask=byz,
        attack=attack, key=jax.random.PRNGKey(KEY), t=TICK, quantize=quantize)
        for rule, attack, quantize in runs])(params, adj)
    return {f"one4-{rule}-all_gather-{attack}-{'int8' if quantize else 'f32'}":
            {k: np.asarray(v) for k, v in r.items()}
            for (rule, attack, quantize), r in zip(runs, res, strict=True)}


@pytest.mark.parametrize("case", ONE, ids=[c["name"] for c in ONE])
def test_gossip_one_rank_matches_reference(runs, case):
    got, _, inputs, in_process = runs
    _check(case, _leaves(got, case["name"]), in_process["one"][case["name"]], inputs)


@pytest.mark.parametrize("rule", COORD)
def test_one_rank_first_row_is_reference_shard_map(runs, rule):
    """The reference's all_gather on a one-device mesh screens row 0 only
    (its axis index) and returns one row; the port's row 0 is that row
    bit for bit (the int8 trimmed mean within the self-term bound of
    `_self_fma`)."""
    got, _, inputs, in_process = runs
    for attack, quantize in (("none", False), ("sign_flip", True)):
        name = f"one4-{rule}-all_gather-{attack}-{'int8' if quantize else 'f32'}"
        case = next(c for c in ONE if c["name"] == name)
        want = in_process["first_row"][name]
        assert all(v.shape[0] == 1 for v in want.values())
        _check(case, {k: v[:1] for k, v in _leaves(got, name).items()}, want, inputs)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["train-d4", "train-d2m2", "train-one"])
def test_train_step_matches_reference(runs, name):
    """Reduced qwen3-4b, M = 4, BRIDGE-T b = 1, all_gather, 2 steps: the
    port at four ranks on (4, 1) and on (2, 2) (two nodes a rank, the
    embedding and head split over "model", gathered for the forward) and
    at one rank, against the reference's `make_train_step` jitted on its
    (4, 1) host mesh."""
    got, ref, _, _ = runs
    want = _leaves(ref, "train-d4")
    mine = _leaves(got, name)
    assert set(mine) == set(want)
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=TRAIN_RTOL, atol=1e-7,
                                   err_msg=f"{name} {k}")
    assert all(np.isfinite(mine[f"loss{t}"]) for t in range(2))


def test_train_step_mesh_independent(runs):
    """Without an attack the port's step is the same on every mesh: each
    rank runs whole replicas, so the gradients are bit for bit."""
    got, _, _, _ = runs
    a, b, c = (_leaves(got, n) for n in ("train-d4", "train-d2m2", "train-one"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


# ---------------------------------------------------------------------------
# The specs, for all ten archs at their published widths
# ---------------------------------------------------------------------------


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jsharding._path_str(p): v for p, v in leaves}


def _arch_shapes() -> dict:
    """Every arch's parameter shapes (the reference's ``eval_shape``, the
    port's ``param_shapes``) and decode caches (``eval_shape`` of
    ``init_cache``; the port's on the meta device) at decode_32k's batch
    128, sequence 32768."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jget(arch), get_config(arch)
        japi_ = japi.build(jcfg)
        jp = jax.eval_shape(lambda k, c=jcfg, a=japi_: a.init_params(k, c), jax.random.PRNGKey(0))
        jc = jax.eval_shape(lambda c=jcfg, a=japi_: a.init_cache(c, 128, 32768))
        tp = api.build(cfg).param_shapes(cfg)
        tc = api.build(cfg).init_cache(cfg, 128, 32768, device="meta")
        out[arch] = (jcfg, cfg, jp, jc, tp, tc)
    return out


@pytest.fixture(scope="module")
def shapes(runs):
    return runs[3]["shapes"]


def test_arch_lists_agree():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(JARCHS))
@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("nax", [None, ("data",), ("pod", "data")], ids=["serve", "data",
                                                                          "pod-data"])
def test_param_specs_match_reference(shapes, arch, layout, nax):
    jcfg, cfg, jp, _, tp, _ = shapes[arch]
    if nax is not None:  # the training layout: a leading node axis of 8
        jp = jax.tree.map(lambda s: jax.ShapeDtypeStruct((8, *s.shape), s.dtype), jp)
        tp = {k: (8, *s) for k, s in tp.items()}
    want = {k: tuple(v) for k, v in _jflat(jsharding.param_specs(jcfg, jp, node_axes=nax,
                                                                 layout=layout)).items()}
    got = sharding.param_specs(cfg, tp, node_axes=nax, layout=layout)
    assert got == want


@pytest.mark.parametrize("arch", sorted(JARCHS))
@pytest.mark.parametrize("mesh_shape", [{"data": 16, "model": 16},
                                        {"pod": 2, "data": 16, "model": 16},
                                        {"data": 4, "model": 2}], ids=["pod", "multipod", "host"])
def test_cache_specs_match_reference(shapes, arch, mesh_shape):
    jcfg, cfg, _, jc, _, tc = shapes[arch]
    mesh = types.SimpleNamespace(shape=mesh_shape)
    nax = ("pod", "data") if "pod" in mesh_shape else ("data",)
    for batch, seq in ((128, 32768), (1, 32768)):
        kw = dict(node_axes=nax, mesh=mesh, batch=batch, seq_len=seq)
        want = {k: tuple(v) for k, v in _jflat(jsharding.cache_specs(jcfg, jc, **kw)).items()}
        assert convert.flatten_tree(sharding.cache_specs(cfg, tc, **kw)) == want


@pytest.mark.parametrize("layout", ["tp", "dp"])
@pytest.mark.parametrize("nax", [("data",), ("pod", "data")])
def test_batch_specs_match_reference(layout, nax):
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 4, "model": 2})
    batch = {"tokens": (8, 4, 129), "image_embeds": (8, 4, 256, 64)}
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in batch.items()}
    want = {k: tuple(v) for k, v in _jflat(jsharding.train_batch_specs(jbatch, nax,
                                                                       layout=layout)).items()}
    assert sharding.train_batch_specs(batch, nax, layout=layout) == want
    serve = {"tokens": (16, 1)}
    jserve = {"tokens": jax.ShapeDtypeStruct((16, 1), jnp.int32)}
    for gb in (16, 4, 3):
        want = {k: tuple(v) for k, v in
                _jflat(jsharding.serve_batch_specs(jserve, nax, gb, mesh)).items()}
        assert sharding.serve_batch_specs(serve, nax, gb, mesh) == want


# ---------------------------------------------------------------------------
# Blocks, and the serving steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [("data", None, "model"), (("pod", "data"), "model", None),
                                  (None, ("data", "model"), None)])
def test_local_shard_pads_and_assembles(spec):
    """Every rank's block (``ceil(n / k)`` long, zero past the end, as GSPMD
    pads) put back together is the leaf; the blocks tile it in mesh order."""
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 3, "model": 2})
    x = torch.arange(7 * 5 * 3, dtype=torch.float32).reshape(7, 5, 3)
    blocks = []
    for r in range(12):
        coords = dict(zip(mesh.shape, np.unravel_index(r, (2, 3, 2)), strict=True))
        blocks.append(sharding.local_shard(x, spec, mesh, coords=coords))
        assert tuple(blocks[-1].shape) == sharding.block_shape(x.shape, spec, mesh)
    torch.testing.assert_close(sharding.assemble(blocks, spec, mesh, x.shape), x, rtol=0, atol=0)
    last = blocks[-1]  # the last block of each split dim holds padding
    assert float(last.flatten()[-1]) == 0.0 or last.shape == x.shape


def _bounded(got, want, what: str) -> None:
    """``max |got - want|`` within `DECODE_BOUND` of ``max |want|``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= DECODE_BOUND * (float(np.max(np.abs(want))) + 1e-9), (what, err)


STEP_ARCHS = ("qwen3-4b", "deepseek-v2-236b", "rwkv6-3b", "whisper-medium", "qwen2-vl-2b",
              "zamba2-1.2b")


def _step_outputs(arch: str) -> dict:
    """Both packages' prefill and serve steps on ``arch``'s reduced config:
    the reference's `make_prefill_step` / `make_serve_step` jitted, as it
    serves, and the port's, from the reference's parameters carried by
    `convert`, the same seeded tokens and embeddings and fresh caches
    (whisper's cross caches prefilled from the same audio); also the
    port's forward at the last position and its `decode_step`.  Computed
    while the subprocesses of `runs` work."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    ja, mod = japi.build(jcfg), api.build(cfg)
    jp = jax.jit(lambda k: ja.init_params(k, jcfg))(jax.random.PRNGKey(3))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    toks = tbatch["tokens"]
    out = {"prefill": make_prefill_step(cfg)(params, tbatch),
           "ref_prefill": jax.jit(jsteps.make_prefill_step(jcfg))(jp, jbatch)}
    with torch.no_grad():
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            full = encdec.decode_train(params, encdec.encode(params, tbatch["audio_embeds"], cfg),
                                       toks, cfg)
        elif cfg.family == "vlm":
            from repro_torch.models import vlm
            full = vlm.forward(params, tbatch, cfg)
        elif cfg.family == "moe":
            from repro_torch.models import moe
            full = moe.forward(params, toks, cfg)[0]
        else:
            from repro_torch.models import dense, hybrid, ssm
            full = {"dense": dense, "rwkv": ssm, "hybrid": hybrid}[cfg.family].forward(
                params, toks, cfg)
    out["forward_last"] = full[:, -1:]
    seq = 16 if cfg.family == "encdec" else 8
    cache = mod.init_cache(cfg, 2, seq, device="cpu")
    jcache = ja.init_cache(jcfg, 2, seq)
    if cfg.family == "encdec":
        cache = mod.extra["prefill_cache"](params, cache, tbatch["audio_embeds"], cfg)
        jcache = ja.extra["prefill_cache"](jp, jcache, jbatch["audio_embeds"], jcfg)
    out["serve"], new = make_serve_step(cfg)(params, cache, {"tokens": toks[:, :1]})
    out["ref_serve"], jnew = jax.jit(jsteps.make_serve_step(jcfg))(
        jp, jcache, {"tokens": jbatch["tokens"][:, :1]})
    out["decode_step"], _ = mod.decode_step(params, cache, toks[:, :1], cfg)
    out["cache"] = jax.tree.map(lambda v: np.asarray(v.numpy()), new)
    out["ref_cache"] = jax.tree.map(np.asarray, jnew)
    out["vocab"] = cfg.vocab_size
    return out


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_serve_steps(runs, arch):
    """The port's prefill and serve steps against the reference's on the
    reduced config (`_step_outputs`): the logits and every leaf of the
    stepped cache within `DECODE_BOUND`, the cache trees alike.  The port's
    prefill is also its family's forward at the last position, and its
    serve step its `decode_step`, exactly."""
    out = runs[3]["steps"][arch]
    assert out["prefill"].shape == out["serve"].shape == (2, 1, out["vocab"])
    _bounded(out["prefill"], out["ref_prefill"], "prefill logits")
    torch.testing.assert_close(out["prefill"], out["forward_last"], rtol=1e-5, atol=1e-5)
    _bounded(out["serve"], out["ref_serve"], "serve logits")
    assert jax.tree.structure(out["cache"]) == jax.tree.structure(out["ref_cache"])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(out["cache"])[0],
                            jax.tree_util.tree_leaves(out["ref_cache"]), strict=True):
        _bounded(a, b, f"cache {jax.tree_util.keystr(path)}")
    torch.testing.assert_close(out["serve"], out["decode_step"], rtol=0, atol=0)


def test_int8_decode_is_the_reference_product():
    """The gossip's int8 decode (the ``dequant`` wrapper's NaN-keeping
    form; on the CPU its plain version) is the reference's ``q.astype(f32)
    * gs[:, None]`` bit for bit, NaN and inf scales included."""
    from repro_torch.core import gossip

    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, size=(5, 300)).astype(np.int8)
    q[:, :4] = 0
    scales = (rng.uniform(1e-3, 1.0, size=5) * 10.0 ** rng.integers(-3, 3, size=5)).astype(
        np.float32)
    scales[1], scales[2], scales[3] = np.nan, np.inf, -np.inf
    got = gossip._decode(torch.from_numpy(q), torch.from_numpy(scales)).numpy()
    want = np.asarray(jnp.asarray(q).astype(jnp.float32) * jnp.asarray(scales)[:, None])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[1]).all() and np.isnan(got[2, :4]).all()


def test_mesh_takes_exactly_the_world():
    """A mesh holds exactly the world's ranks: a world of one makes the
    (1, 1) mesh and refuses (2, 2) and the production meshes; one rank's
    index over any axes is 0 and its groups hold one rank."""
    from repro_torch.launch import mesh as mesh_lib

    with pytest.raises(RuntimeError, match="no world"):
        mesh_lib.make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    mesh_lib.init_world("cpu")
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            mesh_lib.make_host_mesh(2, 2)
        for multi_pod in (False, True):
            with pytest.raises(ValueError, match="production mesh"):
                mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh = mesh_lib.make_mesh_compat((1, 1, 1), ("pod", "data", "model"), device="cpu")
        assert mesh_lib.node_axes(mesh) == ("pod", "data") and mesh_lib.num_nodes(mesh) == 1
        assert mesh.index(("pod", "data")) == 0 and mesh.size(("pod", "data", "model")) == 1
        assert torch.distributed.get_world_size(mesh.group(("pod", "data"))) == 1
    finally:
        mesh_lib.close_world()
