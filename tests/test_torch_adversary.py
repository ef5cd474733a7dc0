"""The adversary layer of the port (`repro_torch.adversary`) and the
screening kernels under autograd (`repro_torch.kernels.autograd`), on the
CPU against the reference (`repro.adversary`, `repro.core.screening`).

Tolerances, and why:

* the adversary functions (broadcast, message and sparse-message forms)
  and `observe` over 3 ticks from a carried `AdvState`: rtol 1e-5,
  atol 1e-6.  The port writes XLA's fused forms (the EMAs and the crafted
  rows as one-rounding FMAs); what is left is the honest variance, which
  XLA's fused reduction rounds differently on about 1% of coordinates
  (1 ulp of sigma), and ``dissensus``'s ``tanh`` (XLA's approximation,
  a few ulps);
* each screen's backward against ``jax.grad`` of the reference's screen:
  on tie-free inputs per row, rtol 1e-5 (the dense form sums its
  receivers' cotangents in its own order); on a row shared by every
  Byzantine node (``inner_max``'s crafted row, where ties are the rule)
  per ``delta`` only, at the same tolerance;
* ``inner_max``'s crafted rows, and trainers with every adversary, over a
  few ticks: rtol 1e-5, atol 1e-6 — in these runs no near-zero gradient
  flips a sign, so the ascent takes the reference's steps
  (``delta`` exactly the reference's);
* grid cells against their own trainer runs: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary import protocols as jp
from repro.core import screening as jscreening
from repro.core.bridge import BridgeConfig as JConfig
from repro.core.bridge import BridgeTrainer as JTrainer
from repro.core.bridge import replicate as jreplicate
from repro.core.graph import erdos_renyi as jerdos_renyi
from repro.core.neighbors import NeighborTable as JTable
from repro.net import AsyncBridgeConfig as JAsyncConfig
from repro.net import AsyncBridgeTrainer as JAsyncTrainer
from repro.net import scenarios as jscenarios
from repro_torch import prng
from repro_torch.adversary import adaptive, protocols as tp
from repro_torch.adversary.equivocation import slander_accuse
from repro_torch.core import BridgeConfig, BridgeTrainer, erdos_renyi, replicate, screening
from repro_torch.core.neighbors import NeighborTable
from repro_torch.kernels import autograd as grad_ops
from repro_torch.net import AsyncBridgeConfig, AsyncBridgeTrainer
from repro_torch.net.runtime import SparseUnreliableRuntime
from repro_torch.net.scenarios import get_scenario
from repro_torch.sim import Cell, ExperimentGrid, GridEngine

M, D, T = 10, 16, 3
BYZ = np.zeros(M, bool)
BYZ[[2, 5]] = True
ADAPTIVE = ("alie_online", "ipm", "dissensus", "inner_max", "equivocate", "slander")


def qgrad(params, batch):
    w = params["w"]
    return 0.5 * torch.sum((w - batch) ** 2, dim=-1), {"w": w - batch}


def jqgrad(params, batch):
    w, c = params["w"], batch
    return 0.5 * jnp.sum((w - c) ** 2), {"w": w - c}


def init_fn(seed):
    return replicate({"w": torch.zeros(D)}, M, perturb=0.1, key=prng.PRNGKey(seed))


@pytest.fixture(scope="module")
def targets():
    rng = np.random.default_rng(0)
    return rng.normal(size=(M, D)).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def topo():
    return erdos_renyi(M, 0.8, 2, seed=1)


def test_registry_tiers_thetas_and_banks_are_the_reference():
    assert tp.registry_tiers() == jp.registry_tiers()
    assert tp.attack_names() == jp.attack_names()
    for name, adv in jp.ADVERSARIES.items():
        mine = tp.get_adversary(name)
        assert (mine.stateful, mine.tier, mine.default_theta, mine.theta_bounds) == (
            adv.stateful, adv.tier, adv.default_theta, adv.theta_bounds)
        assert (mine.message_fn is None) == (adv.message_fn is None)
    bank = tp.adversary_bank(("none", "alie", "inner_max", "slander"))
    assert tp.bank_engaged(bank) and tp.bank_stateful(bank) and tp.bank_accuses(bank)
    assert not tp.bank_engaged(tp.adversary_bank(("none",))) and not tp.bank_engaged(None)
    np.testing.assert_array_equal(tp.cell_theta(bank, (2, 3), None),
                                  np.asarray(jp.default_thetas(bank)[2:]))
    assert adaptive.ascent_steps(np.asarray([[0, 0, 0, 0], [0, 0, 2.6, 0], [0, 0, 40, 0]],
                                            np.float32)).tolist() == [6, 3, adaptive.K_MAX]
    with pytest.raises(ValueError, match="unknown adversary"):
        tp.get_adversary("nope")


def _reference_call(form, adv, ctx_j, nbr):
    """The reference's adversary function of ``form``, jitted (the
    trainers' program)."""
    if form == "broadcast":
        return jax.jit(lambda st, th, w, bz, t: adv.fn(ctx_j, st, th, w, bz,
                                                       jax.random.PRNGKey(0), t))
    if form == "message":
        fn = adv.message_fn or jp.lift_message(adv)
        return jax.jit(lambda st, th, w, bz, t: fn(ctx_j, st, th, w, bz, None,
                                                   jax.random.PRNGKey(0), t))
    fn = adv.sparse_message_fn or jp.lift_message_sparse(adv)
    return jax.jit(lambda st, th, w, bz, t: fn(ctx_j, st, th, w, bz, nbr, None,
                                               jax.random.PRNGKey(0), t))


@pytest.mark.parametrize("form", ["broadcast", "message", "sparse"])
@pytest.mark.parametrize("name", ["alie_online", "ipm", "dissensus", "equivocate", "slander"])
def test_adversary_functions_match_the_reference_over_ticks(name, form):
    """3 ticks from a carried state: the crafted rows (or messages and
    self-views) and the state, at rtol 1e-5; ``observe`` too."""
    rng = np.random.default_rng(1)
    adj = topo().adjacency
    jnbr, nbr = JTable.from_adjacency(adj), NeighborTable.from_adjacency(adj, device="cpu")
    jadv, adv = jp.get_adversary(name), tp.get_adversary(name)
    ref = _reference_call(form, jadv, jp.AdvCtx(latency=1.5 if form != "broadcast" else 0.0),
                          jnbr)
    ctx = tp.AdvCtx(latency=1.5 if form != "broadcast" else 0.0)
    jst, st = jp.init_state(D), tp.init_state(D, lead=(1,), device="cpu")
    theta = np.asarray(jadv.default_theta, np.float32)
    for t in range(3):
        w = (rng.normal(size=(M, D)) * (1 + t)).astype(np.float32)
        jout = ref(jst, jnp.asarray(theta), jnp.asarray(w), jnp.asarray(BYZ), t)
        args = (ctx, st, theta[None], torch.from_numpy(w)[None], torch.from_numpy(BYZ)[None])
        if form == "broadcast":
            out = adv.fn(*args, prng.PRNGKey(0), t)
        elif form == "message":
            fn = adv.message_fn or tp.lift_message(adv)
            out = fn(*args, None, prng.PRNGKey(0), t)
        else:
            fn = adv.sparse_message_fn or tp.lift_message_sparse(adv)
            out = fn(*args, nbr, None, prng.PRNGKey(0), t)
        *rows, st = out
        *jrows, jst = jout
        for got, want in zip(rows, jrows, strict=True):
            close(got[0], want)
        for got, want in zip(st, jst, strict=True):
            close(got[0], want)
        if name == "ipm":  # observe alone, from the carried state
            jo = jax.jit(jp.observe)(jst, jnp.asarray(w), jnp.asarray(BYZ))
            to = tp.observe(st, torch.from_numpy(w)[None], torch.from_numpy(BYZ)[None])
            for got, want in zip(to[0], jo[0], strict=True):
                close(got[0], want)
            for got, want in zip(to[1:], jo[1:], strict=True):
                close(got[0], want)
    if name == "slander":
        dig = rng.normal(size=(M, M, 4)).astype(np.float32)
        want = jadv.accuse_fn(jnp.asarray(theta), jnp.asarray(dig), jnp.asarray(BYZ), None, 0)
        got = slander_accuse(theta[None], torch.from_numpy(dig)[None],
                             torch.from_numpy(BYZ)[None], None, 0)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


FORMS = ["dense", "gather", "views"]


def _port_screen(rule, form, w, adj, tab):
    if form == "dense":
        return screening.screen_all_banked(w, torch.from_numpy(adj), (rule,), (0,), (1,),
                                           self_vals=w)
    if form == "gather":
        return screening.screen_gathered_banked(w, tab, (rule,), (0,), (1,), self_vals=w)
    return screening.screen_views_banked(tab.gather_rows(w, lead=1), tab.valid_dev, w, (rule,),
                                         (0,), (1,))


def _ref_screen(rule, form, w, adj, tab):
    if form == "dense":
        return jscreening.screen_all_banked(w, jnp.asarray(adj), (rule,), 0, 1, self_vals=w)
    idx = jnp.asarray(np.minimum(tab.idx, M - 1))
    return jscreening.screen_views_banked(w[idx], jnp.asarray(tab.valid), w, (rule,), 0, 1)


@pytest.mark.parametrize("rule,form", [(r, f) for r in ("trimmed_mean", "median", "krum",
                                                         "bulyan") for f in FORMS]
                         + [(r, "dense") for r in ("geomedian", "clipped_mean", "mean")])
def test_screen_backward_matches_jax_grad_per_row_on_tie_free_inputs(rule, form):
    """The kernel-backed screens' backward (and, dense, the plain rules',
    torch's own through their ops) per row."""
    rng = np.random.default_rng(3)
    adj = topo().adjacency
    tab = NeighborTable.from_adjacency(adj, device="cpu")
    w = rng.normal(size=(M, D)).astype(np.float32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    want = jax.jit(jax.grad(lambda x: jnp.sum(_ref_screen(rule, form, x, adj, tab) * g)))(
        jnp.asarray(w))
    x = torch.from_numpy(w)[None].requires_grad_(True)
    (got,) = torch.autograd.grad((_port_screen(rule, form, x, adj, tab) * torch.from_numpy(g))
                                 .sum(), x)
    close(got[0], want)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
def test_screen_backward_per_delta_on_a_shared_crafted_row(rule, form):
    """Every Byzantine node sends ``mu + delta * sigma``: the gradient with
    respect to ``delta`` (a sum over each tied group) is the reference's."""
    rng = np.random.default_rng(4)
    adj = topo().adjacency
    tab = NeighborTable.from_adjacency(adj, device="cpu")
    w = rng.normal(size=(M, D)).astype(np.float32)
    mu, sigma = w.mean(0), w.std(0) + 0.1
    delta0 = rng.normal(size=D).astype(np.float32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    byz = jnp.asarray(BYZ)

    def jobj(delta):
        wb = jnp.where(byz[:, None], mu + delta * sigma, w)
        return jnp.sum(_ref_screen(rule, form, wb, adj, tab) * g)

    want = jax.jit(jax.grad(jobj))(jnp.asarray(delta0))
    delta = torch.from_numpy(delta0).requires_grad_(True)
    wb = torch.where(torch.from_numpy(BYZ)[:, None], torch.from_numpy(mu) + delta
                     * torch.from_numpy(sigma), torch.from_numpy(w))
    (got,) = torch.autograd.grad((_port_screen(rule, form, wb[None], adj, tab)[0]
                                  * torch.from_numpy(g)).sum(), delta)
    close(got, want)


def test_autograd_screens_equal_their_kernel_entries_without_a_gradient():
    """With no input needing a gradient the entry is the plain kernel call
    (the trainers' path), and under autograd the forward is the same."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(2, M, D)).astype(np.float32))
    adj = torch.from_numpy(topo().adjacency)
    y0 = grad_ops.trimmed_mean(w, adj, w, 1)
    x = w.clone().requires_grad_(True)
    y1 = grad_ops.trimmed_mean(x, adj, x, 1)
    assert y0.grad_fn is None and y1.grad_fn is not None and torch.equal(y0, y1.detach())


@pytest.mark.parametrize("rule", ["trimmed_mean", "krum"])
def test_inner_max_crafted_rows_match_the_reference(rule):
    """``inner_max`` through the cell's own screen over 3 ticks from a
    carried state: the crafted rows and the carried ``delta`` (the ascent's
    best) as the reference's."""
    rng = np.random.default_rng(6)
    adj = topo().adjacency
    jadv, adv = jp.get_adversary("inner_max"), tp.get_adversary("inner_max")
    jctx = jp.AdvCtx(screen=lambda wb: jscreening.screen_all_banked(
        wb, jnp.asarray(adj), (rule,), 0, 2, self_vals=wb))
    ref = jax.jit(lambda st, th, w, bz: jadv.fn(jctx, st, th, w, bz, jax.random.PRNGKey(0), 0))
    ctx = tp.AdvCtx(screen=lambda wb: screening.screen_all_banked(
        wb, torch.from_numpy(adj), (rule,), (0,), (2,), self_vals=wb))
    theta = np.asarray(jadv.default_theta, np.float32)
    jst, st = jp.init_state(D), tp.init_state(D, lead=(1,), device="cpu")
    w = rng.normal(size=(M, D)).astype(np.float32)
    for _ in range(3):
        w = (w + 0.1 * rng.normal(size=(M, D))).astype(np.float32)
        jrow, jst = ref(jst, jnp.asarray(theta), jnp.asarray(w), jnp.asarray(BYZ))
        row, st = adv.fn(ctx, st, theta[None], torch.from_numpy(w)[None],
                         torch.from_numpy(BYZ)[None], prng.PRNGKey(0), 0)
        close(row[0], jrow)
        np.testing.assert_array_equal(st.dir[0].numpy(), np.asarray(jst.dir))


@pytest.mark.parametrize("rule,names,net", [
    ("trimmed_mean", ("inner_max", "alie_online"), False), ("krum", ("inner_max",), False),
    ("trimmed_mean", ("dissensus", "equivocate"), True)])
def test_trainers_with_adversaries_follow_the_reference(targets, rule, names, net):
    """`BridgeTrainer` (synchronous) and `AsyncBridgeTrainer` under
    ``lossy_laggy`` (the message forms; the adversary sees the channel's
    latency), 3 ticks against the reference's (the other adversaries'
    functions: `test_adversary_functions_match_the_reference_over_ticks`)."""
    spec, jspec = get_scenario("lossy_laggy"), jscenarios.get_scenario("lossy_laggy")
    for name in names:
        kw = dict(rule=rule, num_byzantine=2, adversary=name, lam=1.0, t0=10.0)
        if net:
            jt = JAsyncTrainer(JAsyncConfig(topology=jerdos_renyi(M, 0.8, 2, seed=1),
                                            channel=jspec.channel,
                                            staleness_bound=jspec.staleness_bound, **kw), jqgrad)
            tt = AsyncBridgeTrainer(AsyncBridgeConfig(
                topology=topo(), channel=spec.channel, staleness_bound=spec.staleness_bound,
                **kw), qgrad, device="cpu")
        else:
            jt = JTrainer(JConfig(topology=jerdos_renyi(M, 0.8, 2, seed=1), **kw), jqgrad)
            tt = BridgeTrainer(BridgeConfig(topology=topo(), **kw), qgrad, device="cpu")
        js = jt.init(jreplicate({"w": jnp.zeros(D)}, M, perturb=0.1,
                                key=jax.random.PRNGKey(0)), seed=0)
        ts = tt.init(init_fn(0), seed=0)
        assert np.array_equal(tt.byz_mask.numpy(), np.asarray(jt.byz_mask))
        for _ in range(T):
            js, _ = jt.step(js, jnp.asarray(targets))
            ts, _ = tt.step(ts, torch.from_numpy(targets))
        close(ts.params["w"], js.params["w"])
        if ts.adv is not None:
            for got, want in zip(ts.adv, js.adv, strict=True):
                close(got, want)


def _trainer_run(engine, cell, targets):
    kw = dict(topology=engine.grid.topology, rule=cell.rule, num_byzantine=cell.b,
              attack=cell.attack, adversary=cell.adversary, lam=1.0, t0=10.0,
              byzantine_seed=cell.mask_seed)
    if engine.net_mode:
        spec = get_scenario(cell.scenario)
        sched = engine.runtime.schedule_for(cell.scenario)
        if engine.sparse:
            rt = SparseUnreliableRuntime(sched, spec.channel, staleness_bound=spec.staleness_bound,
                                         neighbors=engine.neighbors, device="cpu")
            tr = BridgeTrainer(BridgeConfig(**kw, sparse=True), qgrad, runtime=rt, device="cpu")
        else:
            tr = AsyncBridgeTrainer(AsyncBridgeConfig(**kw, channel=spec.channel,
                                                      staleness_bound=spec.staleness_bound,
                                                      schedule=sched), qgrad, device="cpu")
    else:
        tr = BridgeTrainer(BridgeConfig(**kw, sparse=engine.sparse), qgrad, device="cpu")
    if cell.theta is not None:
        tr.cell = tr.cell._replace(adv_theta=np.asarray([cell.theta], np.float32))
    st = tr.init(init_fn(cell.seed), seed=cell.seed)
    losses = []
    for _ in range(T):
        st, m = tr.step(st, targets)
        losses.append(m["loss"])
    return st, torch.stack(losses)


def _check_cells(engine, final, metrics, targets):
    for i, cell in enumerate(engine.cells):
        st, loss = _trainer_run(engine, cell, targets)
        assert torch.equal(final.params["w"][i], st.params["w"]), cell
        assert torch.equal(metrics["loss"][i], loss), cell
        if st.adv is not None:
            for got, want in zip(final.adv, st.adv, strict=True):
                assert torch.equal(got[i], want), cell


@pytest.mark.parametrize("net,sparse", [(False, False), (False, True), (True, False),
                                        (True, True)])
def test_grid_cells_with_adversaries_equal_their_trainer_runs(targets, net, sparse):
    """BRIDGE-T / M / K x every adaptive and protocol-level adversary, the
    grouped grid's cells each its own trainer run, bit for bit."""
    tg = torch.from_numpy(targets)
    grid = ExperimentGrid(topo(), ("trimmed_mean", "median", "krum"), ("none",), (2,), (0,),
                          adversaries=ADAPTIVE, scenarios=("lossy",) if net else None,
                          lam=1.0, t0=10.0)
    engine = GridEngine(grid, qgrad, sparse=sparse, num_ticks=T if net else None, device="cpu")
    final, metrics = engine.run(engine.init(init_fn), torch.stack([tg] * T))
    assert final.adv.mean.shape == (engine.num_cells, D)
    _check_cells(engine, final, metrics, tg)


def test_banked_adversary_grid_and_set_cells_change_thetas_without_a_rebuild(targets):
    """One banked step over mixed adversaries equals the grouped cells; then
    `set_cells` swaps in new thetas (and b) without building a step, and the
    run equals each cell's trainer under those thetas."""
    tg = torch.from_numpy(targets)
    batches = torch.stack([tg] * T)
    grid = ExperimentGrid(topo(), ("trimmed_mean",), ("none",), (1, 2), (0,),
                          adversaries=("ipm", "inner_max", "alie"), lam=1.0, t0=10.0)
    grouped = GridEngine(grid, qgrad, device="cpu")
    banked = GridEngine(grid, qgrad, group=False, device="cpu")
    fg, _ = grouped.run(grouped.init(init_fn), batches)
    fb, _ = banked.run(banked.init(init_fn), batches)
    assert torch.equal(fg.params["w"], fb.params["w"])
    built = grouped.num_steps_built
    cells = [c._replace(theta=(2.0, 0.5, 3.0, 0.5)) if c.adversary == "inner_max"
             else c._replace(theta=(4.0, 1.0, 0.0, 0.0)) if c.adversary == "ipm" else c
             for c in grouped.cells]
    grouped.set_cells(cells)
    assert grouped.num_steps_built == built
    final, metrics = grouped.run(grouped.init(init_fn), batches)
    assert not torch.equal(final.params["w"], fg.params["w"])
    _check_cells(grouped, final, metrics, tg)
    with pytest.raises(ValueError, match="THETA_DIM|entries"):
        grouped.set_cells([c._replace(theta=(1.0,)) for c in cells])
    plain = GridEngine(ExperimentGrid(topo(), ("trimmed_mean",), ("alie",), (2,)), qgrad,
                       device="cpu")
    with pytest.raises(ValueError, match="outside this engine"):
        plain.set_cells([Cell("trimmed_mean", "alie", 2, 0, adversary="ipm")])
