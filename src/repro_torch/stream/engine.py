"""The chunk-streaming BRIDGE iteration — port of `repro.stream.engine`:
screen parameter dicts block by block, never forming the flat ``[M, d]``
matrix.

One tick runs the phases of `repro_torch.core.bridge.build_cell_step`
(attack -> codec -> (exchange ->) screen -> apply -> obs / trust /
metrics), but attack, codec, screen and apply run inside a loop over each
leaf's coordinate blocks (`repro_torch.stream.blocks.BlockSpec`), each
leaf's tail block at its exact size, and every block's update is written
into that leaf's output buffer in the leaf's own dtype.  Blocks of a bf16
leaf are upcast to float32, as the reference does.  On the card every
block is one launch of the layout's screening kernel: the dense screens
(rows 1-2 of the kernel table), the gather tile kernel on the sparse
layout (row 3), the views kernels on the network path, their decide forms
under trust or forensics.  A block of a 2-D leaf is a strided column
slice; it is copied to a contiguous ``[M, c]`` buffer before the attack
(the screens take contiguous rows), which stays inside the reference's
peak of ``[M, K, c]``.

Bit-identity contract (the reference's, held by
``tests/test_torch_stream.py``):

* **Single block** (one leaf, ``chunk >= d``): the block's key is the
  step's subkey itself, so every rule x attack x codec, stochastic ones
  included, equals the flat trainer bit for bit.
* **Many blocks**: block i draws under ``fold_in(sub, i)``, so the random
  draws differ from the flat path's by construction; every deterministic
  attack and codec still matches bit for bit, since the coordinate-wise
  rules and the per-coordinate attacks decompose over blocks.

Codecs apply per block (`repro_torch.comm.exchange.wire_bits_blocks`): each
block is its own codeword with its own error-feedback slice.

The network path (``channel``) replaces the broadcast by a per-edge drop
and staleness channel over `repro_torch.net.mailbox.BlockMailboxState`: one
arrival event per edge and tick (every block of a message travels
together), per-block payload writes, the Table-II fallback.  With no drops
it equals the streaming broadcast wherever every node clears its rule's
minimum.

Refused at build time, as in the reference: rules whose blockwise result
differs (`screening.check_streamable`: Krum, Bulyan, geomedian,
clipped_mean), adaptive adversaries and, on the network path, the echo
protocol (`repro_torch.stream.trainer`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch import prng
from repro_torch.comm import codec as codec_lib
from repro_torch.comm import exchange
from repro_torch.core import byzantine, screening
from repro_torch.core.bridge import (NET_SALT, BridgeState, CellParams, _need, _per_cell,
                                     apply_attack_bank, cell_step_size, decide_stride,
                                     fold_metric_ring, wire_stage)
from repro_torch.core.neighbors import NeighborTable
from repro_torch.net import mailbox as mb
from repro_torch.obs import trace as obs_trace
from repro_torch.stream.blocks import BlockSpec
from repro_torch.trust import reputation as trust_lib


@dataclasses.dataclass(frozen=True)
class StreamChannelConfig:
    """The streaming network path's channel: per-receiver drops over a
    broadcast medium (every neighbor of a sender sees the same codeword;
    whether it arrives is per edge), with a staleness bound on what
    screening may still use.  ``drop_prob=0`` is the ideal channel."""

    drop_prob: float = 0.0
    staleness_bound: int = 4


def _block(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """Columns ``[start, start + size)`` of ``x [.., s]`` as a contiguous
    float32 buffer (a bf16 leaf upcast)."""
    return x[..., start:start + size].to(torch.float32).contiguous()


def build_stream_cell_step(grad_fn: Callable, spec: BlockSpec, adjacency: torch.Tensor,
                           rules: tuple[str, ...], attacks, *,
                           codecs: tuple[str, ...] = ("identity",), wire_attacks=None,
                           neighbors: NeighborTable | None = None,
                           channel: StreamChannelConfig | None = None, trace=None, trust=None):
    """The streaming twin of `build_cell_step` (``channel`` None) and of
    the runtime step (``channel`` set): ``step(cell, state, batch)`` over
    the block partition ``spec``, with the banks, ``trace`` and ``trust`` of
    `build_cell_step` and ``cell.metrics`` its metric ring.

    ``state`` holds ``params`` ``[E, M, ...]``, the codec carry per leaf
    (``comm``: a tuple of `CommState` ``[E, M, s]``, a lossy codec), on the
    network path a `BlockMailboxState` with a leading ``[E]`` (``net``, its
    ``values`` per leaf), and the trace's, trust's and metrics' states of
    `build_cell_step`.  ``neighbors`` screens on the sparse layout (the
    gather kernels); the network path needs it (its mailboxes are ``[M,
    K]``)."""
    screening.check_streamable(rules)
    if channel is not None and neighbors is None:
        raise ValueError("the streaming network path is neighbor-indexed: pass a NeighborTable")
    codec_bank = codec_lib.codec_bank(codecs)
    if wire_attacks is None:
        wire_attacks = (byzantine.WIRE_ATTACKS["none"],) * len(attacks)
    skip_wire = (exchange.bank_is_lossless(codec_bank)
                 and all(a.name == "none" for a in wire_attacks))
    static_live = neighbors.valid_dev.bool() if neighbors is not None else adjacency.bool()
    n_edges = float(torch.sum(static_live.to(torch.float32)))
    d = spec.total_dim
    single_block = spec.num_blocks == 1
    decide = trust is not None or (trace is not None and trace.forensics)
    stride = decide_stride(trace, trust) if trust is not None else (
        trace.decide_stride if decide else 1)

    def screen(what, wb, cell, mask_eff, views, evicted, weights):
        """One block's screen: ``(y, trim)`` (``trim`` None off the decide
        path)."""
        if channel is not None:
            if decide:
                return screening.screen_views_decide_banked(
                    views, mask_eff, wb, rules, cell.rule_idx, cell.b, decide_stride=stride,
                    weights=weights)
            return screening.screen_views_banked(views, mask_eff, wb, rules, cell.rule_idx,
                                                 cell.b), None
        mask = None if evicted is None else static_live & ~evicted
        if neighbors is not None:
            if decide:
                return screening.screen_gathered_decide_banked(
                    what, neighbors, rules, cell.rule_idx, cell.b, self_vals=wb, valid=mask,
                    decide_stride=stride, weights=weights, folded=evicted is None)
            return screening.screen_gathered_banked(what, neighbors, rules, cell.rule_idx,
                                                    cell.b, self_vals=wb), None
        if decide:
            return screening.screen_all_decide_banked(
                what, adjacency if mask is None else mask, rules, cell.rule_idx, cell.b,
                self_vals=wb, decide_stride=stride, weights=weights, folded=evicted is None)
        return screening.screen_all_banked(what, adjacency, rules, cell.rule_idx, cell.b,
                                           self_vals=wb), None

    def step(cell: CellParams, state: BridgeState, batch) -> tuple[BridgeState, dict]:
        e = cell.num_cells
        dev = cell.byz_mask.device
        keys = prng.split(state.key)  # [E, 2, 2] on the host
        key, sub = keys[:, 0], keys[:, 1]
        with torch.profiler.record_function("stream.grad"):
            losses, grads = grad_fn(state.params, batch)
        rho = cell_step_size(cell.lam, cell.t0, cell.lr, state.t)
        rho_t = _per_cell(rho, dev)
        x_mats, g_mats = spec.leaf_mats(state.params, lead=1), spec.leaf_mats(grads, lead=1)
        # each leaf's gradient is released once its blocks are applied, so a
        # tick holds the gradients and the new parameters together one leaf
        # at a time, not whole (the full-width model's peak)
        del grads
        gn_sq = 0
        hm = ~cell.byz_mask  # [E, M]
        hcnt = torch.sum(hm, dim=-1).to(torch.float32)
        weights = evicted = None
        if trust is not None:
            weights = trust_lib.edge_weights(trust, state.trust)
            evicted = state.trust.evicted
        byz_edge_all = (neighbors.gather_senders(cell.byz_mask, fill=False)
                        if neighbors is not None
                        else cell.byz_mask[:, None, :].expand(e, *static_live.shape))
        # the network path: one channel event per edge and tick, shared by
        # every block of the tick's message
        arrived = send_tick = enough = None
        mask_live = static_live.expand(e, *static_live.shape)
        if channel is not None:
            net_key = prng.fold_in(sub, NET_SALT)
            shape = tuple(static_live.shape)
            u = (prng.uniform(net_key[0], shape, dev)[None] if e == 1
                 else prng.uniform(net_key, (e, *shape), dev))
            arrived = static_live & (u >= channel.drop_prob)
            send_tick = mb.stamp(state.net.send_tick, arrived, state.t)
            mask_live = static_live & (send_tick > mb.NEVER) & (
                send_tick >= state.t - channel.staleness_bound)
        mask_eff = mask_live if evicted is None else mask_live & ~evicted
        if channel is not None:
            need = screening.min_neighbors_banked(rules, cell.rule_idx, cell.b)
            enough = torch.sum(mask_eff, dim=-1) >= _need(need, dev)
            obs_live = mask_eff & enough[..., None]
        else:
            obs_live = mask_live
        obs_live_f = obs_live.to(torch.float32)
        trim_acc = (torch.zeros(mask_live.shape, dtype=torch.float32, device=dev) if decide
                    else None)
        cons_sq = torch.zeros((e, spec.num_nodes), dtype=torch.float32, device=dev)
        comm_in = (None,) * len(spec.leaves) if state.comm is None else tuple(state.comm)
        mats_out, comm_out, vals_out, block_trims = [], [], [], []
        for li, plan in enumerate(spec.leaves):
            x2d, g2d = x_mats[li], g_mats[li]
            g_mats[li] = None
            if cell.metrics is not None:
                g32 = g2d.to(torch.float32)
                gn_sq = gn_sq + torch.sum(g32 * g32, dim=-1)
            y_buf = torch.empty_like(x2d)  # every column is written by one block
            comm_leaf = comm_in[li]
            if comm_leaf is not None:
                comm_leaf = exchange.CommState(*(a.clone() for a in comm_leaf))
            vals_leaf = state.net.values[li].clone() if channel is not None else None
            for gid, start, size in plan.blocks(spec.chunk):
                kb = sub if single_block else prng.fold_in(sub, gid)
                xb = _block(x2d, start, size)
                with torch.profiler.record_function("stream.attack"):
                    wb = apply_attack_bank(attacks, cell.attack_idx, xb, cell.byz_mask, kb,
                                           state.t)
                with torch.profiler.record_function("stream.codec"):
                    if skip_wire:
                        what = wb
                    else:
                        blk = (None if comm_leaf is None else
                               exchange.CommState(*(a[..., start:start + size].contiguous()
                                                    for a in comm_leaf)))
                        what, blk = wire_stage(codec_bank, wire_attacks, cell, kb, wb, blk,
                                               cell.byz_mask, state.t)
                        if blk is not None:
                            for full, part in zip(comm_leaf, blk, strict=True):
                                full[..., start:start + size] = part
                views = None
                if channel is not None:
                    with torch.profiler.record_function("stream.exchange"):
                        mb.push_block(vals_leaf, neighbors.gather_rows(what, lead=1), arrived,
                                      start)
                        views = vals_leaf[..., start:start + size]
                with torch.profiler.record_function("stream.screen"):
                    y_b, trim_b = screen(what, wb, cell, mask_eff, views, evicted, weights)
                    if channel is not None:
                        # a node short of its rule's minimum keeps its own value
                        y_b = torch.where(enough[..., None], y_b, wb)
                with torch.profiler.record_function("stream.apply"):
                    w_new = y_b - rho_t * _block(g2d, start, size)
                    y_buf[..., start:start + size] = w_new.to(y_buf.dtype)
                    mu = torch.sum(torch.where(hm[..., None], w_new, 0.0), dim=-2) / hcnt[:, None]
                    dev_sq = torch.where(hm[..., None], w_new - mu[:, None, :], 0.0)
                    cons_sq = cons_sq + torch.sum(dev_sq * dev_sq, dim=-1)
                if decide:
                    trim_acc = trust_lib.accumulate_trim(trim_acc, trim_b, size / d)
                    block_trims.append(obs_trace.obs_trim_frac(trim_b, obs_live))
            mats_out.append(y_buf)
            comm_out.append(comm_leaf)
            vals_out.append(vals_leaf)

        new_comm = None if state.comm is None else tuple(comm_out)
        new_net = state.net
        if channel is not None:
            new_net = mb.BlockMailboxState(send_tick=send_tick, values=tuple(vals_out))
        bits = exchange.wire_bits_blocks(codec_bank, cell.codec_idx or None, spec.block_sizes())
        bits = float(bits) if not isinstance(bits, tuple) else bits
        live_edges = (torch.sum(mask_live, dim=(-2, -1)).to(torch.float32)
                      if channel is not None else n_edges)
        resid = 0.0
        carries = [c for c in comm_out if c is not None]
        if carries:
            resid = torch.sqrt(sum(torch.sum((c.resid * c.resid).reshape(e, -1), dim=-1)
                                   for c in carries))
        metrics = {
            "loss": torch.sum(torch.where(hm, losses, 0.0), dim=-1) / hcnt,
            "consensus_dist": torch.sqrt(torch.amax(cons_sq, dim=-1)),
            "rho": rho,
            "wire_bits_per_edge": bits,
            "wire_bytes_total": bits / 8.0 * live_edges,
            "ef_residual_norm": resid,
        }
        if cell.metrics is not None:
            # summed leaf by leaf: the flat [M, d] gradient never forms
            gn = torch.sqrt(gn_sq)
            metrics["grad_norm"] = torch.sum(torch.where(hm, gn, 0.0), dim=-1) / hcnt
        if channel is not None:
            metrics["delivered_frac"] = (torch.sum(arrived.to(torch.float32), dim=(-2, -1))
                                         / max(n_edges, 1.0))
            stale = torch.where(mask_live, state.t - send_tick, 0)
            metrics["mean_staleness"] = (
                torch.sum(stale.to(torch.float32), dim=(-2, -1))
                / torch.clamp(torch.sum(mask_live, dim=(-2, -1)), min=1).to(torch.float32))
            metrics["screened_frac"] = torch.mean(enough.to(torch.float32), dim=-1)
            metrics["usable_in"] = torch.mean(torch.sum(mask_eff, dim=-1).to(torch.float32),
                                              dim=-1)
        if decide:
            metrics["obs_trim_frac"] = obs_trace.obs_trim_frac(trim_acc, obs_live)
            metrics[obs_trace.BLOCK_TRIM_STREAM] = torch.stack(block_trims, dim=-1)
        new_obs = state.obs
        if trace is not None:
            with torch.profiler.record_function("stream.obs"):
                trim_o = live_o = byz_o = None
                if decide:
                    live_o = obs_live
                    trim_o = torch.where(live_o, trim_acc, 0.0) if channel is not None else trim_acc
                    byz_o = byz_edge_all & live_o if channel is not None else byz_edge_all
                new_obs = obs_trace.update(
                    trace, state.obs, t=state.t, loss=metrics["loss"],
                    consensus=metrics["consensus_dist"], trim_frac=trim_o, live=live_o,
                    byz_edge=byz_o,
                    staleness=obs_trace.staleness_of(new_net, state.t) if channel else None,
                    wire_bits=bits, live_edges=live_edges, d=d)
        new_trust = state.trust
        if trust is not None:
            with torch.profiler.record_function("stream.trust"):
                screened = mask_eff & enough[..., None] if channel is not None else mask_eff
                new_trust = trust_lib.update(trust, state.trust, t=state.t,
                                             trim_frac=torch.where(screened, trim_acc, 0.0),
                                             live=mask_eff)
                metrics["trust_evicted_frac"] = torch.mean(
                    new_trust.evicted.to(torch.float32), dim=(-2, -1))
        stale_m = None
        if channel is not None:
            stale_m = torch.where(mask_live, state.t - send_tick, 0)
        mets = fold_metric_ring(cell.metrics, state, metrics, staleness=stale_m,
                                live=mask_live if channel is not None else None)
        return BridgeState(spec.unflatten(mats_out, lead=1), state.t + 1, key, new_comm,
                           new_net, state.adv, new_obs, new_trust, mets), metrics

    return step
