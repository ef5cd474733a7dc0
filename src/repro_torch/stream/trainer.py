"""`StreamBridgeTrainer` — port of `repro.stream.trainer`: the
`BridgeTrainer` twin that screens parameter dicts block by block
(`repro_torch.stream.engine`) instead of flattening them.

It takes the same `BridgeConfig`; ``screen_chunk`` is the block width
(coordinates a block, blocks never spanning leaves), and ``sparse=True``
selects the gathered layout as on the flat path.  ``channel`` switches to
the streaming network path (per-edge drops and staleness over a per-block
mailbox).  The block partition is a property of the parameter dict, so the
step is built on the first `init` (again when a later `init` brings a
differently shaped dict).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from repro_torch import prng
from repro_torch.comm import codec as codec_lib
from repro_torch.comm import exchange
from repro_torch.core import byzantine, screening
from repro_torch.core.bridge import BridgeConfig, BridgeState, CellParams, CellTrainer, _one_cell
from repro_torch.core.neighbors import NeighborTable
from repro_torch.device import resolve_device
from repro_torch.net import mailbox as mb
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.stream.blocks import BlockSpec
from repro_torch.stream.engine import StreamChannelConfig, build_stream_cell_step
from repro_torch.trust import reputation as trust_lib


class StreamBridgeTrainer(CellTrainer):
    """Chunk-streaming BRIDGE over parameter dicts, on ``device``
    (``"cuda"`` by default).  ``init`` / ``step`` / ``run`` / ``run_chunks``
    as `BridgeTrainer`'s (`CellTrainer`'s loops); the bit-identity contracts against the flat
    trainer are `repro_torch.stream.engine`'s."""

    def __init__(self, config: BridgeConfig, grad_fn: Callable, *,
                 channel: StreamChannelConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        config.topology.validate_for_rule(config.rule)
        screening.check_streamable((config.rule,))
        if config.adversary != "none":
            raise NotImplementedError(
                "adaptive adversaries observe the full flat trajectory and are not supported on "
                "the streaming path; use BridgeTrainer")
        if channel is not None and config.trust is not None and config.trust.echo:
            raise ValueError(
                "the echo protocol digests whole messages and cannot stream; use "
                "TrustSpec(echo=False) with the streaming network path")
        self.config = config
        self.grad_fn = grad_fn
        self.channel = channel
        adj = config.topology.adjacency
        m = config.topology.num_nodes
        self.adjacency = torch.as_tensor(adj, dtype=torch.bool, device=self.device)
        self.byz_mask = byzantine.byzantine_nodes(m, config.num_byzantine, config.attack,
                                                  config.byzantine_seed, self.device)
        self.codec = codec_lib.get_codec(config.codec)
        self.attack = byzantine.get_attack(config.attack)
        self.wire_attack = byzantine.wire_attack_for(config.attack)
        # the network path is neighbor-indexed; the broadcast path follows
        # the config's sparse flag, as the flat trainer does
        self.neighbors = None
        if channel is not None or config.sparse:
            self.neighbors = NeighborTable.from_adjacency(adj, device=self.device)
        self.cell = CellParams((0,), (0,), (config.num_byzantine,), self.byz_mask[None],
                               (config.lam,), (config.t0,), (config.lr,), codec_idx=(0,),
                               metrics=config.metrics)
        self.spec: BlockSpec | None = None
        self._cell_step = None

    @property
    def honest_mask(self) -> torch.Tensor:
        return ~self.byz_mask

    def _build(self, params: dict) -> None:
        spec = BlockSpec.from_params(params, self.config.screen_chunk)
        if self.spec is not None and spec == self.spec:
            return
        self.spec = spec
        cfg = self.config
        self._cell_step = build_stream_cell_step(
            _one_cell(self.grad_fn), spec, self.adjacency, (cfg.rule,), (self.attack,),
            codecs=(cfg.codec,), wire_attacks=(self.wire_attack,), neighbors=self.neighbors,
            channel=self.channel, trace=cfg.trace, trust=cfg.trust)

    def init(self, params: dict, seed: int = 0) -> BridgeState:
        """The state at tick 0: the key ``PRNGKey(seed)``, a zero codec carry
        per leaf for a lossy codec, empty per-block mailboxes on the network
        path, and the trace's, trust's and metrics' fresh states."""
        m = self.config.topology.num_nodes
        for k, leaf in params.items():
            if leaf.shape[0] != m:
                raise ValueError(f"params[{k!r}] leading axis {leaf.shape[0]} != num_nodes {m}")
        params = {k: v.to(self.device) for k, v in params.items()}
        self._build(params)
        sizes = tuple(p.size for p in self.spec.leaves)
        comm = None
        if not self.codec.lossless:
            # one carry a sender and leaf (a broadcast codeword a block)
            comm = tuple(exchange.init_residual((m, s), self.codec, device=self.device)
                         for s in sizes)
        net = None
        if self.channel is not None:
            net = mb.init_block_mailbox(m, sizes, width=self.neighbors.k, device=self.device)
        width = m if self.neighbors is None else self.neighbors.k
        cfg = self.config
        return BridgeState(
            params=params, t=0, key=prng.PRNGKey(seed), comm=comm, net=net,
            obs=obs_trace.init_state(cfg.trace, m, width, device=self.device),
            trust=trust_lib.init_state(cfg.trust, m, width, device=self.device),
            mets=obs_metrics.init_state(cfg.metrics, device=self.device))

    def step(self, state: BridgeState, batch: Any) -> tuple[BridgeState, dict]:
        """One tick over the trainer's one cell (E = 1), the step built
        from ``state.params`` first if no `init` built it."""
        if self._cell_step is None:
            self._build(state.params)
        return super().step(state, batch)
