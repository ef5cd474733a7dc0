"""repro_torch.stream — chunk-streaming BRIDGE over parameter dicts (port
of `repro.stream`).

Screens a model under attack without forming `stack_flatten`'s flat
``[M, d]`` matrix: a `BlockSpec` cuts every leaf of the stacked parameter
dict into coordinate blocks, and the tick runs attack -> codec -> (exchange
->) screen -> apply block by block, each block one launch of the layout's
screening kernel on the card.  See `repro_torch.stream.engine` for the
bit-identity contracts against the flat path.
"""
from repro_torch.stream.blocks import BlockSpec, LeafPlan
from repro_torch.stream.engine import StreamChannelConfig, build_stream_cell_step
from repro_torch.stream.trainer import StreamBridgeTrainer

__all__ = ["BlockSpec", "LeafPlan", "StreamBridgeTrainer", "StreamChannelConfig",
           "build_stream_cell_step"]
