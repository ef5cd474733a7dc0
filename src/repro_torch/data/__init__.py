from repro_torch.data.mnist_like import make_mnist_like
from repro_torch.data.partition import (
    partition_extreme_noniid,
    partition_iid,
    partition_moderate_noniid,
    stack_node_batches,
)

__all__ = [
    "make_mnist_like",
    "partition_iid", "partition_extreme_noniid", "partition_moderate_noniid",
    "stack_node_batches",
]
