"""repro_torch.sim — task assembly, the variants table and the batched
experiment-grid engine (port of `repro.sim`, synchronous and
network-scenario grids):

* `grid` — `ExperimentGrid` / `Cell` specs (axes, tags, topology helpers).
* `engine` — `GridEngine`: stacked ``[E, M, D]`` state driven by the
  cell-parameterized step `BridgeTrainer` binds, every screening kernel
  launching once a tick for a group of cells; `GridNetRuntime`, the
  scenario-banked runtime of a net grid.
* `results` — `GridResult`: the record the resumable sweep store holds,
  in the reference's JSON schema.
"""
from repro_torch.sim.engine import GridEngine, GridNetRuntime, stack_batches
from repro_torch.sim.grid import Cell, ExperimentGrid, default_topology, pick_byz_mask
from repro_torch.sim.results import GridResult, cell_of, collect, existing_tags, load_cell_store

__all__ = [
    "GridEngine", "GridNetRuntime", "stack_batches",
    "Cell", "ExperimentGrid", "default_topology", "pick_byz_mask",
    "GridResult", "cell_of", "collect", "existing_tags", "load_cell_store",
]
