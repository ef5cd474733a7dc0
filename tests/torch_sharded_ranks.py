"""The port's side of `tests/test_torch_sharded.py`: the sharded gossip and
train step (`repro_torch.core.gossip`, `repro_torch.launch.steps`) on gloo
ranks, torch on one thread a rank.

    python tests/torch_sharded_ranks.py DIR

``DIR`` holds ``inputs.npz`` and ``cases.json`` (written by the test).
Four ranks spawned with `torch.multiprocessing` run every case on its mesh
of four ranks and write their blocks to ``DIR/rank<r>.npz``; then this
process runs a world of one (``DIR/world1.npz``).  A case the port refuses
stores its error message under ``<case>|raised``.  Imports torch and the
port only.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gossip import gossip_screen_params  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402

KEY, TICK = 7, 3  # the random attack's key and tick


def leaf_specs(nax) -> dict:
    """The gossip cases' two leaves: ``a [M, 6, 10]`` and ``b [M, 12]``,
    their last dim over ``"model"``."""
    lead = sharding.spec_entry(tuple(nax))
    return {"a": (lead, None, "model"), "b": (lead, "model")}


def gossip_case(case: dict, inputs, mesh) -> dict:
    m = case["M"]
    nax = tuple(case["node_axes"])
    specs = leaf_specs(nax)
    blocks = {k: sharding.local_shard(torch.from_numpy(inputs[f"{case['src']}/{k}"]), specs[k],
                                      mesh)
              for k in specs}
    byz = np.zeros(m, bool)
    byz[case["byz"]] = True
    try:
        out = gossip_screen_params(
            blocks, specs, mesh=mesh, node_axes=nax, rule=case["rule"], b=case["b"],
            adjacency=torch.from_numpy(inputs[f"M{m}/adj"]), schedule=case["schedule"],
            byz_mask=torch.from_numpy(byz), attack=case["attack"], key=prng.PRNGKey(KEY),
            t=TICK, quantize=case["quantize"])
    except ValueError as e:
        return {f"{case['name']}|raised": np.array(str(e))}
    return {f"{case['name']}|{k}": v.numpy() for k, v in out.items()}


def train_case(case: dict, inputs, mesh) -> dict:
    cfg = get_config("qwen3-4b").reduced()
    m = case["M"]
    nax = tuple(case["node_axes"])
    full = {k[len("train/"):]: v for k, v in inputs.items() if k.startswith("train/")}
    toks = full.pop("tokens")
    shapes = {k: v.shape for k, v in full.items()}
    specs = sharding.param_specs(cfg, shapes, node_axes=nax)
    params = {k: sharding.local_shard(torch.from_numpy(v), specs[k], mesh) for k, v in full.items()}
    bspec = sharding.train_batch_specs({"tokens": toks.shape}, nax)["tokens"]
    batch = {"tokens": sharding.local_shard(torch.from_numpy(toks), bspec, mesh)}
    step = make_train_step(cfg, mesh, nax, specs, torch.from_numpy(inputs[f"M{m}/adj"]),
                           rule="trimmed_mean", num_byzantine=1)
    out = {}
    for t in range(2):
        params, met = step(params, {"tokens": batch["tokens"][:, t]}, t)
        out[f"{case['name']}|loss{t}"] = np.asarray(float(met["loss"]), np.float32)
    out.update({f"{case['name']}|{k}": v.numpy() for k, v in params.items()})
    return out


def run_cases(world: int, inputs, cases) -> dict:
    out = {}
    meshes = {}
    for case in cases:
        if case["world"] != world:
            continue
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = mesh_lib.make_mesh_compat(shape, tuple(case["axes"]), device="cpu")
        fn = train_case if case["kind"] == "train" else gossip_case
        out.update(fn(case, inputs, meshes[shape]))
    return out


def _rank(rank: int, path: str, world: int) -> None:
    torch.set_num_threads(1)
    mesh_lib.init_world("cpu", rank=rank, world_size=world,
                        store_path=os.path.join(path, "store"))
    try:
        inputs = dict(np.load(os.path.join(path, "inputs.npz")))
        with open(os.path.join(path, "cases.json")) as f:
            cases = json.load(f)
        np.savez(os.path.join(path, f"rank{rank}.npz"), **run_cases(world, inputs, cases))
    finally:
        mesh_lib.close_world()


def main(path: str) -> None:
    t0 = time.perf_counter()
    mp.spawn(_rank, args=(path, 4), nprocs=4, join=True)
    t1 = time.perf_counter()
    torch.set_num_threads(1)
    mesh_lib.init_world("cpu")
    try:
        inputs = dict(np.load(os.path.join(path, "inputs.npz")))
        with open(os.path.join(path, "cases.json")) as f:
            cases = json.load(f)
        np.savez(os.path.join(path, "world1.npz"), **run_cases(1, inputs, cases))
    finally:
        mesh_lib.close_world()
    print(f"four ranks {t1 - t0:.1f} s, one rank {time.perf_counter() - t1:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1])
