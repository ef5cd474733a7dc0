"""The gather tile kernel's plan (`repro_torch.kernels.gather_screen.tile_plan`)
on the CPU: what the card runs is decided here, so the plan is held to the
kernel's limits without a card.

* every node and every coordinate chunk of a launch falls to exactly one
  block (`block_work`, the kernel's own split of its grid);
* the plan fits the kernel at the worst case (a tile's slots fill its
  prologue, one slot a thread; the kernel's shared memory is static, about
  11 KB a block, so the compiler holds it within a block's limit), and its
  blocks fill about one wave of the card's 132 SMs;
* the plan is a function of the shape alone;
* it refuses what the kernel cannot take.
"""
import dataclasses

import pytest

from repro_torch.kernels import gather_screen as gs

SHAPES = [(512, 16, 7850), (512, 20, 7850), (300, 3, 999), (50, 63, 1000), (7, 0, 33),
          (1000, 40, 130), (1, 1, 1), (4097, 63, 7850)]


@pytest.mark.parametrize("median", [False, True])
@pytest.mark.parametrize("row_bytes", [4, 1])
@pytest.mark.parametrize("m,k,d", SHAPES)
def test_every_node_and_chunk_is_covered_once(m, k, d, row_bytes, median):
    for plan in {gs.tile_plan(m, k, d, row_bytes, median),
                 *gs.candidates(m, k, d, row_bytes, median)}:
        seen = {}
        for block in range(plan.grid(m)):
            nodes, chunks = gs.block_work(plan, m, d, block)
            for j in nodes:
                for c in chunks:
                    seen[j, c] = seen.get((j, c), 0) + 1
        chunks = -(-d // plan.chunk)
        assert seen == {(j, c): 1 for j in range(m) for c in range(chunks)}, plan


@pytest.mark.parametrize("median", [False, True])
@pytest.mark.parametrize("row_bytes", [4, 1])
# every bucket boundary of the register networks (K and K + 1 rows) and
# the two-column limit (K + 1 = 32)
@pytest.mark.parametrize("k", [0, 1, 2, 7, 8, 15, 16, 17, 20, 23, 24, 31, 32, 40, 47, 48, 63])
def test_plan_fits_the_kernel_at_the_worst_case(k, row_bytes, median):
    m, d = 512, 7850
    plan = gs.tile_plan(m, k, d, row_bytes, median)
    gs.check_tile_plan(plan, m, k, d, row_bytes, median)
    # every slot of the tile a thread of the prologue, valid or not
    assert plan.tile * k <= gs.MAX_TILE_SLOTS and plan.tile <= gs.MAX_TILE_NODES
    assert plan.chunk in gs.CHUNKS and 128 % plan.chunk == 0
    assert plan.cols == (2 if median and row_bytes == 4 and k <= 16 else 1)
    # about one wave: no more blocks than the SMs hold at once, unless a
    # tile alone needs more
    tiles = -(-m // plan.tile)
    held = gs.SMS * gs.BLOCKS_PER_SM
    assert plan.grid(m) <= max(held, tiles)
    assert plan.grid(m) > held // 2 or plan.segments == -(-d // plan.chunk)


def test_plan_is_a_function_of_the_shape():
    keys = [(*shape, rb, med) for shape in SHAPES for rb in (4, 1) for med in (False, True)]
    plans = {key: gs.tile_plan(*key) for key in keys}
    gs.tile_plan.cache_clear()
    assert {key: gs.tile_plan(*key) for key in keys} == plans
    # the main path's shapes: K = 16 on small_world(512, 6, 2), K = 20 on
    # small_world(512, 8, 2): 4 nodes and 128 coordinates a block for float
    # rows, 4 blocks a tile (512 blocks), two columns a lane for the float
    # median up to K = 16; 16 nodes and 64 coordinates for codeword rows
    # where 16 x K slots fit the prologue
    for k in (16, 20):
        assert plans[512, k, 7850, 4, False] == gs.TilePlan(4, 128, 4)
    assert plans[512, 16, 7850, 4, True] == gs.TilePlan(4, 128, 4, cols=2)
    assert plans[512, 20, 7850, 4, True] == gs.TilePlan(4, 128, 4)
    for med in (False, True):
        assert plans[512, 16, 7850, 1, med] == gs.TilePlan(16, 64, 16)
        assert plans[512, 20, 7850, 1, med] == gs.TilePlan(4, 128, 4)


@pytest.mark.parametrize("m,k,d,row_bytes", [(0, 4, 10, 4), (10, 4, 0, 4),
                                             (10, gs.MAX_SLOTS + 1, 10, 4), (10, -1, 10, 4),
                                             (10, 4, 10, 2)])
def test_plan_refuses_shapes_the_kernel_does_not_take(m, k, d, row_bytes):
    with pytest.raises(ValueError):
        gs.tile_plan(m, k, d, row_bytes)


@pytest.mark.parametrize("plan", [
    gs.TilePlan(0, 32, 1), gs.TilePlan(33, 32, 1), gs.TilePlan(16, 48, 1),
    gs.TilePlan(16, 256, 1), gs.TilePlan(16, 16, 1), gs.TilePlan(16, 32, 0),
    gs.TilePlan(16, 32, 247), gs.TilePlan(32, 32, 1), gs.TilePlan(17, 32, 1),
    gs.TilePlan(8, 32, 1, cols=2), gs.TilePlan(8, 64, 1, cols=3),
    gs.TilePlan(8, 64, 1, cols=0)])
def test_check_refuses_plans_the_kernel_does_not_take(plan):
    # K = 16 over d = 7850 (246 chunks of 32): 17 or 32 nodes x 16 slots
    # overflow the prologue's 256, a chunk is 32, 64 or 128 coordinates,
    # two columns a lane need 64 coordinates
    with pytest.raises(ValueError):
        gs.check_tile_plan(plan, 512, 16, 7850, 4, median=True)


@pytest.mark.parametrize("k,row_bytes,median", [(16, 4, False), (16, 1, False), (16, 1, True),
                                                 (32, 4, True)])
def test_two_columns_a_lane_are_the_float_median_s_only(k, row_bytes, median):
    """Two columns a lane: the float median of up to 32 rows (K + 1) only;
    two arrays of 64 would spill."""
    plan = gs.TilePlan(4, 64, 4, cols=2)
    for taken in (16, 31):
        gs.check_tile_plan(plan, 512, taken, 7850, 4, median=True)
        gs.check_tile_plan(dataclasses.replace(plan, chunk=128), 512, taken, 7850, 4,
                           median=True)
    with pytest.raises(ValueError):
        gs.check_tile_plan(plan, 512, k, 7850, row_bytes, median)
    assert gs.plan_for(4, 64, 512, k, 7850, row_bytes, median, cols=2) is None


def test_cpu_path_runs_the_plain_version():
    """The plan steers the kernel only: on the CPU the wrapper runs the
    plain version and launches nothing."""
    import torch

    w = torch.zeros(20, 40)
    idx = torch.zeros(20, 4, dtype=torch.int32)
    valid = torch.ones(20, 4, dtype=torch.bool)
    out = gs.gather_screen_trimmed_mean(w, idx, valid, w, 1)
    assert out.shape == (20, 40)
    assert gs.gather_screen_trimmed_mean.launches == 0
