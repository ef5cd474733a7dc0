"""The wide screening path (``csrc/screen_wide.cuh``): the trimmed mean and
the median over more rows than the register kernels sort — above 128 rows
for the dense screens (`trimmed_mean`, `median`, `dequant_screen`), above
`gather_screen.MAX_SLOTS` table slots for the gather screens — up to
`MAX_ROWS`.  It computes the register kernels' arithmetic (each column
sorted by a warp in registers, the kept ranks summed left to right), so it
stands in for rows 1-3 and 6-8 of the kernel table at those sizes.

The screens' wrappers decide the route and call `launch`, which counts the
launches of every wide entry point in one ``launch.launches``; the decide
form's wrappers (`screen_decide`) call `launch_decide`, the wide path's
``kDecide`` form (the same sort and sum, then each listed row decided
against its columns' kept windows), counted in ``launch_decide.launches``.
"""
from __future__ import annotations

from repro_torch.kernels import build, networks

# Rows a wide block sorts, at most (csrc/screen_wide.cuh kWideMaxRows): a
# warp's 32 lanes of 64 registers.
MAX_ROWS = networks.WARP * networks.WARP_REGS[-1]


def _launch(entry: str, rows: int, args: tuple) -> None:
    if rows > MAX_ROWS:
        raise ValueError(f"{entry}: the wide screening kernel sorts at most {MAX_ROWS} rows, "
                         f"got {rows}")
    err = getattr(build.load(), entry)(*args)
    build.check_launch(err, entry)


def launch(entry: str, rows: int, *args) -> None:
    """Launch the wide entry point ``entry`` of the kernels' library with
    ``args``, for up to ``rows`` rows to sort a node; raises above
    `MAX_ROWS` or on a failed launch."""
    _launch(entry, rows, args)
    launch.launches += 1


def launch_decide(entry: str, rows: int, *args) -> None:
    """`launch` for the wide decide entry points (``*_wide_*_decide``)."""
    _launch(entry, rows, args)
    launch_decide.launches += 1


launch.launches = 0
launch_decide.launches = 0
