"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` into an object, all sources at
once in parallel, and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads; nothing includes PyTorch's
headers, so a build takes seconds.  The build happens at first use, never
on import, into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), under a file name keyed on a hash of every source and
header in ``csrc/`` and of the sorting networks (`networks.header`, written
into ``build/repro_torch/include/`` before the compile): an edit to one
builds a new library, an unchanged tree reuses the last one.

No ``--use_fast_math``: the kernels rely on IEEE adds, division,
multiplication and fused multiply-adds to equal their plain PyTorch
versions bit for bit.  ``-Xptxas -v`` writes each kernel's registers and
spills next to the library (`ptxas_report`), each source's compile
headed by its seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels import networks

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of each entry point: pointers and the stream as void*, sizes as int
SIGNATURES = {
    # the float screens take the experiment axis: after b (and recip) the
    # experiments E, the mask's experiment stride and, for the trimmed
    # mean, the [E] int32 b (or null)
    "screen_trimmed_mean_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _I64,
                                  _PTR, _PTR),
    "screen_median_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _I64, _PTR),
    # the gather tile kernels: the operands, then the plan's tile, chunk,
    # segments and columns a lane (gather_screen.tile_plan)
    "gather_screen_trimmed_mean": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                   _INT, _I64, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "gather_screen_median": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _I64,
                             _INT, _INT, _INT, _INT, _PTR),
    "dequant_screen_trimmed_mean_dense": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                          _PTR),
    "dequant_screen_median_dense": (_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "gather_dequant_screen_trimmed_mean": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                                           _INT, _INT, _INT, _INT, _INT, _INT, _PTR),
    "gather_dequant_screen_median": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                                     _INT, _INT, _INT, _INT, _PTR),
    "dequant": (_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "dequant_carry": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR),
    "pairwise_sq_dists": (_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR),
    # x, its batch and row strides, self_vals (or null) and its stride, out,
    # B, n, d, then the plan
    "pairwise_sq_dists_batched": (_PTR, _I64, _I64, _PTR, _I64, _PTR) + (_INT,) * 6 + (_PTR,),
    # the batch body: the same operands, then the plan's splits and their length
    "pairwise_sq_dists_batch_body": (_PTR, _I64, _I64, _PTR, _I64, _PTR) + (_INT,) * 5 + (_PTR,),
    # the wide path (screen_wide.cuh): the register entries' operands
    "screen_wide_trimmed_mean_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT,
                                       _I64, _PTR, _PTR),
    "screen_wide_median_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _I64, _PTR),
    "dequant_screen_wide_trimmed_mean_dense": (_PTR,) * 5 + (_INT,) * 4 + (_PTR,),
    "dequant_screen_wide_median_dense": (_PTR,) * 5 + (_INT,) * 3 + (_PTR,),
    "gather_screen_wide_trimmed_mean": (_PTR,) * 5 + (_INT,) * 5 + (_I64, _PTR, _PTR),
    "gather_screen_wide_median": (_PTR,) * 5 + (_INT,) * 4 + (_I64, _PTR),
    "gather_dequant_screen_wide_trimmed_mean": (_PTR,) * 6 + (_INT,) * 5 + (_PTR,),
    "gather_dequant_screen_wide_median": (_PTR,) * 6 + (_INT,) * 4 + (_PTR,),
    # the views screens (views_screen.cu): views, its cell, node and slot
    # strides, mask, self_vals, out, M, W, d (b), the experiment operands
    # (E, the mask's cell stride, the per-cell b or null), then the tile
    # entries' plan
    "views_screen_trimmed_mean": (_PTR, _I64, _I64, _I64) + (_PTR,) * 3 + (_INT,) * 5
    + (_I64, _PTR) + (_INT,) * 4 + (_PTR,),
    "views_screen_median": (_PTR, _I64, _I64, _I64) + (_PTR,) * 3 + (_INT,) * 4 + (_I64,)
    + (_INT,) * 4 + (_PTR,),
    "views_screen_wide_trimmed_mean": (_PTR, _I64, _I64, _I64) + (_PTR,) * 3 + (_INT,) * 5
    + (_I64, _PTR, _PTR),
    "views_screen_wide_median": (_PTR, _I64, _I64, _I64) + (_PTR,) * 3 + (_INT,) * 4
    + (_I64, _PTR),
    # the views screens' backward (views_screen_grad.cu): views and its three
    # strides, mask and its cell stride, (the median's self_vals,) gy,
    # g_views, g_self, E, M, W, d, (the trimmed mean's b and [E] b or null)
    "views_screen_grad_trimmed_mean": (_PTR, _I64, _I64, _I64, _PTR, _I64) + (_PTR,) * 3
    + (_INT,) * 5 + (_PTR, _PTR),
    "views_screen_grad_median": (_PTR, _I64, _I64, _I64, _PTR, _I64) + (_PTR,) * 4
    + (_INT,) * 4 + (_PTR,),
    # the decide forms (screen_decide.cu, gather_screen_decide.cu,
    # views_screen_decide.cu): the float entries' operands with the int32
    # counts after out, the stride after the experiment operands, then the
    # tile entries' plan (tile, chunk, segments)
    "screen_trimmed_mean_dense_decide": (_PTR,) * 5 + (_INT,) * 4 + (_I64, _PTR, _INT, _PTR),
    "screen_median_dense_decide": (_PTR,) * 5 + (_INT,) * 3 + (_I64, _INT, _PTR),
    "gather_screen_trimmed_mean_decide": (_PTR,) * 6 + (_INT,) * 5 + (_I64, _PTR)
    + (_INT,) * 4 + (_PTR,),
    "gather_screen_median_decide": (_PTR,) * 6 + (_INT,) * 4 + (_I64,) + (_INT,) * 4 + (_PTR,),
    "views_screen_trimmed_mean_decide": (_PTR, _I64, _I64, _I64) + (_PTR,) * 4 + (_INT,) * 5
    + (_I64, _PTR) + (_INT,) * 4 + (_PTR,),
    "views_screen_median_decide": (_PTR, _I64, _I64, _I64) + (_PTR,) * 4 + (_INT,) * 4
    + (_I64,) + (_INT,) * 4 + (_PTR,),
    # the wide path's decide form (screen_wide.cuh, kDecide): the register
    # decide entries' operands, without the tile entries' plan
    "screen_wide_trimmed_mean_dense_decide": (_PTR,) * 5 + (_INT,) * 4 + (_I64, _PTR, _INT, _PTR),
    "screen_wide_median_dense_decide": (_PTR,) * 5 + (_INT,) * 3 + (_I64, _INT, _PTR),
    "gather_screen_wide_trimmed_mean_decide": (_PTR,) * 6 + (_INT,) * 5 + (_I64, _PTR, _INT,
                                                                             _PTR),
    "gather_screen_wide_median_decide": (_PTR,) * 6 + (_INT,) * 4 + (_I64, _INT, _PTR),
    "views_screen_wide_trimmed_mean_decide": (_PTR, _I64, _I64, _I64) + (_PTR,) * 4
    + (_INT,) * 5 + (_I64, _PTR, _INT, _PTR),
    "views_screen_wide_median_decide": (_PTR, _I64, _I64, _I64) + (_PTR,) * 4 + (_INT,) * 4
    + (_I64, _INT, _PTR),
}


def sources() -> list[Path]:
    """The kernel sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("repro_torch kernels: nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels build only where the toolkit is")


@functools.cache
def source_hash() -> str:
    """Hash of the sources and flags, read once per process."""
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(networks.header().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libscreen-{source_hash()}.so"


def build() -> float:
    """Compile the library unless the current sources already have one;
    returns the seconds spent (0.0 when it was already built)."""
    lib = library_path()
    if lib.exists():
        return 0.0
    nvcc = _nvcc()
    include = BUILD_DIR / "include"
    include.mkdir(parents=True, exist_ok=True)
    stem = lib.with_suffix(f".{os.getpid()}")
    gen = include / f"{networks.HEADER}.{os.getpid()}"
    gen.write_text(networks.header())
    os.replace(gen, include / networks.HEADER)
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = stem.with_name(f"{stem.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(include), "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    # one thread a compile reads its output and notes when it ended, so the
    # report gives each source's seconds (the slowest sets the build's)
    outputs: dict[int, tuple[str, float]] = {}

    def drain(i: int, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        outputs[i] = (out, time.perf_counter() - t0)

    threads = [threading.Thread(target=drain, args=(i, proc)) for i, (_, _, proc) in
               enumerate(jobs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    report, failed = [], []
    for i, (cmd, _, proc) in enumerate(jobs):
        out, secs = outputs[i]
        report.append(f"# {Path(cmd[-1]).name}: {secs:.1f} s\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = stem.with_name(f"{stem.name}.so.tmp")
        link = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    lib.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, lib)
    return time.perf_counter() - t0


def ptxas_report() -> str:
    """What ``-Xptxas -v`` printed for the current library's build."""
    return library_path().with_suffix(".ptxas.txt").read_text()


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with typed entry points
    (loaded once per process; a launch costs no file access)."""
    build()
    cdll = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return cdll


def check_launch(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_rows(w: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate the screened values: float32 contiguous ``w`` and
    ``self_vals`` of one shape ``[M, d]``, or ``[E, M, d]`` over the
    experiment axis, on one device."""
    if w.dtype != torch.float32 or self_vals.dtype != torch.float32:
        raise TypeError(f"screening takes float32, got w {w.dtype}, self_vals {self_vals.dtype}")
    if w.ndim not in (2, 3) or self_vals.shape != w.shape:
        raise ValueError(f"w {tuple(w.shape)} and self_vals {tuple(self_vals.shape)} must be one "
                         f"[M, d] or [E, M, d]")
    if not (w.is_contiguous() and self_vals.is_contiguous()):
        raise ValueError("screening operands must be contiguous")
    if w.device != self_vals.device:
        raise ValueError(f"operands on different devices: {w.device}, {self_vals.device}")


MAX_EXPERIMENTS = 65535  # a grid dimension (csrc/screen_sort.cuh kMaxExperiments)


def check_b(b, w: torch.Tensor) -> None:
    """Validate a screen's Byzantine bound: an int >= 0, or, over the
    experiment axis (``w [E, M, d]``), an int32 tensor ``[E]`` on ``w``'s
    device (its values are the caller's to keep >= 0: the kernels and the
    plain versions trim nothing for a negative one)."""
    if isinstance(b, torch.Tensor):
        if w.ndim != 3 or b.dtype != torch.int32 or b.shape != w.shape[:1] or b.device != w.device:
            raise ValueError(f"a per-experiment b is an int32 [E] tensor on the operands' device "
                             f"beside [E, M, d] rows, got {b.dtype} {tuple(b.shape)} on "
                             f"{b.device} for rows {tuple(w.shape)}")
        if not b.is_contiguous():
            raise ValueError("b must be contiguous")
    elif int(b) < 0:
        raise ValueError(f"b must be >= 0, got {b}")


def experiments(w: torch.Tensor, mask: torch.Tensor, b=None) -> tuple:
    """The experiment operands of a float screen's entry point: the count E
    (1 for ``[M, d]`` rows), the mask's experiment stride (0 for one mask
    every experiment shares, else a mask ``[E, ...]`` of its own each) and,
    with ``b`` (the trimmed mean), the scalar b ahead of them and the
    per-experiment ``[E]`` bounds' pointer after (None: every experiment
    takes the scalar)."""
    e = 1 if w.ndim == 2 else w.shape[0]
    if not 1 <= e <= MAX_EXPERIMENTS:
        raise ValueError(f"a screen takes 1 to {MAX_EXPERIMENTS} experiments, got {e}")
    s_mask = mask.stride(0) if mask.ndim == 3 else 0
    if b is None:
        return e, s_mask
    if isinstance(b, torch.Tensor):
        return 0, e, s_mask, b.data_ptr()
    return int(b), e, s_mask, None


def check_mask(mask: torch.Tensor, w: torch.Tensor, shape: tuple, what: str) -> None:
    """Validate a screen's mask: contiguous bool/uint8 of ``shape`` (one
    every experiment shares) or, over the experiment axis (``w [E, M, d]``),
    ``[E, *shape]``, on ``w``'s device."""
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{what} must be bool or uint8, got {mask.dtype}")
    if tuple(mask.shape) != shape and not (w.ndim == 3 and tuple(mask.shape) == (w.shape[0], *shape)):
        raise ValueError(f"{what} {tuple(mask.shape)} must be {list(shape)}"
                         f"{' or [E, ...]' if w.ndim == 3 else ''}")
    if not mask.is_contiguous():
        raise ValueError("screening operands must be contiguous")
    if mask.device != w.device:
        raise ValueError(f"operands on different devices: {w.device}, {mask.device}")


def check_screen_args(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate the dense screening operands: `check_rows`, and a
    contiguous bool/uint8 ``[M, M]`` mask (or ``[E, M, M]``, one an
    experiment) on the same device."""
    check_rows(w, self_vals)
    m = w.shape[-2]
    check_mask(adj, w, (m, m), "adjacency")


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the C entry points take it."""
    return torch.cuda.current_stream(x.device).cuda_stream
