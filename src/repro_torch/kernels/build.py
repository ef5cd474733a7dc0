"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles the sources for ``sm_90a`` into a shared library with a
plain C interface, which ``ctypes`` loads; nothing includes PyTorch's
headers, so a build takes seconds.  The build happens at first use, never on
import, into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), under a file name keyed on a hash of the sources: an edit
to a source builds a new library, an unchanged tree reuses the last one.

No ``--use_fast_math``: the kernels rely on IEEE adds, division and
multiplication to equal their plain PyTorch versions bit for bit.
``-Xptxas -v`` writes each kernel's registers and spills next to the
library (`ptxas_report`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("screen.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C signature of each entry point: pointers and the stream as void*, sizes as int
SIGNATURES = {
    "screen_trimmed_mean_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR),
    "screen_median_dense": (_PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR),
}


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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return seconds


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


def check_screen_args(w: torch.Tensor, adj: torch.Tensor, self_vals: torch.Tensor) -> None:
    """Validate the dense screening operands: float32 contiguous ``w`` and
    ``self_vals`` of one shape ``[M, d]``, a contiguous bool/uint8 ``[M, M]``
    mask, all on one device."""
    if w.dtype != torch.float32 or self_vals.dtype != torch.float32:
        raise TypeError(f"screening takes float32, got w {w.dtype}, self_vals {self_vals.dtype}")
    if adj.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"adjacency must be bool or uint8, got {adj.dtype}")
    if w.ndim != 2 or self_vals.shape != w.shape:
        raise ValueError(f"w {tuple(w.shape)} and self_vals {tuple(self_vals.shape)} must be one [M, d]")
    m = w.shape[0]
    if adj.shape != (m, m):
        raise ValueError(f"adjacency {tuple(adj.shape)} must be [{m}, {m}]")
    if not (w.is_contiguous() and adj.is_contiguous() and self_vals.is_contiguous()):
        raise ValueError("screening operands must be contiguous")
    if not (w.device == adj.device == self_vals.device):
        raise ValueError(f"operands on different devices: {w.device}, {adj.device}, {self_vals.device}")
