"""PyTorch/CUDA port of the BRIDGE package (`repro`), for one NVIDIA H100.

The port mirrors `repro`'s module names so each module's JAX counterpart is
easy to find (``repro_torch.core.screening`` <-> ``repro.core.screening``).
It imports ``torch``, ``numpy`` and ``scipy`` only: never ``jax`` and never
anything of ``repro``, so it runs on a machine that has neither.

Every entry point takes ``device=`` and defaults to ``"cuda"``; a missing
card raises instead of falling back (`repro_torch.device.resolve_device`).
The CPU runs the plain PyTorch twins of the kernels and is what the parity
tests use (``device="cpu"``).

TF32 is switched OFF on import: ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are both set to ``False``, so float32
products on the card keep full float32 precision (the reference runs float32
on the CPU).

The kernels are hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc/``:
the dense and the gather screens, the int8 decode and the pairwise
distances of BRIDGE-K and BRIDGE-B), compiled with
``nvcc`` at first use on the card (`repro_torch.kernels.build`); importing
the package compiles nothing.  Random numbers are the reference's Threefry
streams (`repro_torch.prng`).
"""
from repro_torch.device import resolve_device, set_numerics

set_numerics()

__all__ = ["resolve_device", "set_numerics"]
