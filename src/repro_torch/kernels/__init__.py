"""Hand-written CUDA screening kernels and their plain PyTorch versions.

Nothing here compiles on import: `build` runs ``nvcc`` at the first launch.
"""
