"""Hand-written CUDA kernels (screening, int8 decode, pairwise distances) and their plain
PyTorch versions.

Nothing here compiles on import: `build` runs ``nvcc`` at the first launch.
"""
