"""Hand-written CUDA kernels (screening of float rows and of int8 codewords, int8 decode,
pairwise distances) and their plain PyTorch versions.

Nothing here compiles on import: `build` runs ``nvcc`` at the first launch.
"""
