"""Hop kernels for Hopper and their plain PyTorch versions.

``ops`` is the dispatch every caller uses: CPU tensors take the plain version
(:mod:`.ref`), CUDA tensors the hand-written CUDA kernel (:mod:`.fragment_spmv`).
"""
