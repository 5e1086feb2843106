"""repro_torch: GQ-Fast (Fast In-Memory SQL Analytics on Graphs) on PyTorch
and CUDA for NVIDIA Hopper.

The counterpart of the JAX package ``repro``, module for module: the same SQL
front end, planner and lowered IR, interpreted over torch tensors, with every
hop running through a hand-written CUDA kernel on the card and through its
plain PyTorch version on the CPU. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
