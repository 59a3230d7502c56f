"""DeltaDQ in PyTorch: the CUDA/H100 port of the ``repro`` JAX package.

The module tree mirrors ``repro``: each file's reference is the file of
the same path there. The package imports torch and numpy only — never
jax, never ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on the card the delta correction runs the
hand-written kernels under ``kernels/csrc/`` (design notes and C
interface in ``delta_spmm.cu``).
"""
