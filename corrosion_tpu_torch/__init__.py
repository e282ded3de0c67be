"""PyTorch and CUDA port of the ``corrosion_tpu`` scale round for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package stays the reference: the same config, key and inputs give
the same state planes bit for bit. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when CUDA is absent; nothing
falls back to the CPU on its own. On CUDA tensors the kernel wrappers in
``ops/megakernel.py`` launch the hand-written kernels under ``csrc/``; on
CPU tensors they run their plain PyTorch versions.
"""
