"""tpullm_torch: the PyTorch/CUDA port of tpullm for NVIDIA Hopper (H100).

Mirrors tpullm's module paths. Imports torch and numpy only: nothing of JAX
and nothing of the tpullm package. Entry points run on CUDA unless the caller
passes device="cpu"; the hand-written kernels live in csrc/ and
ops/kernels/, each beside its plain PyTorch version.
"""
