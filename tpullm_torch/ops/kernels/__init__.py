"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. The CUDA sources are in tpullm_torch/csrc/; they build with
nvcc at first use (see _build.py)."""
