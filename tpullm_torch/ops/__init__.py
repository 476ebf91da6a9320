"""Tensor ops: quantized matmul, norms, RoPE, attention, sampling."""
