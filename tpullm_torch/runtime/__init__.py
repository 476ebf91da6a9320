"""Inference runtime: KV cache and engine."""
