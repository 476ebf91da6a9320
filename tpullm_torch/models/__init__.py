"""Model definitions, weights and GGUF synthesis."""
