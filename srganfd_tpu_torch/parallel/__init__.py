"""Inference-time parallelism of the port (tiled inference)."""
