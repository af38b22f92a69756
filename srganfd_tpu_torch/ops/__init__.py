"""Tensor ops of the port (PyTorch, NCHW inside the models)."""
