"""Hand-written CUDA kernels (``csrc/*.cu``), their ctypes wrappers and plain versions."""
