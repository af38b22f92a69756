"""Command-line entry points of the port: ``infer``, ``serve`` and ``train``."""
