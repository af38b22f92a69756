"""Command-line entry points of the port: ``infer`` and ``serve``."""
