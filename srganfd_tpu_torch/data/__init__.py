"""Image I/O helpers of the port."""
