"""The vectorized bit packers and gather builders the host codec uses."""
