"""Tools that read what the port's kernels compile to."""
