"""Host utilities of the port: background writers, run-dir logging,
TensorBoard events, image grids and the finite-stats guard."""
