"""Plain PyTorch references of what the cells time (no kernel, no import of
the port)."""
