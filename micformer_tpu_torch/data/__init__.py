"""Volume I/O."""
