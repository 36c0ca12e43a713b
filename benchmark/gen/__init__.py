"""The benchmark's traffic generators (copied from the port's bench, so
that a change to the program cannot change the inputs)."""
