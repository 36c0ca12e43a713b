"""Torch ops and the kernel wrappers of the port."""
