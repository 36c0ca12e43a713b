"""Batch transcoding on one torch device (counterpart of
iivision_tpu/parallel)."""
