"""Host-side native helpers: the player VM (playback verification) and the
C++ resize, quantize, dither and emit passes."""

from iivision_tpu_torch.sim.player_vm import PlayerVM  # noqa: F401
