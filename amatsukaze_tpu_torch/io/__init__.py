"""Host I/O: y4m, wave, subprocess encoder/muxer drivers, frame pump.

The port's copy of amatsukaze_tpu/io/__init__.py."""
