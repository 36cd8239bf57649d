"""Host I/O: the intermediate MPEG-2 PS writer (y4m, wave and the
encoder/muxer drivers come with the encode side).

The port's copy of amatsukaze_tpu/io/__init__.py, which also names those."""
