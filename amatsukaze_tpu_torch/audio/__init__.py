"""AAC audio decode (in-build libfaad replacement).

The port's copy of amatsukaze_tpu/audio/__init__.py."""
