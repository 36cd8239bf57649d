"""In-build encoder shims: x264-style (tools/x264_shim.py) and AAC
(tools/aac_shim.py) command lines over the in-process FFmpeg bridge, which
pipeline/settings.py substitutes for a missing encoder binary.

The port's counterpart of amatsukaze_tpu/tools/__init__.py (the JAX
package's other side tools are not ported)."""
