"""Side tools: hash checker, file cutter, task submission, user scripts
(parity with the reference's BatchHashChecker / FileCutter / AddTask /
ScriptCommand / UserScriptExecuter utilities), and the in-build encoder
shims: x264-style (tools/x264_shim.py) and AAC (tools/aac_shim.py) command
lines over the in-process FFmpeg bridge, which pipeline/settings.py
substitutes for a missing encoder binary.

The port's counterpart of amatsukaze_tpu/tools/__init__.py."""
