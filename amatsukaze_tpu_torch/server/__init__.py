"""Encode server: queue, profiles, scheduling, RPC (reference:
AmatsukazeServer/Server/* -> asyncio TCP with JSON frames).

The port's copy of amatsukaze_tpu/server/: every queued transcode and every
logo scan runs on the CUDA card."""
