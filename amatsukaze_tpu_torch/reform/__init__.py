from .stream_reform import (
    AudioDiffInfo,
    EncodeFileOutput,
    FileAudioFrameInfo,
    FileVideoFrameInfo,
    FilterSourceFrame,
    OutVideoFormat,
    StreamEvent,
    StreamEventType,
    StreamReformInfo,
)

__all__ = [
    "AudioDiffInfo",
    "EncodeFileOutput",
    "FileAudioFrameInfo",
    "FileVideoFrameInfo",
    "FilterSourceFrame",
    "OutVideoFormat",
    "StreamEvent",
    "StreamEventType",
    "StreamReformInfo",
]
