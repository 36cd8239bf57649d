"""entry.transcode_fps: the source frames of the window's recordings over
the wall time from the window's start to the last recording's end, on the
host's clock (one recording after another through the entry)."""


def read(run):
    return run.window.fps if run.window.recordings else None
