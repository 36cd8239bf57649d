"""parse.split_fps: the recordings' source frames (the video frames the
split found) over the seconds of the program's `split` spans (the TS demux
into the intermediate PS, the audio and wave files; the card is idle)."""

from pb.program_trace import frame_rate


def read(run):
    return frame_rate(run, "split")
