"""stage.kfm_analysis_fps: the encode files' source frames over the
seconds of the program's `filter.analysis` spans (the KFM analysis pass:
erase, field-match costs on the card, the decisions and the VFR plan)."""

from pb.program_trace import frame_rate


def read(run):
    return frame_rate(run, "filter.analysis")
