"""stage.output_pass_fps: the encode files' source frames over the seconds
of the program's `filter.output` spans (the output pass: VFR synthesis on
the card, the fetch, and the hand-over to the encoder's pipe)."""

from pb.program_trace import frame_rate


def read(run):
    return frame_rate(run, "filter.output")
