"""In-build AAC encoder: WAV on stdin -> ADTS AAC file.

Accepts the argument shapes the pipeline generates for qaac / fdkaac /
neroAacEnc (pipeline/settings.make_audio_encoder_args) and encodes
through the in-process libavcodec AAC encoder, so audio transcode works
with no external encoder binary.

Run as `python -m amatsukaze_tpu_torch.tools.aac_shim <encoder-style args>`.

The port's copy of amatsukaze_tpu/tools/aac_shim.py.
"""

from __future__ import annotations

import struct
import sys


def parse_args(argv: list[str]) -> dict:
    opts = {"out": "", "bitrate": 0}
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i] if i < len(argv) else ""

        if a in ("-o", "-of"):
            opts["out"] = val()
        elif a in ("-b", "-br", "-a"):  # fdkaac / neroAac / qaac bitrate
            v = val()
            try:
                opts["bitrate"] = int(float(v))
            except ValueError:
                pass
        elif a in ("-if",):
            val()  # neroAac input ('-')
        i += 1
    return opts


def read_wav_header(f):
    """-> (channels, sample_rate, bits); positions f at the data."""
    riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a WAV stream")
    channels = rate = bits = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            fmt = f.read(size)
            channels = struct.unpack("<H", fmt[2:4])[0]
            rate = struct.unpack("<I", fmt[4:8])[0]
            bits = struct.unpack("<H", fmt[14:16])[0]
        elif cid == b"data":
            return channels, rate, bits
        else:
            f.read(size)


def main(argv=None) -> int:
    import numpy as np

    from ..video.avdec import AvAacEncoder, avdec_available

    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if not opts["out"]:
        print("aac_shim: no output path", file=sys.stderr)
        return 1
    if not avdec_available():
        print("aac_shim: FFmpeg bridge unavailable", file=sys.stderr)
        return 2
    src = sys.stdin.buffer
    channels, rate, bits = read_wav_header(src)
    if bits != 16:
        print(f"aac_shim: unsupported bit depth {bits}", file=sys.stderr)
        return 3
    enc = AvAacEncoder(rate, channels,
                       opts["bitrate"] or 192000)
    n = 0
    with open(opts["out"], "wb") as out:
        while True:
            raw = src.read(4096 * 2 * channels)
            if not raw:
                break
            pcm = np.frombuffer(raw[:len(raw) - len(raw) %
                                    (2 * channels)], "<i2")
            pcm = pcm.reshape(-1, channels)
            out.write(enc.encode(pcm))
            n += len(pcm)
        out.write(enc.flush())
    print(f"aac_shim: encoded {n} samples", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
