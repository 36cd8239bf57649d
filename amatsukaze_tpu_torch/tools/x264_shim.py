"""In-build x264-compatible encoder: y4m on stdin -> H.264 Annex B.

Accepts the argument shape the pipeline generates for a real x264
binary (pipeline/settings.make_encoder_args) and encodes through the
in-process libx264 bridge (native/avdec.cpp), so a full transcode
produces REAL H.264 output in environments with no encoder binaries.
Unknown x264 options are accepted and ignored (geometry/fps/interlace
come from the y4m header; --crf/--preset/--bitrate are honoured).

Run as `python -m amatsukaze_tpu_torch.tools.x264_shim <x264-style args>`.

The port's copy of amatsukaze_tpu/tools/x264_shim.py.
"""

from __future__ import annotations

import sys


def parse_args(argv: list[str]) -> dict:
    # field_order: None = take from the y4m header; "tff"/"bff" when
    # the encoder command line overrides it explicitly (x264 semantics:
    # --tff/--bff force interlaced encode with that field order).
    opts = {"out": "", "crf": 21, "preset": "veryfast", "field_order": None,
            "bitrate": 0, "codec": "libx264", "threads": 0}
    i = 0
    while i < len(argv):
        a = argv[i]

        def val():
            nonlocal i
            i += 1
            return argv[i] if i < len(argv) else ""

        if a in ("-o", "-b") and opts["codec"] == "libsvtav1":
            opts["out"] = val()
        elif a == "-o":
            opts["out"] = val()
        elif a == "--shim-codec":
            opts["codec"] = val()
        elif a == "--crf":
            opts["crf"] = int(round(float(val())))
        elif a == "--preset":
            opts["preset"] = val()
        elif a == "--bitrate":
            opts["bitrate"] = int(val())
        elif a == "--threads":
            opts["threads"] = max(0, int(val()))  # 0 = auto (x264 semantics)
        elif a == "--tff":
            opts["field_order"] = "tff"
        elif a == "--bff":
            opts["field_order"] = "bff"
        elif a in ("--pass", "--stats", "--colorprim", "--transfer",
                   "--colormatrix", "--demuxer", "--vbv-bufsize",
                   "--vbv-maxrate", "--zones", "--tcfile-in",
                   "--timebase", "--qp", "--level", "--profile",
                   "--keyint", "--min-keyint", "--output-depth"):
            val()  # option with an argument: accepted, ignored
        # bare flags (e.g. --stitchable, '-') are accepted and ignored
        i += 1
    return opts


def build_encoder(opts: dict, width: int, height: int, fps_num: int,
                  fps_den: int, interlaced: bool, tff: bool,
                  bit_depth: int = 8):
    """AvVideoEncoder from parsed shim options (shared between the
    subprocess shim and the pipeline's in-process encode path)."""
    import os

    from ..video.avdec import AvVideoEncoder

    # adaptive encoder threading: the production encode path scales to
    # the host's cores (x264 --threads semantics, 0 = auto); fixture
    # generation goes through AvVideoEncoder directly and stays
    # single-threaded/deterministic
    threads = opts["threads"] or (os.cpu_count() or 1)
    extra = ""
    preset = opts["preset"]
    if opts["codec"] == "libx264":
        # no force-cfr: this image's libx264 rejects the key ("Key
        # 'force-cfr' not found" once per encode, which polluted the
        # round-4 bench tail), and it is redundant here anyway — the
        # shim's input is fixed-fps y4m and the bridge stamps monotonic
        # CFR PTS itself, so output timing is CFR by construction
        parts = []
        if interlaced:
            parts.append("tff=1" if tff else "bff=1")
        if opts["bitrate"]:
            parts.append(f"bitrate={opts['bitrate']}")
        if threads > 1:
            parts.append(f"threads={threads}")
        extra = ":".join(parts)
    elif opts["codec"] == "libx265":
        if threads > 1:
            extra = f"pools={threads}"
    elif opts["codec"] == "libsvtav1":
        preset = "8"  # SVT presets are numeric
    return AvVideoEncoder(
        width, height, fps_num=fps_num, fps_den=fps_den,
        crf=opts["crf"], preset=preset,
        interlaced=interlaced, x264_params=extra,
        codec=opts["codec"], bit_depth=bit_depth)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = parse_args(argv)
    if not opts["out"]:
        print("x264_shim: no -o output path", file=sys.stderr)
        return 1
    from ..io.y4m import Y4MReader
    from ..video.avdec import avdec_available

    if not avdec_available():
        print("x264_shim: FFmpeg bridge unavailable", file=sys.stderr)
        return 2
    reader = Y4MReader(sys.stdin.buffer)
    fmt = reader.fmt
    # Explicit --tff/--bff overrides the y4m header (x264 semantics);
    # otherwise the header's interlace flag + field order win.
    interlaced = fmt.interlaced or opts["field_order"] is not None
    tff = (opts["field_order"] != "bff") if opts["field_order"] else fmt.tff
    # 10-bit y4m (Main10 pass-through) encodes at 10 bits when the
    # encoder supports it (x265/SVT); deeper post-chain depths downshift
    native10 = fmt.bits == 10 and opts["codec"] in ("libx265", "libsvtav1")
    enc = build_encoder(opts, fmt.width, fmt.height, fmt.fps_num,
                        fmt.fps_den, interlaced, tff,
                        bit_depth=10 if native10 else 8)
    import numpy as np

    shift = 0 if native10 else max(fmt.bits - 8, 0)
    n = 0
    with open(opts["out"], "wb") as out:
        for y, u, v in reader.frames():
            if shift:  # high-bit-depth y4m from the post chain
                rnd = 1 << (shift - 1)
                y = ((y + rnd) >> shift).clip(0, 255).astype(np.uint8)
                u = ((u + rnd) >> shift).clip(0, 255).astype(np.uint8)
                v = ((v + rnd) >> shift).clip(0, 255).astype(np.uint8)
            for pkt in enc.encode(y, u, v):
                out.write(pkt)
            n += 1
        for pkt in enc.flush():
            out.write(pkt)
    print(f"x264_shim: encoded {n} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
