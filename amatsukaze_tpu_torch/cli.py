"""Command-line interface.

Parity: AmatsukazeCLI (Amatsukaze/AmatsukazeCLI.hpp:25-720): same flag set
(-i/-o/-s/-w/-et/-e/-eo/-b/-bcm/--2pass/--splitsub/-aet/-ae/-aeo/-fmt/-m/-t/
--mp4box/-f/-pf/--chapter/--subtitles/--logo/--erase-logo/--drcs/...), same
modes (ts/cm/drcs/probe_subtitles/probe_audio), and the reference's distinct
exit codes: 100 = no logo, 101 = unmapped DRCS (AmatsukazeCLI.hpp:670-677).

The port's counterpart of amatsukaze_tpu/cli.py, with the same flags and
exit codes. It runs on the CUDA card and raises RuntimeError where none is
present; `main(argv, device="cpu")` runs the kernels' plain PyTorch
versions (the tests). `--devices N` shards the filter pass over N cards.

    python -m amatsukaze_tpu_torch.cli -i src.ts -o out -e x264 --mode ts
"""

from __future__ import annotations

import argparse
import sys

from .pipeline.settings import (
    AudioEncoder,
    BitrateSetting,
    Config,
    Encoder,
    OutputFormat,
    Settings,
)
from .pipeline.transcode import ensure_cuda_backend
from .utils.context import AMTContext, NoDrcsMapError, NoLogoError

EXIT_NO_LOGO = 100
EXIT_NO_DRCS = 101


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="amatsukaze-tpu",
        description="CUDA-native automated MPEG2-TS transcoder",
    )
    p.add_argument("-i", "--input", required=False, help="input TS path")
    p.add_argument("-o", "--output", default="", help="output path (no extension)")
    p.add_argument("-s", "--serviceid", "--serivceid", default=None,
                   help="service id to process (decimal or 0xHEX)")
    p.add_argument("-w", "--work", default="./", help="temp dir [./]")
    p.add_argument("-et", "--encoder-type", default="x264",
                   choices=["x264", "x265", "QSVEnc", "NVEnc", "VCEEnc", "SVT-AV1"])
    p.add_argument("-e", "--encoder", default="x264", help="encoder path")
    p.add_argument("-eo", "--encoder-option", default="", help="encoder options")
    p.add_argument("-b", "--bitrate", default=None,
                   help="bitrate formula a:b:f -> kbps = f*(a*s+b)")
    p.add_argument("-bcm", "--bitrate-cm", type=float, default=0.5)
    p.add_argument("--2pass", dest="two_pass", action="store_true")
    p.add_argument("--splitsub", action="store_true")
    p.add_argument("-aet", "--audio-encoder-type", default="",
                   choices=["", "neroAac", "qaac", "fdkaac"])
    p.add_argument("-ae", "--audio-encoder", default="")
    p.add_argument("-aeo", "--audio-encoder-option", default="")
    p.add_argument("-abk", "--audio-bitrate", type=int, default=0)
    p.add_argument("-fmt", "--format", default="mp4",
                   choices=["mp4", "mkv", "m2ts", "ts"])
    p.add_argument("-m", "--muxer", default="muxer")
    p.add_argument("-t", "--timelineeditor", default="timelineeditor")
    p.add_argument("--mp4box", default="mp4box")
    p.add_argument("-f", "--filter", default="", dest="filter_script")
    p.add_argument("-pf", "--postfilter", default="", dest="post_filter_script")
    p.add_argument("--chapter", action="store_true")
    p.add_argument("--subtitles", action="store_true")
    p.add_argument("--nicojk", action="store_true")
    p.add_argument("--logo", action="append", default=[])
    p.add_argument("--erase-logo", action="append", default=[])
    p.add_argument("--drcs", default="", help="DRCS mapping file path")
    p.add_argument("--ignore-no-drcsmap", action="store_true")
    p.add_argument("--ignore-no-logo", action="store_true")
    p.add_argument("--ignore-nicojk-error", action="store_true")
    p.add_argument("--no-delogo", action="store_true")
    p.add_argument("--loose-logo-detection", action="store_true")
    p.add_argument("--max-fade-length", type=int, default=16)
    p.add_argument("--jls-cmd", default="")
    p.add_argument("--jls-option", default="")
    p.add_argument("--trimavs", default="")
    p.add_argument("-om", "--cmoutmask", type=int, default=1)
    p.add_argument("--nicojk18", action="store_true")
    p.add_argument("--nicojklog", action="store_true")
    p.add_argument("--nicojkmask", type=int, default=1)
    p.add_argument("--no-remove-tmp", action="store_true")
    p.add_argument("--timefactor", type=float, default=0.25)
    p.add_argument("--pmt-cut", default="0:0",
                   help="head:tail CM-recognition rate budget")
    p.add_argument("-j", "--json", default="", dest="json_path")
    p.add_argument("--mode", default="ts",
                   choices=["ts", "cm", "g", "drcs", "probe_subtitles", "probe_audio"])
    p.add_argument("--max-frames", type=int, default=9000)
    p.add_argument("--dump", action="store_true")
    p.add_argument("--dump-filter", action="store_true")
    p.add_argument("--eb", "--encode-buffer", type=int, default=16,
                   dest="encode_buffer")
    p.add_argument("--device-batch", type=int, default=32,
                   help="frames per device batch")
    p.add_argument("--frame-cache-mb", type=int, default=-1,
                   help="decoded-frame cache across pipeline sweeps "
                        "(-1 = auto: a quarter of RAM, 0 = off)")
    p.add_argument("--filter-mode", default="none",
                   choices=["none", "yadif", "yadif60", "qtgmc", "kfm_vfr",
                            "kfm_vfr30", "kfm_cfr24", "svp", "autovfr"],
                   help="device filter graph (replaces the AVS filter "
                        "script; the reference's deinterlacer x fps matrix)")
    p.add_argument("--autovfr-parallel", type=int, default=2,
                   help="AutoVfr analysis sections run in ordered parallel")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the filter pass over N devices of the mesh "
                        "(multi-chip; 1 = single device)")
    p.add_argument("--encoder-process", type=int, default=-1,
                   choices=[-1, 0, 1],
                   help="in-build encoder placement: -1 auto (subprocess "
                        "on multi-core hosts), 0 in-process, 1 subprocess")
    p.add_argument("--resize", default="",
                   help="output WxH (lanczos3; even dims; SAR reset 1:1)")
    p.add_argument("--kfm-no-ucf", action="store_true",
                   help="disable the dirty-field (UCF) replacement in "
                        "KFM modes (ref KfmEnableUcf)")
    p.add_argument("--post-filter", default="",
                   help="post chain tokens: nr,deband,edge")
    p.add_argument("--print-prefix", action="store_true")
    # ---- reference-compat flags ----
    p.add_argument("--mpeg2decoder", default="default",
                   help="MPEG2 decode backend: default|native|ffmpeg|"
                        "avlib|cv2 (QSV/CUVID accepted, mapped to "
                        "default)")
    p.add_argument("--h264decoder", default="default",
                   help="H264 decode backend: default|ffmpeg|avlib|cv2 "
                        "(QSV/CUVID accepted, mapped to default)")
    p.add_argument("--affinity", default="",
                   help="accepted for compat; device assignment is "
                        "handled by the scheduler")
    p.add_argument("--chapter-exe", default="", dest="chapter_exe",
                   help="accepted for compat (scene/silence analysis is "
                        "in-build)")
    p.add_argument("--chapter-exe-options", default="",
                   dest="chapter_exe_options")
    p.add_argument("--jls", default="", dest="jls_path",
                   help="accepted for compat (JLS rule engine is in-build)")
    p.add_argument("--nicoass", default="", dest="nicoass",
                   help="accepted for compat (NicoJK fetchers are "
                        "pluggable)")
    p.add_argument("--systemavsplugin", default="",
                   help="accepted for compat (no AviSynth runtime; the "
                        "declarative filter graph replaces it)")
    p.add_argument("--resource-manager", default="",
                   help="accepted for compat (resource phases are "
                        "scheduled in-process)")
    p.add_argument("--args", action="store_true", dest="show_args",
                   help="print the parsed arguments")
    return p


def args_to_config(args) -> Config:
    conf = Config()
    conf.mode = args.mode
    conf.src_file_path = args.input or ""
    conf.out_video_path = args.output
    conf.out_info_json_path = args.json_path
    conf.work_dir = args.work
    conf.encoder = {
        "x264": Encoder.X264, "x265": Encoder.X265, "QSVEnc": Encoder.QSVENC,
        "NVEnc": Encoder.NVENC, "VCEEnc": Encoder.VCEENC,
        "SVT-AV1": Encoder.SVTAV1,
    }[args.encoder_type]
    conf.encoder_path = args.encoder
    conf.encoder_options = args.encoder_option
    if args.audio_encoder_type:
        conf.audio_encoder = {
            "neroAac": AudioEncoder.NEROAAC, "qaac": AudioEncoder.QAAC,
            "fdkaac": AudioEncoder.FDKAAC,
        }[args.audio_encoder_type]
        conf.audio_encoder_path = args.audio_encoder
        conf.audio_encoder_options = args.audio_encoder_option
    conf.audio_bitrate_kbps = args.audio_bitrate
    conf.format = OutputFormat(args.format)
    conf.split_sub = args.splitsub
    conf.two_pass = args.two_pass
    conf.muxer_path = args.muxer
    conf.timelineeditor_path = args.timelineeditor
    conf.mp4box_path = args.mp4box
    conf.filter_script_path = args.filter_script
    conf.post_filter_script_path = args.post_filter_script
    conf.chapter = args.chapter
    conf.subtitles = args.subtitles
    conf.logo_path = list(args.logo)
    conf.erase_logo_path = list(args.erase_logo)
    conf.drcs_map_path = args.drcs
    conf.ignore_no_drcs_map = args.ignore_no_drcsmap
    conf.ignore_no_logo = args.ignore_no_logo
    conf.ignore_nicojk_error = args.ignore_nicojk_error
    conf.no_delogo = args.no_delogo
    conf.loose_logo_detection = args.loose_logo_detection
    conf.max_fade_length = args.max_fade_length
    conf.jls_cmd_path = args.jls_cmd
    conf.jls_options = args.jls_option
    conf.trim_avs_path = args.trimavs
    conf.cm_out_mask = args.cmoutmask
    conf.nicojk18 = args.nicojk18
    conf.use_nicojk_log = args.nicojklog
    conf.nicojk_mask = args.nicojkmask if args.nicojk else 0
    conf.no_remove_tmp = args.no_remove_tmp
    conf.x265_time_factor = args.timefactor
    conf.bitrate_cm = args.bitrate_cm
    conf.max_frames = args.max_frames
    conf.dump_stream_info = args.dump
    conf.dump_filter = args.dump_filter
    conf.num_encode_buffer_frames = args.encode_buffer
    conf.device_batch_frames = args.device_batch
    conf.frame_cache_mb = args.frame_cache_mb
    conf.filter_mode = args.filter_mode
    conf.autovfr_parallel = args.autovfr_parallel
    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    conf.filter_devices = args.devices
    conf.encoder_process = args.encoder_process
    conf.kfm_ucf = not args.kfm_no_ucf
    if args.resize:
        try:
            w, h = (int(x) for x in args.resize.lower().split("x"))
        except ValueError:
            raise SystemExit(f"bad --resize {args.resize!r} (want WxH)")
        if w % 2 or h % 2 or w <= 0 or h <= 0:
            raise SystemExit("--resize dimensions must be positive and even")
        conf.resize_width, conf.resize_height = w, h
    conf.post_filter = args.post_filter
    conf.print_prefix = args.print_prefix

    def _decoder_choice(v: str) -> str:
        # QSV/CUVID are CUDA-host hardware paths in the reference
        # (AmatsukazeCLI.hpp:332-345); map them to the auto default
        return "default" if v in ("QSV", "CUVID") else v

    conf.mpeg2_decoder = _decoder_choice(args.mpeg2decoder)
    conf.h264_decoder = _decoder_choice(args.h264decoder)
    conf.affinity = args.affinity
    conf.chapter_exe_path = args.chapter_exe
    conf.chapter_exe_options = args.chapter_exe_options
    conf.jls_path = args.jls_path
    if args.nicoass:
        conf.nico_conv_ass_path = args.nicoass

    if args.serviceid is not None:
        s = args.serviceid
        conf.service_id = int(s, 16) if s.lower().startswith("0x") else int(s)
    if args.bitrate is not None:
        a, b, f = (float(x) for x in args.bitrate.split(":"))
        conf.bitrate = BitrateSetting(a=a, b=b, h264=f)
        conf.auto_bitrate = True
    head, _, tail = args.pmt_cut.partition(":")
    conf.pmt_cut_side_rate = (float(head or 0), float(tail or 0))
    return conf


def main(argv=None, device=None) -> int:
    """Run the CLI; `device` is None for the CUDA card, "cpu" for the
    plain PyTorch versions."""
    args = build_parser().parse_args(argv)
    if args.show_args:
        for k, v in sorted(vars(args).items()):
            print(f"  {k} = {v!r}")
    if not args.input:
        build_parser().print_help()
        return 1
    ctx = AMTContext(level="info", time_prefix=args.print_prefix)
    # the recording's trace: its root span, and the pipeline's set-up
    trace = ctx.trace
    trace.open_root()
    device = ensure_cuda_backend(ctx, device)
    if args.drcs:
        ctx.load_drcs_mapping(args.drcs)
    init = trace.begin("pipeline.init")
    conf = args_to_config(args)
    settings = Settings(ctx, conf)
    try:
        if args.mode in ("ts", "cm"):
            from .pipeline.transcode import TranscodePipeline
            from .pipeline.decoders import default_decoder_factory

            pipe = TranscodePipeline(
                ctx, settings, decoder_factory=default_decoder_factory(),
                device=device)
            trace.end(init)
            pipe.run()
        elif args.mode == "g":
            from .pipeline.simple import SimpleTranscode

            import shutil as _sh

            if _sh.which("ffmpeg"):
                from .pipeline.decoders import ffmpeg_generic_decoder

                decoder = ffmpeg_generic_decoder
            else:
                from .pipeline.decoders import (avlib_available,
                                                inbuild_generic_decoder)

                if avlib_available():  # any container/codec, in-process
                    from .pipeline.decoders import avlib_generic_decoder

                    decoder = avlib_generic_decoder
                else:  # in-build demux + MPEG decode
                    decoder = inbuild_generic_decoder
            SimpleTranscode(ctx, settings, decoder=decoder).run()
        elif args.mode == "probe_subtitles":
            from .pipeline.probe import probe_subtitles

            found = probe_subtitles(ctx, settings)
            print("has_subtitles" if found else "no_subtitles")
        elif args.mode == "probe_audio":
            from .pipeline.probe import probe_audio

            for fmt in probe_audio(ctx, settings):
                print(fmt)
        elif args.mode == "drcs":
            from .pipeline.probe import search_drcs

            search_drcs(ctx, settings)
        return 0
    except NoLogoError:
        return EXIT_NO_LOGO
    except NoDrcsMapError:
        return EXIT_NO_DRCS
    finally:
        if not conf.no_remove_tmp:
            settings.tmp.cleanup()
            ctx.clear_tmp_files()


if __name__ == "__main__":
    sys.exit(main())
