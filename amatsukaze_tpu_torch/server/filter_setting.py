"""Structured filter settings (ref EncodeServerData.cs:132-194
`FilterSetting` field-for-field) and their compilation to CLI arguments
(the role of Misc.cs:1211-1446 `AvsScriptCreator`, which compiles the
GUI's FilterSetting into the AVS script; here the declarative filter
graph replaces the script, so the compilation target is the
`--filter-mode`/`--post-filter`/`--resize` flag set).

The port's copy of amatsukaze_tpu/server/filter_setting.py.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields

DEINTERLACE_ALGORITHMS = ("KFM", "D3DVP", "QTGMC", "Yadif", "AutoVfr")
FILTER_FPS = ("VFR", "CFR24", "CFR30", "CFR60", "SVP", "VFR30")
DEBLOCK_STRENGTHS = ("Strong", "Medium", "Weak", "Weaker")
QTGMC_PRESETS = ("Auto", "Faster", "Fast", "Medium", "Slow", "Slower")


@dataclass
class FilterSetting:
    """Mirror of the reference's DataContract (EncodeServerData.cs:132-194).

    `enable_cuda` and `d3dvp_gpu` are accepted for profile compatibility:
    the accelerator is implicit in this build (the device filter graph),
    and D3DVP is a Windows DirectX deinterlacer — profiles selecting it
    map to the yadif path."""

    enable_cuda: bool = False
    enable_deblock: bool = False
    deblock_quality: int = 3
    deblock_strength: str = "Medium"
    deblock_sharpen: bool = False
    enable_deinterlace: bool = False
    deinterlace_algorithm: str = "KFM"
    d3dvp_gpu: str = "Auto"
    qtgmc_preset: str = "Auto"
    kfm_enable_nr: bool = False
    kfm_enable_ucf: bool = True
    kfm_vfr_120fps: bool = False
    kfm_fps: str = "VFR"
    yadif_fps: str = "CFR30"
    auto_vfr_parallel: int = 2
    auto_vfr_fast: bool = False
    auto_vfr_30f: bool = False
    auto_vfr_60f: bool = False
    auto_vfr_24a: bool = False
    auto_vfr_30a: bool = False
    auto_vfr_crop: bool = False
    auto_vfr_skip: int = 0
    auto_vfr_ref: int = 0
    enable_resize: bool = False
    resize_width: int = 1280
    resize_height: int = 720
    enable_temporal_nr: bool = False
    enable_deband: bool = False
    enable_edge_level: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "FilterSetting":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> dict:
        return asdict(self)


# (algorithm, fps) -> declarative filter-graph mode. Derived from the
# reference's script matrix (Misc.cs:1290-1389):
# - KFM VFR/VFR30 -> KFMDeint mode=4 thswitch 3/-1; CFR24 -> mode=2;
#   SVP -> svp=true; CFR60 -> 60p output (the motion-adaptive bob here)
# - Yadif CFR30/CFR60 -> Yadifmod2 mode=0/1; CFR24 -> deint+decimate
#   (the telecine-aware 24p path here); VFR -> the KFM VFR engine
# - D3DVP is DirectX-only: maps to yadif
_KFM_MODES = {"VFR": "kfm_vfr", "VFR30": "kfm_vfr30", "CFR24": "kfm_cfr24",
              "SVP": "svp", "CFR60": "qtgmc", "CFR30": "kfm_vfr30"}
_YADIF_MODES = {"CFR30": "yadif", "CFR60": "yadif60", "CFR24": "kfm_cfr24",
                "VFR": "kfm_vfr", "VFR30": "kfm_vfr30", "SVP": "svp"}


def filter_mode_of(fs: FilterSetting) -> str:
    if not fs.enable_deinterlace:
        return "none"
    alg = fs.deinterlace_algorithm
    if alg == "KFM":
        return _KFM_MODES.get(fs.kfm_fps, "kfm_vfr")
    if alg == "QTGMC":
        return "qtgmc"
    if alg == "AutoVfr":
        return "autovfr"
    # Yadif and D3DVP (DirectX hardware deinterlace -> yadif class)
    return _YADIF_MODES.get(fs.yadif_fps, "yadif")


def filter_setting_args(fs: FilterSetting) -> list[str]:
    """CLI arguments realising this FilterSetting (consumed by
    EncodeServer's MakeAmatsukazeArgs equivalent)."""
    args: list[str] = []
    mode = filter_mode_of(fs)
    if mode != "none":
        args += ["--filter-mode", mode]
    if mode == "autovfr" and fs.auto_vfr_parallel >= 1:
        args += ["--autovfr-parallel", str(fs.auto_vfr_parallel)]
    post = []
    if fs.enable_deblock:
        post.append("deblock")
    if fs.kfm_enable_nr or fs.enable_temporal_nr:
        post.append("nr")
    if fs.enable_deband:
        post.append("deband")
    if fs.enable_edge_level:
        post.append("edge")
    if post:
        args += ["--post-filter", ",".join(post)]
    if fs.enable_resize and fs.resize_width and fs.resize_height:
        args += ["--resize", f"{fs.resize_width}x{fs.resize_height}"]
    if (mode in ("kfm_vfr", "kfm_vfr30", "kfm_cfr24", "svp", "autovfr")
            and not fs.kfm_enable_ucf):
        args += ["--kfm-no-ucf"]
    return args
