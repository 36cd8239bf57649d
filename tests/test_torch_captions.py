"""The port's ARIB caption layer and stream report (copies of
amatsukaze_tpu/captions/arib.py, b24.py and ts/info.py) against the JAX
package's: ARIB STD-B24 strings in the caption and the service profile,
caption PES payloads through CaptionDecoder (management data, statements
with positioning and colour controls, a DRCS download and its use, a
clear), and TsInfo / slim_ts over a tests/ts_gen.py stream with service
information. Everything exactly equal, the unmapped DRCS bitmaps written
to disk included.
"""

import os

import pytest
from torch_compare import plain
from torch_threads import one_torch_thread  # noqa: F401

import ts_gen
from amatsukaze_tpu.captions import arib as jarib
from amatsukaze_tpu.captions import b24 as jb24
from amatsukaze_tpu.ts import info as jinfo
from amatsukaze_tpu.utils.context import AMTContext as JContext

from amatsukaze_tpu_torch import captions
from amatsukaze_tpu_torch.captions import arib, b24
from amatsukaze_tpu_torch.ts import info
from amatsukaze_tpu_torch.utils.context import AMTContext


def jis(s: str) -> bytes:
    """A kanji/kana string as ARIB GL 2-byte codes (JIS X0208)."""
    return bytes(b - 0x80 for b in s.encode("euc_jp"))


ARIB_STRINGS = {
    "alnum": bytes([0x0E]) + b"Hello 123",
    "kanji": jis("日本語"),
    "hiragana_gr": bytes([0xA2]),
    "newline": jis("字幕") + bytes([0x0D]) + jis("テスト"),
    "designation": bytes([0x1B, 0x28, 0x4A]) + b"ABC",
    "colour": bytes([0x87]) + jis("赤"),
    "gaiji": bytes([0x1B, 0x24, 0x3B, 93 + 0x20, 90 + 0x20]),
    "mosaic": bytes([0x1B, 0x28, 0x32, 0x21, 0x35, 0x6A, 0x62]),
    "mosaic_bcd": bytes([0x1B, 0x28, 0x32, 0x41, 0x1B, 0x28, 0x33, 0x30]),
    "macro": b"\x1b\x6f" + b"\x61" + b"\x0e" + b"\x21",
    "macro_kanji": b"\x1b\x6f\x61" + b"\x0f" + b"\x30\x21",
    "macro_gr": b"\x1b\x7c" + b"\xe1",
    "single_shift": b"\x19" + b"\x21" + jis("漢"),
    "garbage": bytes(range(0x80, 0xA0)) + b"\x1b",
}


@pytest.mark.parametrize("caption", [True, False])
@pytest.mark.parametrize("name", list(ARIB_STRINGS))
def test_arib_strings_equal(name, caption):
    data = ARIB_STRINGS[name]
    mine, theirs = arib.AribDecoder(caption=caption), \
        jarib.AribDecoder(caption=caption)
    assert mine.decode(data) == theirs.decode(data)
    assert plain(mine.g) == plain(theirs.g)
    assert arib.decode_arib_string(data) == jarib.decode_arib_string(data)
    assert captions.decode_arib_string is arib.decode_arib_string


def _caption_payloads():
    pattern = bytes([0xF0, 0xF0])
    groups = [
        ts_gen.caption_management_group(),
        ts_gen.caption_management_group(languages=2, swf_fmt=7),
        ts_gen.caption_statement_group(
            b"\x0c" + b"\x1c" + bytes([0x40 + 12, 0x40])
            + ts_gen.arib_ascii("HELLO CAPTION")),
        ts_gen.caption_statement_group(
            b"\x0c" + b"\x9b\x37\x30\x3b\x34\x36\x30\x20\x61"  # CSI SDP
            + b"\x87" + jis("字幕") + b"\x0d" + b"\x83" + jis("テスト")),
        ts_gen.caption_statement_group(
            ts_gen.caption_drcs_du(0x41, 0x21, pattern=pattern),
            unit_parameter=0x30),
        ts_gen.caption_statement_group(
            b"\x0c" + b"\x1b\x29\x20\x41" + b"\x0e" + b"\x21" + b"\x0f"
            + ts_gen.arib_ascii(" GAIJI")),
        ts_gen.caption_statement_group(jis("第二"), lang_index=1),
        ts_gen.caption_statement_group(b"\x0c"),
    ]
    return [ts_gen.caption_pes_payload(g) for g in groups]


def test_caption_decoder_equal(tmp_path):
    mine = b24.CaptionDecoder(AMTContext(level="error"),
                              drcs_out_dir=str(tmp_path / "port"))
    theirs = jb24.CaptionDecoder(JContext(level="error"),
                                 drcs_out_dir=str(tmp_path / "jax"))
    got = []
    for k, payload in enumerate(_caption_payloads()):
        items = mine.decode(90_000 + 3003 * k, payload)
        assert plain(items) == plain(theirs.decode(90_000 + 3003 * k,
                                                   payload)), k
        got += items
    assert any(it.line for it in got)
    assert mine.languages == theirs.languages
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d, exist_ok=True)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    assert b24.drcs_md5(4, 4, 2, b"\xf0\xf0") == \
        jb24.drcs_md5(4, 4, 2, b"\xf0\xf0")


@pytest.fixture(scope="module")
def si_ts(tmp_path_factory):
    data = ts_gen.build_simple_ts(
        num_frames=60, width=96, height=64, si=True,
        service_name="TEST TV", event_name="Test Program",
        extra_services=[(0x0401, 0x01F1)])
    p = tmp_path_factory.mktemp("tsinfo") / "src.ts"
    p.write_bytes(data)
    return str(p)


def test_ts_info_equal(si_ts):
    mine, theirs = info.TsInfo(AMTContext(level="error")), \
        jinfo.TsInfo(JContext(level="error"))
    assert mine.read_file(si_ts) == theirs.read_file(si_ts) is True
    for attr in ("programs", "service_names", "events", "time"):
        assert plain(getattr(mine, attr)) == plain(getattr(theirs, attr)), \
            attr
    assert mine.service_names[ts_gen.SERVICE_ID] == "TEST TV"
    assert plain(mine.get_program(ts_gen.SERVICE_ID)) == \
        plain(theirs.get_program(ts_gen.SERVICE_ID))
    assert mine.get_program(9999) is None


def test_slim_ts_equal(si_ts, tmp_path):
    null = bytes([0x47, 0x1F, 0xFF, 0x10]) + bytes(184)
    src = tmp_path / "padded.ts"
    src.write_bytes(null * 40 + open(si_ts, "rb").read())
    n_mine = info.slim_ts(str(src), str(tmp_path / "port.ts"))
    n_theirs = jinfo.slim_ts(str(src), str(tmp_path / "jax.ts"))
    assert n_mine == n_theirs > 0
    assert (tmp_path / "port.ts").read_bytes() == \
        (tmp_path / "jax.ts").read_bytes()
