"""The port's AAC stack (copies of amatsukaze_tpu/audio: the AAC-LC oracle,
SBR, parametric stereo, their tables, and the native decoder's binding)
against the JAX package's, over the streams of tests/aac_gen.py and
tests/sbr_gen.py and over utils/synth_ts.py's ADTS frames.

Per stream: the port's oracle gives the PCM and element metadata of the
JAX oracle exactly; the port's native decoder gives the JAX native
decoder's exactly (same library); and the native decoder stays within
the JAX tests' tolerance of the oracle (1 LSB). Native availability is
decided inside the tests, never at collection.
"""

import numpy as np
import pytest
from torch_compare import load_both_native
from torch_threads import one_torch_thread  # noqa: F401

import aac_gen
from amatsukaze_tpu.audio import aac as jaac
from amatsukaze_tpu.audio import aac_native as jaac_native
from amatsukaze_tpu.audio import sbr as jsbr
from amatsukaze_tpu.audio.aac import EIGHT_SHORT, LONG_START, LONG_STOP
from amatsukaze_tpu.audio.aac import ONLY_LONG
from sbr_gen import append_sbr_fil, sbr_payload, sbr_ps_payload

from amatsukaze_tpu_torch.audio import aac, aac_native, aac_tables
from amatsukaze_tpu_torch.audio import ps_tables, sbr, sbr_tables
from amatsukaze_tpu_torch.utils import synth_ts

SWB_L = aac_tables.SWB_OFFSETS[(1024, 48000)]
SWB_S = aac_tables.SWB_OFFSETS[(128, 48000)]
SBR_SR_INDEX = 6  # 24 kHz core -> 48 kHz output


def _bands(rng, maxv=12, n=40, short=False):
    swb = SWB_S if short else SWB_L
    mul = 8 if short else 1
    return {sfb: [int(v) for v in rng.integers(
        -maxv, maxv + 1, size=(swb[sfb + 1] - swb[sfb]) * mul)]
        for sfb in range(n)}


def _lc_stereo():
    rng = np.random.default_rng(3)
    return [aac_gen.make_adts_frame(
        lambda w: aac_gen.make_cpe(w, _bands(rng), _bands(rng),
                                   global_gain=140), channel_config=2)
        for _ in range(8)]


def _lc_windows():
    rng = np.random.default_rng(4)
    out = []
    for seq, shape in ((ONLY_LONG, 0), (LONG_START, 1), (EIGHT_SHORT, 1),
                       (EIGHT_SHORT, 0), (LONG_STOP, 0), (ONLY_LONG, 1)):
        b = _bands(rng, n=8, short=seq == EIGHT_SHORT)
        out.append(aac_gen.make_adts_frame(
            lambda w, b=b, s=seq, sh=shape: aac_gen.make_sce(
                w, b, 150, max_sfb=8, window_shape=sh, window_sequence=s)))
    return out


def _lc_tools():
    """M/S, intensity, pulse and TNS in one stream."""
    rng = np.random.default_rng(5)
    frames = [aac_gen.make_adts_frame(
        lambda w: aac_gen.make_cpe(
            w, _bands(rng, n=20), _bands(rng, n=20), 150, ms_mask=1,
            ms_used=[i % 2 for i in range(40)]), channel_config=2)]
    bands_l = {sfb: [20] * (SWB_L[sfb + 1] - SWB_L[sfb])
               for sfb in range(8, 12)}
    frames.append(aac_gen.make_adts_frame(
        lambda w: aac_gen.make_cpe(
            w, bands_l, {}, 160, max_sfb=20,
            intensity={sfb: (4, True) for sfb in range(8, 12)}),
        channel_config=2))
    frames.append(aac_gen.make_adts_frame(
        lambda w: aac_gen.make_sce(
            w, {10: [3] * (SWB_L[11] - SWB_L[10])}, 160,
            pulse={"start_sfb": 10, "offsets": [2, 3], "amps": [5, 7]})))
    tns = {"coef_res": [1], "filt": [[{"length": 49, "order": 3,
                                       "direction": 1, "compress": 0,
                                       "coef": [1, 6, 14]}]]}
    b = _bands(rng, maxv=8, n=20)
    frames.append(aac_gen.make_adts_frame(
        lambda w: aac_gen.make_sce(w, b, 150, max_sfb=20, tns=tns)))
    return frames


def _sbr_tables():
    k0 = jsbr.qmf_start_channel(5, 1, 48000)
    k2 = jsbr.qmf_stop_channel(3, 48000, k0)
    return jsbr.FreqTables(jsbr.master_frequency_table(k0, k2, 2, 1), 0, k0,
                           k2, 2, 48000)


def _sbr_stream(payload, n=6):
    def body(w):
        aac_gen.make_sce(w, {8: [40, 40, 40, 40]}, global_gain=140,
                         sr_index=SBR_SR_INDEX, codebook=11, max_sfb=40)
        append_sbr_fil(w, payload)
    return [aac_gen.make_adts_frame(body, sr_index=SBR_SR_INDEX)] * n


def _he_aac(**kw):
    t = _sbr_tables()
    return _sbr_stream(sbr_payload(env_start=25, n_env_bands=t.n_low,
                                   n_noise_bands=t.n_q, **kw))


def _he_aac_ps(**kw):
    t = _sbr_tables()
    return _sbr_stream(sbr_ps_payload(env_start=25, n_env_bands=t.n_low,
                                      n_noise_bands=t.n_q, **kw))


def _synth_ts():
    rng = np.random.default_rng(9)
    return [synth_ts.aac_frame(None if k in (3, 4) else rng)
            for k in range(8)]


STREAMS = {
    "lc_stereo": _lc_stereo,
    "lc_windows": _lc_windows,
    "lc_tools": _lc_tools,
    "he_aac": _he_aac,
    "he_aac_two_envelopes": lambda: _he_aac(num_env=2),
    "he_aac_headerless": lambda: _he_aac(header=False),
    "he_aac_ps": _he_aac_ps,
    "he_aac_ps_iid": lambda: _he_aac_ps(iid_index=5, icc_index=4),
    "synth_ts": _synth_ts,
}


def _decode(dec, frames):
    out = []
    for f in frames:
        r = dec.decode(f)
        out.append(None if r is None else
                   (r.pcm, r.num_channels, r.sample_rate, list(r.elements),
                    [tuple(b) for b in r.element_bits]))
    return out


@pytest.fixture(scope="module")
def streams():
    return {k: make() for k, make in STREAMS.items()}


@pytest.mark.parametrize("name", list(STREAMS))
def test_oracle_equals_jax(streams, name):
    got = _decode(aac.AacLcDecoder(), streams[name])
    assert any(g is not None for g in got)
    assert got == _decode(jaac.AacLcDecoder(), streams[name])


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_equals_jax_native(streams, name):
    if not load_both_native() or not jaac_native.native_available():
        pytest.skip("native library not buildable here")
    assert aac_native.native_available()
    got = _decode(aac_native.NativeAacDecoder(), streams[name])
    assert got == _decode(jaac_native.NativeAacDecoder(), streams[name])


@pytest.mark.parametrize("name", list(STREAMS))
def test_native_within_one_lsb_of_oracle(streams, name):
    if not load_both_native() or not aac_native.native_available():
        pytest.skip("native library not buildable here")
    nat = _decode(aac_native.NativeAacDecoder(), streams[name])
    ref = _decode(aac.AacLcDecoder(), streams[name])
    for i, (a, b) in enumerate(zip(nat, ref)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        assert a[1:] == b[1:], i
        pa = np.frombuffer(a[0], "<i2").astype(np.int32)
        pb = np.frombuffer(b[0], "<i2").astype(np.int32)
        assert pa.shape == pb.shape and np.abs(pa - pb).max() <= 1, i


def test_make_decoder_and_reset():
    """make_decoder picks the native engine where it builds; reset clears
    the overlap state in both engines alike."""
    frames = _lc_stereo()
    want = type(jaac_native.make_decoder()).__name__
    dec = aac_native.make_decoder()
    assert type(dec).__name__ == want
    first = _decode(dec, frames[:3])
    dec.reset()
    assert _decode(dec, frames[:3]) == first


def test_tables_are_copies():
    """The table modules are data, copied byte for byte."""
    import pathlib

    from amatsukaze_tpu.audio import aac_tables as jt

    for name in ("aac_tables.py", "sbr_tables.py", "ps_tables.py"):
        mine = pathlib.Path(aac_tables.__file__).with_name(name)
        theirs = pathlib.Path(jt.__file__).with_name(name)
        assert mine.read_bytes() == theirs.read_bytes(), name
    assert sbr_tables.__name__.startswith("amatsukaze_tpu_torch.")
    assert ps_tables.__name__.startswith("amatsukaze_tpu_torch.")
    assert sbr.SbrDecoder.__module__.startswith("amatsukaze_tpu_torch.")
