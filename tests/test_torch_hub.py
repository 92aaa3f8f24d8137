"""The port's model-hub transfer model (paper §5.3, Fig. 10) against the
reference's.

Codec times are measured, so they differ between runs; what must agree
exactly is everything else: the raw and compressed byte counts of a
transfer (single blob and streamed ZNS1 file), the modelled wire times for
those sizes on every channel, and the report's derived properties.
"""

import ml_dtypes
import numpy as np
import pytest

from repro.checkpoint import hub as ref_hub
from repro.core import zipnn as ref_zipnn
from repro_torch.checkpoint import hub
from repro_torch.core import zipnn
from repro_torch.core.options import CodecOptions

CFG = dict(chunk_param_bytes=1 << 12, backend="huffman")


def _raw(n: int = 40_000, seed: int = 0) -> bytes:
    w = (np.random.default_rng(seed).standard_normal(n) * 0.02).astype(ml_dtypes.bfloat16)
    return w.tobytes() + b"\x03"


def test_channels_match_reference():
    assert hub.CHANNELS == ref_hub.CHANNELS


@pytest.mark.parametrize("direction", ["download", "upload"])
@pytest.mark.parametrize("channel", sorted(ref_hub.CHANNELS))
def test_simulate_transfer_sizes_and_wire_times_match(channel, direction):
    raw = _raw()
    want = ref_hub.simulate_transfer(raw, "bfloat16", channel, direction=direction,
                                     config=ref_zipnn.ZipNNConfig(**CFG))
    got = hub.simulate_transfer(raw, "bfloat16", channel, direction=direction,
                                config=zipnn.ZipNNConfig(**CFG),
                                options=CodecOptions(backend="device"), device="cpu")
    assert (got.raw_bytes, got.comp_bytes) == (want.raw_bytes, want.comp_bytes)
    assert (got.wire_raw_s, got.wire_comp_s) == (want.wire_raw_s, want.wire_comp_s)
    assert got.codec_s > 0 and got.total_raw_s == got.wire_raw_s
    assert got.total_comp_s == got.wire_comp_s + got.codec_s
    assert got.overlapped_speedup == got.speedup               # not overlapped


@pytest.mark.parametrize("direction", ["download", "upload"])
def test_simulate_file_transfer_matches(tmp_path, direction):
    path = tmp_path / "model.bin"
    path.write_bytes(_raw(60_000, seed=1))
    kw = dict(direction=direction, window_bytes=1 << 14)
    want = ref_hub.simulate_file_transfer(str(path), "bfloat16", "cached_download_cloud",
                                          config=ref_zipnn.ZipNNConfig(**CFG), **kw)
    got = hub.simulate_file_transfer(str(path), "bfloat16", "cached_download_cloud",
                                     config=zipnn.ZipNNConfig(**CFG),
                                     options=CodecOptions(threads=4), device="cpu", **kw)
    assert (got.raw_bytes, got.comp_bytes) == (want.raw_bytes, want.comp_bytes)
    assert (got.wire_raw_s, got.wire_comp_s) == (want.wire_raw_s, want.wire_comp_s)
    if direction == "download":
        # the pipeline is never faster than the wire alone, nor slower than
        # the wire plus every frame's decode
        assert got.total_comp_overlap_s >= got.wire_comp_s
        assert got.codec_overlap_s == pytest.approx(
            max(got.total_comp_overlap_s - got.wire_comp_s, 0.0), abs=1e-6)
    else:
        assert got.total_comp_overlap_s == got.codec_overlap_s == 0.0


def test_lossless_check_raises(monkeypatch):
    monkeypatch.setattr(zipnn, "decompress_bytes", lambda *a, **k: b"")
    with pytest.raises(IOError, match="lossless"):
        hub.simulate_transfer(_raw(1000), "bfloat16", "upload_cloud", device="cpu")
