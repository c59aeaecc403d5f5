"""--keep-foreign-metadata in flac_tpu_torch against flac_tpu, on the CPU.

The round trips of tests/test_foreign.py through the port's `flac` tool
(cli.main with device="cpu"): WAV with LIST and odd-sized chunks, RF64
and AIFF with an ANNO chunk go to FLAC with their chunks in
APPLICATION blocks and come back byte-identical (Wave64, whose GUIDs the
port's container fixes: test_container_wave64_is_the_format_wave64).  Both packages' foreign
scanners must give the same blocks, and flac_tpu's tool must restore the
same bytes from the port's FLAC file, so the port's files interoperate
with the reference's.  The port encodes; flac_tpu only decodes (its
"auto" engine takes the host engine at this size), so nothing compiles.
"""

import struct

import numpy as np
import pytest
import torch

from flac_tpu import cli as jcli
from flac_tpu import container as jcontainer
from flac_tpu import foreign as jforeign
from flac_tpu_torch import cli, container, foreign

from conftest import make_test_signal

torch.set_num_threads(1)

ENC = ["-5", "-s", "--keep-foreign-metadata"]


def _wav_with_junk(pcm, rate=44100, bps=16) -> bytes:
    """WAV with LIST/INFO before data and an odd-sized chunk after it."""
    payload = container._pcm_to_bytes(pcm, bps)
    nb = (bps + 7) // 8
    ba = pcm.shape[0] * nb
    fmtc = struct.pack("<HHIIHH", 1, pcm.shape[0], rate, rate * ba, ba,
                       nb * 8)
    info = b"INFOIART" + struct.pack("<I", 8) + b"someone\x00"
    junk = b"odd!" + struct.pack("<I", 5) + b"12345\x00"
    chunks = (b"fmt " + struct.pack("<I", len(fmtc)) + fmtc
              + b"LIST" + struct.pack("<I", len(info)) + info
              + b"data" + struct.pack("<I", len(payload)) + payload
              + junk)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _aiff_with_anno(pcm) -> bytes:
    aiff = container.write_aiff(pcm, 44100, 16)
    body = b"ANNO" + struct.pack(">I", 4) + b"note" + aiff[12:]
    return b"FORM" + struct.pack(">I", 4 + len(body)) + b"AIFF" + body


PCM = make_test_signal(12000)
INPUTS = {
    "wav": (".wav", lambda: _wav_with_junk(PCM)),
    "rf64": (".rf64", lambda: container.write_rf64(PCM, 44100, 16)),
    "aiff": (".aiff", lambda: _aiff_with_anno(PCM)),
}


def _format_wave64(pcm) -> bytes:
    """A Wave64 file built here from the format's GUIDs (not by
    container.write_w64): riff, wave, a fmt chunk, a "levl" chunk of the
    GUID form that the format leaves to other tools, then the data chunk;
    each chunk's size counts its 24-byte header, its body pads to 8."""
    guid = "F3ACD3118CD100C04F8EDB8A"
    payload = container._pcm_to_bytes(pcm, 16)
    ba = pcm.shape[0] * 2
    fmtc = struct.pack("<HHIIHH", 1, pcm.shape[0], 44100, 44100 * ba, ba,
                       16)

    def chunk(name: bytes, body: bytes) -> bytes:
        return (name + bytes.fromhex(guid) + struct.pack("<Q", 24 + len(body))
                + body + b"\x00" * ((-len(body)) % 8))
    inner = (b"wave" + bytes.fromhex(guid) + chunk(b"fmt ", fmtc)
             + chunk(b"levl", bytes(range(7))) + chunk(b"data", payload))
    return (bytes.fromhex("726966662E91CF11A5D628DB04C10000")
            + struct.pack("<Q", 24 + len(inner)) + inner)


def test_container_wave64_is_the_format_wave64(tmp_path):
    """The port's container writes and reads the Wave64 format's GUIDs
    (WAVE, fmt and data end 8CD100C0 4F8EDB8A, as foreign's do), so it
    reads a format-correct Wave64 that flac_tpu's read_w64 rejects, and
    --keep-foreign-metadata restores it byte for byte."""
    ours = container.write_w64(PCM, 44100, 16)
    for at in (24, 40):                  # the WAVE GUID, the fmt chunk's
        assert ours[at + 8:at + 16] == bytes.fromhex("8CD100C04F8EDB8A")
    blob = _format_wave64(PCM)
    info = container.read_w64(blob)
    assert (info.sample_rate, info.channels, info.bits_per_sample) == \
        (44100, 2, 16)
    np.testing.assert_array_equal(info.samples, PCM)
    with pytest.raises(jcontainer.ContainerError, match="not a Wave64"):
        jcontainer.read_w64(blob)
    src = tmp_path / "in.w64"
    src.write_bytes(blob)
    f = tmp_path / "a.flac"
    assert cli.main(ENC + ["-o", str(f), str(src)], device="cpu") == 0
    out = tmp_path / "out.w64"
    assert cli.main(["-d", "-s", "--keep-foreign-metadata", "-o", str(out),
                     str(f)], device="cpu") == 0
    assert out.read_bytes() == blob


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_scan_and_restore_match(kind):
    _, make = INPUTS[kind]
    blob = make()
    found = foreign.scan_foreign(blob)
    assert found == jforeign.scan_foreign(blob)
    appid, blocks = found
    assert foreign.foreign_kind(appid, blocks) == \
        jforeign.foreign_kind(appid, blocks)
    kind_name = foreign.foreign_kind(appid, blocks)
    payload = container._pcm_to_bytes(
        PCM, 16, big_endian=kind_name in ("aiff", "aiff-c-none"),
        unsigned8=kind_name in ("wav", "rf64", "w64"))
    assert foreign.restore_foreign(appid, blocks, payload) == blob
    assert jforeign.restore_foreign(appid, blocks, payload) == blob


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_cli_round_trip_is_byte_identical(kind, tmp_path):
    ext, make = INPUTS[kind]
    blob = make()
    src = tmp_path / f"in{ext}"
    src.write_bytes(blob)
    f = tmp_path / "a.flac"
    assert cli.main(ENC + ["-o", str(f), str(src)], device="cpu") == 0
    for tag, main, kw in (("port", cli.main, {"device": "cpu"}),
                          ("ref", jcli.main, {})):
        out = tmp_path / f"{tag}{ext}"
        assert main(["-d", "-s", "--keep-foreign-metadata", "-o", str(out),
                     str(f)], **kw) == 0
        assert out.read_bytes() == blob, tag


def test_if_present_flag_skips_silently(tmp_path):
    wav = tmp_path / "plain.wav"
    wav.write_bytes(container.write_wav(PCM, 44100, 16))
    f = tmp_path / "plain.flac"
    assert cli.main(["-5", "-s", "-o", str(f), str(wav)],
                    device="cpu") == 0
    out = tmp_path / "out.wav"
    assert cli.main(["-d", "-s", "--keep-foreign-metadata-if-present",
                     "-o", str(out), str(f)], device="cpu") == 0
    assert out.read_bytes() == wav.read_bytes()
    with pytest.raises(SystemExit, match="no foreign metadata"):
        cli.main(["-d", "-s", "--keep-foreign-metadata", "-o", str(out),
                  str(f)], device="cpu")
    raw = tmp_path / "in.raw"
    raw.write_bytes(container.write_raw(PCM, 16))
    with pytest.raises(SystemExit, match="requires WAV"):
        cli.main(["-s", "--keep-foreign-metadata", "--force-raw-format",
                  "--channels", "2", "--bps", "16", "--sample-rate", "44100",
                  "-o", str(tmp_path / "r.flac"), str(raw)], device="cpu")
