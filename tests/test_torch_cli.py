"""flac_tpu_torch.cli (the `flac` command line) against flac_tpu.cli, on the
CPU.

Both tools run in-process through `main(argv)`, the port's with
device="cpu", on the same input files; their output files must be
byte-identical.  Encodes run at -1 with blocksize 192 and one frame a
batch (--batch-frames 1), so flac_tpu compiles one batch shape, and at -5
(size within 0.1%, decoded through flac_tpu).  The cases: tags,
--tag-from-file, --no-utf8-convert, --picture, --cuesheet, -S,
--skip/--until, -j, -V, raw stdin with --input-size, --ogg, --replay-gain,
FLAC-to-FLAC re-encode; -d to every output format of
test_features.py::test_decode_output_formats, ranged decodes, -t, -a with
--residual-text, --apply-replaygain-which-is-not-lossless; and the cases
of test_seek.py::test_cli_skip_until through the port.  One case runs the
port's tool in a subprocess with stdin and stdout as pipes.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flac_tpu import cli as jcli
from flac_tpu.decoder import decode_stream_tpu as ref_decode
from flac_tpu.ref_decoder import decode_stream as ref_decode_py
from flac_tpu_torch import cli, container

from conftest import make_test_signal
from test_torch_container import as_reference_w64

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 192
N_SAMPLES = N * 17
ENC = ["-1", "-b", str(N), "--batch-frames", "1", "-s"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    pcm = make_test_signal(N_SAMPLES, seed=12)
    wav = d / "in.wav"
    wav.write_bytes(container.write_wav(pcm, 44100, 16))
    (d / "desc.txt").write_text("hello from a file\n")
    (d / "cover.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(64))
    (d / "disc.cue").write_text(
        'FILE "in.wav" WAVE\n  TRACK 01 AUDIO\n    INDEX 01 00:00:00\n'
        '  TRACK 02 AUDIO\n    INDEX 01 00:00:03\n')
    flac = d / "in.flac"
    assert cli.main(ENC + ["-T", "TITLE=source", "--replay-gain", "-o",
                           str(flac), str(wav)], device="cpu") == 0
    return {"dir": d, "pcm": pcm, "wav": wav, "flac": flac}


def _both(tmp_path, argv, out="out.flac"):
    """Run both tools with `{out}` in argv replaced by an output path of
    their own; returns (port's bytes, flac_tpu's bytes)."""
    got = []
    for tag, main, kw in (("port", cli.main, {"device": "cpu"}),
                          ("ref", jcli.main, {})):
        path = tmp_path / f"{tag}-{out}"
        assert main([a.replace("{out}", str(path)) for a in argv],
                    **kw) == 0
        got.append(path.read_bytes())
    return got


def _sub(files, name):
    return str(files["dir"] / name)


@pytest.mark.parametrize("case", [
    "plain", "tags", "tag from file", "no utf8 convert", "picture",
    "cuesheet", "seekpoints", "no seektable", "skip until", "threads",
    "verify", "ogg", "replay gain", "flac input"])
def test_encode_is_byte_identical(case, files, tmp_path):
    extra = {
        "plain": [],
        "tags": ["-T", "TITLE=x", "-T", "ARTIST=café"],
        "tag from file": ["--tag-from-file",
                          f"DESCRIPTION={_sub(files, 'desc.txt')}"],
        "no utf8 convert": ["--no-utf8-convert", "-T", "TITLE=caf\udce9"],
        "picture": ["--picture",
                    f"3|image/png|cover|1x1x24|{_sub(files, 'cover.png')}",
                    "--picture", _sub(files, "cover.png")],
        "cuesheet": ["--cuesheet", _sub(files, "disc.cue")],
        "seekpoints": ["-S", "0", "-S", "5x", "-S", "0.02s;X"],
        "no seektable": ["--no-seektable", "-P", "0"],
        "skip until": ["--skip", str(2 * N), "--until=-384"],
        "threads": ["-j", "4"],
        "verify": ["-V"],
        "ogg": ["--ogg", "--serial-number", "7"],
        "replay gain": ["--replay-gain", "-T", "A=b"],
        "flac input": ["-T", "EXTRA=1"],
    }[case]
    src = files["flac" if case == "flac input" else "wav"]
    ours, ref = _both(tmp_path, ENC + extra + ["-o", "{out}", str(src)])
    assert ours == ref
    if case in ("threads", "verify"):
        plain, _ = _both(tmp_path, ENC + ["-o", "{out}", str(src)],
                         out="plain.flac")
        assert ours == plain
    if case != "ogg":
        st = ref_decode(ours, engine="host")
        assert st.md5_ok
        if case == "skip until":
            np.testing.assert_array_equal(
                st.samples, files["pcm"][:, 2 * N:N_SAMPLES - 2 * N])
        else:
            np.testing.assert_array_equal(st.samples, files["pcm"])


def test_preset_5_size_and_decode(files, tmp_path):
    argv = ["-5", "-b", str(N), "--batch-frames", "1", "-s", "-o", "{out}",
            str(files["wav"])]
    ours, ref = _both(tmp_path, argv)
    assert abs(len(ours) - len(ref)) <= 0.001 * len(ref)
    st = ref_decode(ours, engine="host")
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, files["pcm"])


def test_raw_stdin_with_input_size(files, tmp_path, monkeypatch):
    """--input-size truncates raw stdin input (main.c:182)."""
    raw = container.write_raw(files["pcm"], 16)
    keep = N * 5 * 4                    # 5 blocks of 16-bit stereo
    argv = ENC + ["--force-raw-format", "--channels", "2", "--bps", "16",
                  "--sample-rate", "44100", "--input-size", str(keep),
                  "-o", "{out}", "-"]
    stdin = type("Stdin", (), {})()
    monkeypatch.setattr(sys, "stdin", stdin)
    got = []
    for tag, main, kw in (("port", cli.main, {"device": "cpu"}),
                          ("ref", jcli.main, {})):
        stdin.buffer = io.BytesIO(raw)
        path = tmp_path / f"{tag}.flac"
        assert main([a.replace("{out}", str(path)) for a in argv],
                    **kw) == 0
        got.append(path.read_bytes())
    assert got[0] == got[1]
    st = ref_decode(got[0], engine="host")
    np.testing.assert_array_equal(st.samples, files["pcm"][:, :N * 5])


@pytest.mark.parametrize("fmt_name, flags, ext", [
    ("wav", [], ".wav"), ("rf64", ["--force-rf64-format"], ".rf64"),
    ("w64", ["--force-wave64-format"], ".w64"), ("aiff", [], ".aiff"),
    ("aiff-c-none", [], ".aifc"),
    ("aiff-c-sowt", ["--force-aiff-c-sowt-format"], ".aifc"),
    ("raw", ["--force-raw-format", "--endian", "big"], ".raw"),
    ("legacy wav", ["--force-legacy-wave-format"], ".wav")])
def test_decode_formats_are_byte_identical(fmt_name, flags, ext, files,
                                           tmp_path):
    ours, ref = _both(tmp_path, ["-d", "-s"] + flags + [
        "-o", "{out}", str(files["flac"])], out="out" + ext)
    # Wave64: the port writes the format's GUIDs, flac_tpu its own
    assert (as_reference_w64(ours) if fmt_name == "w64" else ours) == ref
    if fmt_name == "wav":
        assert ours == files["wav"].read_bytes()


@pytest.mark.parametrize("ranged", [
    ["--skip", "100", "--until", "+1000"], ["--cue=1.1-2.1"],
    ["--skip", "0:00.01", "--until=-50"]])
def test_ranged_decode_is_byte_identical(ranged, files, tmp_path):
    cue = tmp_path / "cue.flac"
    assert cli.main(ENC + ["--cuesheet", _sub(files, "disc.cue"), "-o",
                           str(cue), str(files["wav"])], device="cpu") == 0
    ours, ref = _both(tmp_path, ["-d", "-s"] + ranged + [
        "-o", "{out}", str(cue)], out="out.wav")
    assert ours == ref
    assert len(ours) < len(files["wav"].read_bytes())


def test_ogg_decode_is_byte_identical(files, tmp_path):
    oga = tmp_path / "in.oga"
    assert cli.main(ENC + ["--ogg", "-o", str(oga), str(files["wav"])],
                    device="cpu") == 0
    for ranged in ([], ["--skip", "300", "--until", "+2000"]):
        ours, ref = _both(tmp_path, ["-d", "-s"] + ranged + [
            "-o", "{out}", str(oga)], out="out.wav")
        assert ours == ref
    assert _both(tmp_path, ["-d", "-s", "-o", "{out}", str(oga)],
                 out="full.wav")[0] == files["wav"].read_bytes()


@pytest.mark.parametrize("spec", [None, "", "3tLn2", "-6al", "an0"])
def test_apply_replaygain_is_byte_identical(spec, files, tmp_path):
    flag = [] if spec is None else [
        "--apply-replaygain-which-is-not-lossless" + (f"={spec}" if spec
                                                       else "")]
    ours, ref = _both(tmp_path, ["-d", "-s"] + flag + [
        "-o", "{out}", str(files["flac"])], out="out.wav")
    assert ours == ref
    assert (ours == files["wav"].read_bytes()) == (spec is None)


def test_test_mode_and_damage(files, tmp_path, capsys):
    assert cli.main(["-t", str(files["flac"])], device="cpu") == 0
    assert jcli.main(["-t", str(files["flac"])]) == 0
    err = capsys.readouterr().err
    assert err.count(f"{files['flac']}: ok") == 2
    data = bytearray(files["flac"].read_bytes())
    data[-40] ^= 0x21
    bad = tmp_path / "bad.flac"
    bad.write_bytes(bytes(data))
    errors = []
    for main, kw in ((cli.main, {"device": "cpu"}), (jcli.main, {})):
        with pytest.raises(Exception) as e:
            main(["-t", "-s", str(bad)], **kw)
        errors.append(type(e.value).__name__)
    assert errors == ["FlacDecodeError", "FlacDecodeError"]


def test_analyze_output_is_identical(files, tmp_path):
    ours, ref = _both(tmp_path, ["-a", "--residual-text", "-o", "{out}",
                                 str(files["flac"])], out="out.ana")
    assert ours == ref
    assert b"\t\tresidual[5]=" in ours and b"warmup[0]=" in ours


def test_cli_skip_until(tmp_path):
    """test_seek.py::test_cli_skip_until through the port's tool."""
    noise = np.random.default_rng(7).integers(
        -20000, 20000, (2, 44100 * 2)).astype(np.int32)
    wav = tmp_path / "in.wav"
    wav.write_bytes(container.write_wav(noise, 44100, 16))
    fl = tmp_path / "in.flac"
    assert cli.main(["-5", "-f", "-b", "1024", "-o", str(fl), str(wav)],
                    device="cpu") == 0
    out = tmp_path / "cut.wav"
    assert cli.main(["-d", "--skip", "44100", "--until", "+1000", "-o",
                     str(out), str(fl)], device="cpu") == 0
    got = container.read_wav(out.read_bytes())
    np.testing.assert_array_equal(got.samples,
                                  noise[:, 44100:44100 + 1000])
    fl2 = tmp_path / "cut.flac"
    assert cli.main(["-5", "-f", "-b", "1024", "--skip", "0:00.5",
                     "--until=-0:00.5", "-o", str(fl2), str(wav)],
                    device="cpu") == 0
    st2 = ref_decode_py(fl2.read_bytes())
    np.testing.assert_array_equal(st2.samples, noise[:, 22050:-22050])


def test_stdin_stdout_pipes(files, monkeypatch, capsysbinary):
    """`-o - -` from a pipe to a pipe, the port's tool in its own process,
    against flac_tpu's in-process output; then the decode back."""
    code = ("import sys\nfrom flac_tpu_torch import cli\n"
            "sys.exit(cli.main(sys.argv[1:], device='cpu'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def port(argv, data):
        out = subprocess.run([sys.executable, "-c", code, *argv],
                             input=data, capture_output=True, cwd=REPO,
                             env=env, timeout=300)
        assert out.returncode == 0, out.stderr.decode()
        return out.stdout
    wav = files["wav"].read_bytes()
    stream = port(ENC + ["-o", "-", "-"], wav)
    monkeypatch.setattr(sys, "stdin", type(
        "Stdin", (), {"buffer": io.BytesIO(wav)})())
    capsysbinary.readouterr()
    assert jcli.main(ENC + ["-o", "-", "-"]) == 0
    assert stream == capsysbinary.readouterr().out
    assert port(["-d", "-s", "-o", "-", "-"], stream) == wav

