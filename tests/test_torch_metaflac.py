"""flac_tpu_torch.metaflac_cli against flac_tpu.metaflac_cli, on the CPU.

Each case runs the same metaflac command lines, in order, through both
tools, each on its own copy of one file (same name, in a directory of its
own): every step must print the same bytes on stdout and leave
byte-identical files.  The cases are those of tests/test_metadata.py
(test_metaflac_cli and the four after it) and the rest of the tool's
surface: listing and block filters, tag import and export, pictures,
cuesheets, ReplayGain, seek points and padding, the STREAMINFO setters.
Afterwards the audio must still decode with its MD5.

One difference is kept on purpose: with --dont-use-padding flac_tpu's
tool truncates the file before it reads the frames back, and then raises;
the port's reads them first (test_dont_use_padding_keeps_the_audio).
flac_tpu's --list prints to the sys.stdout of its import; the port's to
that of the call.  Here flac_tpu's is pointed at the call's too, so that
both listings are captured.
"""

import io
import sys

import numpy as np
import pytest
import torch

from flac_tpu import metaflac_cli as jmetaflac
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, metaflac_cli
from flac_tpu_torch import format as fmt
from flac_tpu_torch import metadata as md
from flac_tpu_torch.encoder import encode_file_to_flac

from conftest import make_test_signal

torch.set_num_threads(1)

PCM = make_test_signal(8192)
CUE = ('FILE "t.wav" WAVE\n  TRACK 01 AUDIO\n    INDEX 01 00:00:00\n'
       '  TRACK 02 AUDIO\n    INDEX 00 00:00:02\n    INDEX 01 00:00:05\n')


def _source(tags=("A=1", "B=2", "A=3")):
    vc = md.VorbisCommentBlock()
    vc.comments.extend(tags)
    return encode_file_to_flac(PCM, EncoderConfig.from_preset(2),
                               extra_metadata=[(vc.TYPE, vc.to_bytes())],
                               device="cpu")


SOURCE = _source()
APP = b"xmpl" + b"hello world"

CASES = {
    # test_metadata.py::test_metaflac_cli
    "set and show tags": [["--set-tag=TITLE=hello"], ["--show-tag=TITLE"],
                          ["--show-sample-rate"]],
    # ::test_metaflac_set_tag_from_file
    "set tag from file": [["--set-tag-from-file=LYRICS=lyrics.txt"],
                          ["--show-tag=LYRICS"]],
    # ::test_metaflac_block_number_remove
    "remove by block number": [["--remove", "--block-number=1"], ["--list"]],
    # ::test_metaflac_append_and_streaminfo_setters
    "append and set md5": [["--append"], ["--set-md5sum=" + "ab" * 16],
                           ["--show-md5sum"]],
    # ::test_metaflac_list_binary_roundtrip
    "list binary": [["--list", "--data-format=binary"]],
    "list text and filters": [
        ["--list"], ["--list", "--block-type=VORBIS_COMMENT,PADDING"],
        ["--list", "--except-block-type=STREAMINFO"],
        ["--list", "--block-number=0,2"]],
    "show streaminfo": [["--show-md5sum", "--show-min-blocksize",
                         "--show-max-blocksize", "--show-min-framesize",
                         "--show-max-framesize", "--show-channels",
                         "--show-bps", "--show-total-samples",
                         "--show-vendor-tag", "--show-all-tags"]],
    "tag edits": [["--remove-first-tag=A"], ["--remove-tag=B",
                                             "--set-tag=C=ç"],
                  ["--export-tags-to=-"], ["--remove-all-tags-except=A"],
                  ["--show-all-tags"], ["--remove-all-tags"],
                  ["--export-tags-to=out.txt"]],
    "import tags": [["--import-tags-from=tags.txt"], ["--export-tags-to=-"]],
    "pictures": [["--import-picture-from=3|image/png|cover|1x1x24|c.png"],
                 ["--import-picture-from=c.png"],
                 ["--list", "--block-type=PICTURE"],
                 ["--export-picture-to=out.png"]],
    "cuesheet": [["--import-cuesheet-from=t.cue"],
                 ["--export-cuesheet-to=-"], ["--list"]],
    "replay gain": [["--add-replay-gain"], ["--show-all-tags"],
                    ["--scan-replay-gain"], ["--remove-replay-gain"],
                    ["--show-all-tags"]],
    "seekpoints and padding": [["--add-seekpoint=0.05s",
                                "--add-seekpoint=100", "--add-padding=100"],
                               ["--list"], ["--merge-padding"],
                               ["--sort-padding"], ["--list"]],
    "remove all": [["--remove-all"], ["--list"]],
    "streaminfo setters": [["--set-total-samples=5", "--set-bps=24",
                            "--set-sample-rate=48000", "--set-channels=1",
                            "--set-min-blocksize=16",
                            "--set-max-blocksize=4096",
                            "--set-min-framesize=1",
                            "--set-max-framesize=2"], ["--list"]],
}


def _run(main, argv, capsysbinary, monkeypatch):
    monkeypatch.setattr(sys, "stdin", type(
        "Stdin", (), {"buffer": io.BytesIO(
            md.block_header(fmt.METADATA_TYPE_APPLICATION, len(APP), False)
            + APP)})())
    capsysbinary.readouterr()
    rc = main(argv + ["t.flac"])
    return rc, capsysbinary.readouterr().out


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match(case, tmp_path, capsysbinary, monkeypatch):
    monkeypatch.setattr(jmetaflac.list_blocks, "__defaults__",
                        (None,) + jmetaflac.list_blocks.__defaults__[1:])
    dirs = {}
    for tag in ("port", "ref"):
        d = dirs[tag] = tmp_path / tag
        d.mkdir()
        (d / "t.flac").write_bytes(SOURCE)
        (d / "lyrics.txt").write_text("line one\nline two\n")
        (d / "tags.txt").write_text("X=1\nY=two words\n")
        (d / "c.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
        (d / "t.cue").write_text(CUE)
    for step in CASES[case]:
        outs = []
        for tag, main in (("port", metaflac_cli.main),
                          ("ref", jmetaflac.main)):
            monkeypatch.chdir(dirs[tag])
            outs.append(_run(main, step, capsysbinary, monkeypatch))
        assert outs[0] == outs[1], step
        if step[0] == "--list" and step[-1] != "--data-format=binary":
            assert b"METADATA block #" in outs[0][1]
        for f in sorted(p.name for p in dirs["ref"].iterdir()):
            assert (dirs["port"] / f).read_bytes() == \
                (dirs["ref"] / f).read_bytes(), (step, f)
    if case != "streaminfo setters":
        st = decode_stream_tpu((dirs["port"] / "t.flac").read_bytes(),
                               engine="host", device="cpu",
                               verify_md5=case != "append and set md5")
        np.testing.assert_array_equal(st.samples, PCM)


def test_dont_use_padding_keeps_the_audio(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "t.flac").write_bytes(SOURCE)
    assert metaflac_cli.main(["--dont-use-padding", "--set-tag=Z=1",
                              "t.flac"]) == 0
    data = (tmp_path / "t.flac").read_bytes()
    assert md.Chain.read(data).get(
        fmt.METADATA_TYPE_VORBIS_COMMENT).get("Z") == ["1"]
    st = decode_stream_tpu(data, engine="host", device="cpu")
    assert st.md5_ok
    np.testing.assert_array_equal(st.samples, PCM)
    # flac_tpu's tool opens the file for writing before it reads the
    # frames, then raises with the file empty
    (tmp_path / "t.flac").write_bytes(SOURCE)
    with pytest.raises(TypeError):
        jmetaflac.main(["--dont-use-padding", "--set-tag=Z=1", "t.flac"])
    assert (tmp_path / "t.flac").read_bytes() == b""
