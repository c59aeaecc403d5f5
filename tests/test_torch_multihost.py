"""flac_tpu_torch.parallel.multihost against flac_tpu.parallel.multihost,
on the CPU.

The frame-range splice of tests/test_multihost.py (2 and 3 simulated
hosts over 7 frames, 5 hosts over 3) must give the single-process
stream's frames; each host's blob and the lengths equal flac_tpu's at -2;
a real two-process gloo group gives what the simulation gives; the corpus
runner writes StreamEncoder's bytes.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import flac_tpu
from flac_tpu.parallel import multihost as ref_multihost
from flac_tpu.parallel.shard import data_mesh as ref_data_mesh
from flac_tpu_torch import EncoderConfig, container
from flac_tpu_torch.encoder import encode_file_to_flac
from flac_tpu_torch.parallel import multihost
from flac_tpu_torch.parallel.multihost import (encode_file_ranges,
                                               host_file_shard,
                                               init_distributed)
from flac_tpu_torch.parallel.shard import encode_blocks_dp

from conftest import make_test_signal

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 256
CPU = ("cpu",)


def _blocks(B, channels=2):
    pcm = make_test_signal(B * N, channels=channels, seed=3)
    return pcm.reshape(channels, B, N).transpose(1, 0, 2)


def _single_process_bytes(blocks, cfg):
    words, lens = encode_blocks_dp(blocks, 0, cfg, CPU)
    return b"".join(words[i].astype(">u4").tobytes()[:int(lens[i])]
                    for i in range(blocks.shape[0]))


def _splice(blocks, cfg, num_hosts, **kw):
    """Every simulated host's (blob, all_lens, offset)."""
    return [encode_file_ranges(blocks, cfg, host_id=h, num_hosts=num_hosts,
                               **kw) for h in range(num_hosts)]


@pytest.mark.parametrize("num_hosts, B, preset", [(2, 7, 5), (3, 7, 5),
                                                  (5, 3, 2)])
def test_range_splice_matches_single_process(num_hosts, B, preset):
    """Uneven ranges (the last host short, or hosts past the last frame
    with empty blobs): each offset is the spliced prefix, and the splice is
    the single-process frames."""
    cfg = EncoderConfig.from_preset(preset, blocksize=N).resolve()
    blocks = _blocks(B)
    blobs = []
    for h, (blob, all_lens, off) in enumerate(
            _splice(blocks, cfg, num_hosts, mesh=("cpu",) * 2)):
        assert all_lens.shape == (num_hosts,) and all_lens.dtype == np.int64
        assert off == sum(len(b) for b in blobs)
        assert all_lens[h] == len(blob)
        blobs.append(blob)
    assert b"".join(blobs) == _single_process_bytes(blocks, cfg)


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_range_splice_matches_flac_tpu(num_hosts):
    """At -2 each host's blob, the lengths and the offsets are flac_tpu's."""
    blocks = _blocks(7)
    ours = _splice(blocks, EncoderConfig.from_preset(2, blocksize=N)
                   .resolve(), num_hosts, device="cpu")
    ref = [
        ref_multihost.encode_file_ranges(
            blocks, flac_tpu.EncoderConfig.from_preset(2, blocksize=N)
            .resolve(), host_id=h, num_hosts=num_hosts,
            mesh=ref_data_mesh(jax.devices()[:1]))
        for h in range(num_hosts)]
    for (blob, lens, off), (rblob, rlens, roff) in zip(ours, ref):
        assert blob == rblob and off == roff
        np.testing.assert_array_equal(lens, rlens)


def test_host_file_shard_matches_flac_tpu():
    paths = [f"f{i}.wav" for i in range(10)]
    for hosts in (1, 3, 4):
        shards = [host_file_shard(paths, h, hosts) for h in range(hosts)]
        assert shards == [ref_multihost.host_file_shard(paths, h, hosts)
                          for h in range(hosts)]
        assert sorted(p for s in shards for p in s) == sorted(paths)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


RANK_SCRIPT = """
import sys
import numpy as np
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch.parallel import multihost
port, rank, src, out = sys.argv[1:]
rank = int(rank)
assert multihost.init_distributed(f"localhost:{port}", 2, rank) == (rank, 2)
blob, lens, off = multihost.encode_file_ranges(
    np.load(src), EncoderConfig.from_preset(5, blocksize=%d).resolve(),
    device="cpu")
np.savez(out, blob=np.frombuffer(blob, np.uint8), lens=lens, off=off)
""" % N


def test_two_processes_over_gloo(tmp_path):
    """Two processes in a gloo group on the CPU: each encodes its range
    and gathers the lengths; together they give the simulation's blobs,
    lengths and offsets."""
    blocks = _blocks(7)
    src = tmp_path / "blocks.npy"
    np.save(src, blocks)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(port), str(r), str(src),
         str(tmp_path / f"rank{r}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], outs
    cfg = EncoderConfig.from_preset(5, blocksize=N).resolve()
    for r, (blob, lens, off) in enumerate(_splice(blocks, cfg, 2,
                                                  device="cpu")):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["blob"].tobytes() == blob
        np.testing.assert_array_equal(got["lens"], lens)
        assert int(got["off"]) == off


def test_init_distributed_without_a_group(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert not dist.is_initialized()


@pytest.fixture
def wavs(tmp_path):
    paths = []
    for i, seconds in enumerate((0.3, 0.2, 0.25)):
        pcm = make_test_signal(int(44100 * seconds), seed=40 + i)
        path = tmp_path / f"clip{i}.wav"
        path.write_bytes(container.write_wav(pcm, 44100, 16))
        paths.append((str(path), pcm))
    return paths


def test_corpus_runner_writes_stream_encoder_bytes(wavs, tmp_path, capsys):
    """main(..., device="cpu") in one process writes every file, each the
    bytes StreamEncoder writes at the runner's settings, and prints the
    reference's lines."""
    out = tmp_path / "out"
    assert multihost.main(["-3", "--batch-frames", "4", "-o", str(out)]
                          + [p for p, _ in wavs], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    for line, (path, pcm) in zip(lines, wavs):
        name = Path(path).stem + ".flac"
        data = (out / name).read_bytes()
        assert line == f"[host 0/1] {out / name}: {len(data)} bytes"
        assert data == encode_file_to_flac(
            pcm, EncoderConfig.from_preset(3), batch_frames=4,
            device="cpu")


def test_corpus_runner_decodes_flac_input_on_its_device(wavs, tmp_path,
                                                        capsys):
    """A FLAC input decodes on the runner's device: with device="cpu" the
    run needs no GPU, and writes StreamEncoder's bytes for the decoded
    samples."""
    path, pcm = wavs[0]
    src = tmp_path / "in.flac"
    src.write_bytes(encode_file_to_flac(pcm, EncoderConfig.from_preset(0),
                                        device="cpu"))
    out = tmp_path / "out"
    assert multihost.main(["-3", "--batch-frames", "4", "-o", str(out),
                           str(src)], device="cpu") == 0
    data = (out / "in.flac").read_bytes()
    assert capsys.readouterr().out.splitlines() == [
        f"[host 0/1] {out / 'in.flac'}: {len(data)} bytes"]
    assert data == encode_file_to_flac(
        pcm, EncoderConfig.from_preset(3), batch_frames=4, device="cpu")


def test_corpus_shard_is_round_robin(wavs, tmp_path):
    """Host 1 of 2 writes only the second file."""
    out = tmp_path / "out"
    results = multihost.encode_corpus(
        [p for p, _ in wavs], EncoderConfig.from_preset(0), str(out),
        host_id=1, num_hosts=2, device="cpu")
    assert [Path(p).name for p, _ in results] == ["clip1.flac"]
    assert sorted(os.listdir(out)) == ["clip1.flac"]
