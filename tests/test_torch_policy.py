"""Rules of the flac_tpu_torch package: it never imports JAX or flac_tpu,
its entry points run on the GPU unless asked for the CPU (and raise when
there is none), what is not ported raises NotImplementedError, and
chip_smoke.py fails without a GPU."""

import ast
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flac_tpu_torch
from flac_tpu_torch import EncoderConfig, decode_stream_tpu, kernels
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "flac_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_leaves_no_jax_or_flac_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flac_tpu_torch\n"
        "for m in pkgutil.walk_packages(flac_tpu_torch.__path__,\n"
        "                               'flac_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flac_tpu')]\n"
        "print(len(list(pkgutil.walk_packages(flac_tpu_torch.__path__))),\n"
        "      sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 5
    assert bad.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_flac_tpu_import_statement(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flac_tpu"), \
                f"{path.name} imports {name}"


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would use it")


def test_entry_points_default_to_the_gpu_and_raise_without_one(no_gpu):
    cfg = EncoderConfig.from_preset(5, blocksize=1024)
    pcm = np.zeros((2, 3000), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamEncoder(io.BytesIO(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_file_to_flac(pcm, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_file_to_flac(pcm, cfg, device="cuda")
    assert encode_file_to_flac(pcm, cfg, device="cpu")[:4] == b"fLaC"


def test_decode_defaults_to_the_gpu_and_raises_without_one(no_gpu):
    pcm = np.zeros((2, 3000), np.int32)
    stream = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, blocksize=1024), device="cpu")
    for engine in ("device", "host"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decode_stream_tpu(stream, engine=engine)
    st = decode_stream_tpu(stream, device="cpu")
    assert st.md5_ok and np.array_equal(st.samples, pcm)


@pytest.mark.parametrize("what", ["fast", "scan", "auto", "tolerant"])
def test_unported_decode_features_raise(what):
    stream = encode_file_to_flac(np.zeros((2, 3000), np.int32),
                                 EncoderConfig.from_preset(5, blocksize=1024),
                                 device="cpu")
    kw = {"tolerant": True} if what == "tolerant" else {"engine": what}
    with pytest.raises(NotImplementedError):
        decode_stream_tpu(stream, device="cpu", **kw)


def test_import_builds_no_native_library_or_kernel():
    """Importing every module of the package leaves the native runtime and
    the CUDA kernels unbuilt and unloaded: they are built at first use."""
    code = (
        "import importlib, pkgutil\n"
        "import flac_tpu_torch\n"
        "for m in pkgutil.walk_packages(flac_tpu_torch.__path__,\n"
        "                               'flac_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from flac_tpu_torch import kernels, native\n"
        "from flac_tpu_torch.ops import pack_cuda, rice_cuda\n"
        "print(native._lib is None, kernels.LOADED == {},\n"
        "      pack_cuda._lib is None, rice_cuda._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 4


def test_tf32_is_off():
    assert flac_tpu_torch.__name__ == "flac_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


class _PacketSink(io.BytesIO):
    def write_frames(self, blob, lens, n):
        raise AssertionError("not reached")


@pytest.mark.parametrize("what", ["bps32-mid-side", "seektable", "verify",
                                  "extra-metadata", "ogg-sink"])
def test_unported_features_raise(what):
    cfg = EncoderConfig.from_preset(5, blocksize=1024)
    kw = {"device": "cpu"}
    out = io.BytesIO()
    if what == "bps32-mid-side":
        cfg = EncoderConfig.from_preset(5, blocksize=1024,
                                        bits_per_sample=32)
    elif what == "seektable":
        kw["seektable"] = object()
    elif what == "verify":
        kw["verify"] = True
    elif what == "extra-metadata":
        kw["extra_metadata"] = [(4, b"x")]
    else:
        out = _PacketSink()
    with pytest.raises(NotImplementedError):
        StreamEncoder(out, cfg, **kw)


def test_nothing_is_built_on_import():
    assert kernels.LOADED == {}
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.nvcc_path()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_package(where, tmp_path, no_gpu):
    """Without a GPU, and in a directory that holds chip_smoke.py and
    nothing else of the repo, the smoke test exits non-zero and prints no
    result line."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
