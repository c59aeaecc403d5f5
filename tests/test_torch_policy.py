"""Rules of the flac_tpu_torch package: it never imports JAX or flac_tpu,
its entry points run on the GPU unless asked for the CPU (and raise when
there is none, whatever the engine), what is not ported raises
NotImplementedError, and chip_smoke.py fails without a GPU."""

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
from flac_tpu_torch.decoder import ENGINES, decode_stream_auto
from flac_tpu_torch.encoder import StreamEncoder, encode_file_to_flac

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "flac_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_variants.py"]


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
    for engine in ENGINES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decode_stream_tpu(stream, engine=engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_stream_tpu(stream, tolerant=True)
    st = decode_stream_tpu(stream, device="cpu")
    assert st.md5_ok and np.array_equal(st.samples, pcm)


@pytest.mark.parametrize("what", ["fast", "scan", "auto", "tolerant",
                                  "ogg"])
def test_unported_decode_features_raise(what):
    """Ogg input is not ported and raises NotImplementedError.  The engines
    and the tolerant mode that raised it before are ported: they decode on
    the CPU when asked to."""
    pcm = np.zeros((2, 3000), np.int32)
    pcm[:, 1000:] = 7
    stream = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, blocksize=1024), device="cpu")
    if what == "ogg":
        with pytest.raises(NotImplementedError, match="Ogg"):
            decode_stream_auto(b"OggS" + stream, device="cpu")
        return
    kw = {"tolerant": True} if what == "tolerant" else {"engine": what}
    st = decode_stream_tpu(stream, device="cpu", **kw)
    assert st.md5_ok and np.array_equal(st.samples, pcm)


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
        "from flac_tpu_torch.ops import pack_cuda, restore_cuda, rice_cuda\n"
        "print(native._lib is None, kernels.LOADED == {},\n"
        "      pack_cuda._lib is None, rice_cuda._lib is None,\n"
        "      restore_cuda._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 5


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


def test_kernel_variants_fails_without_gpu(no_gpu):
    """The variant timer exits non-zero without a GPU."""
    out = subprocess.run([sys.executable, str(REPO / "kernel_variants.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA GPU" in out.stderr


@pytest.mark.parametrize("source, name, value", [
    ("rice_codes.cu", "THREADS", "STAGE_LANES"),
    ("rice_codes.cu", "STAGE_ROWS", "STAGE_ROWS"),
    ("pack_fields64.cu", "CLUSTER", "CLUSTER"),
    ("pack_fields64.cu", "TILE_WORDS_MAX", "TILE_WORDS_MAX"),
    ("restore.cu", "THREADS", "THREADS"),
    ("restore.cu", "GROUP", "GROUP"),
    ("restore.cu", "SUBS", "SUBS"),
    ("restore.cu", "K", "K"),
    ("restore.cu", "IN_STAGES", "IN_STAGES"),
    ("restore.cu", "OUT_STAGES", "OUT_STAGES"),
    ("restore.cu", "IN_PAD", "IN_PAD"),
    ("restore.cu", "BARS_BYTES", "BARS_BYTES")])
def test_host_mirrors_match_the_kernel_sources(source, name, value):
    """The constants that the host mirrors of the kernels' rules
    (rice_cuda.staged_ctas, pack_cuda.rank_words, the restore's
    folded_subframes, round_len and smem_bytes) and the restore's wrapper
    (its alignment rule) copy are the sources'."""
    import re

    from flac_tpu_torch.ops import pack_cuda, restore_cuda, rice_cuda
    text = (REPO / "flac_tpu_torch" / "csrc" / source).read_text()
    consts = {m[0]: m[1] for m in re.findall(
        r"constexpr int (\w+) = ([^;]+);", text)}
    expr = consts[name]
    for _ in range(3):                   # constants defined by constants
        expr = re.sub(r"[A-Z_]{3,}", lambda m: f"({consts[m[0]]})", expr)
    module = {"rice_codes.cu": rice_cuda, "pack_fields64.cu": pack_cuda,
              "restore.cu": restore_cuda}[source]
    assert eval(expr) == getattr(module, value)


def test_chip_smoke_reads_the_ptxas_report():
    """Registers, spills and static shared memory per kernel, from nvcc's
    -Xptxas -v report as ptxas 12.x prints it."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    fn = "_ZN4anon17rice_codes_kernelILb0EEEv"
    report = (
        "ptxas info    : 8 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {fn}\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 32 bytes smem\n"
        "ptxas info    : Compiling entry function 'probe' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers, used 0 barriers\n")
    assert chip_smoke.ptxas_usage(report, "rice_codes_kernel") == {
        fn: {"spill_stores": 4, "spill_loads": 8, "registers": 32,
             "smem_static_bytes": 32}}
    assert chip_smoke.ptxas_usage(report, "probe") == {
        "probe": {"registers": 12, "smem_static_bytes": 0}}
