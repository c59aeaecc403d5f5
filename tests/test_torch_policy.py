"""Rules of the flac_tpu_torch package: it never imports JAX or flac_tpu,
its entry points (the command lines too) run on the GPU unless asked for
the CPU (and raise when there is none, whatever the engine), nothing is
built on import, and chip_smoke.py fails without a GPU.

Features that were pinned here as unported while they were (seek tables,
verify, extra metadata, the Ogg sink, Ogg decoding, the 33-bit side
channel) are held against flac_tpu in test_torch_encoder_api.py,
test_torch_seek.py, test_torch_ogg.py and test_torch_hires.py."""

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
from flac_tpu_torch.decoder import ENGINES
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
        "print(' '.join(m.name for m in pkgutil.walk_packages(\n"
        "    flac_tpu_torch.__path__, 'flac_tpu_torch.')))\n"
        "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    walked, bad = out.stdout.splitlines()
    assert {f"flac_tpu_torch.{m}" for m in (
        "encoder", "decoder", "metadata", "seek", "cuesheet", "ogg",
        "ops.restore_cuda", "container", "foreign", "replaygain", "cli",
        "metaflac_cli", "native.__main__", "parallel.shard",
        "parallel.multihost")} <= set(walked.split())
    assert bad.strip() == "[]"


@pytest.mark.parametrize("module", ["flac_tpu_torch.cli",
                                    "flac_tpu_torch.metaflac_cli",
                                    "flac_tpu_torch.native.__main__",
                                    "flac_tpu_torch.parallel.multihost"])
def test_command_lines_import_no_jax_or_flac_tpu(module):
    """A fresh process that imports a command line's module (for
    `python -m flac_tpu_torch.native`, the module that it runs) loads
    neither JAX nor flac_tpu, and builds nothing."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "from flac_tpu_torch import native\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flac_tpu')), native._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


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


def test_command_line_defaults_to_the_gpu_and_raises_without_one(
        no_gpu, tmp_path):
    """cli.main without a device, as `python -m flac_tpu_torch.cli` runs
    it, encodes and decodes on the GPU: here it raises and writes no
    stream; with device="cpu" it runs."""
    from flac_tpu_torch import cli, container
    wav = tmp_path / "t.wav"
    wav.write_bytes(container.write_wav(np.zeros((2, 3000), np.int32),
                                        44100, 16))
    out, back = tmp_path / "t.flac", tmp_path / "b.wav"
    for argv, path in ((["-s", "-o", str(out), str(wav)], out),
                       (["-s", "-d", "-o", str(back), str(out)], back)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
        assert not path.exists() or path.stat().st_size == 0
        assert cli.main(argv, device="cpu") == 0
    assert back.read_bytes() == wav.read_bytes()


def test_corpus_runner_defaults_to_the_gpu_and_raises_without_one(
        no_gpu, tmp_path):
    """`python -m flac_tpu_torch.parallel.multihost` encodes on the GPU:
    without one it exits with the "no CUDA device" error and writes
    nothing."""
    from flac_tpu_torch import container
    wav = tmp_path / "t.wav"
    wav.write_bytes(container.write_wav(np.zeros((2, 3000), np.int32),
                                        44100, 16))
    out = subprocess.run(
        [sys.executable, "-m", "flac_tpu_torch.parallel.multihost", "-o",
         str(tmp_path / "out"), str(wav)], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "out").exists()


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


@pytest.mark.parametrize("what", ["fast", "scan", "auto", "tolerant"])
def test_unported_decode_features_raise(what):
    """The engines and the tolerant mode that raised NotImplementedError
    before they were ported decode on the CPU when asked to."""
    pcm = np.zeros((2, 3000), np.int32)
    pcm[:, 1000:] = 7
    stream = encode_file_to_flac(pcm, EncoderConfig.from_preset(
        5, blocksize=1024), device="cpu")
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
        "from flac_tpu_torch.ops import (assemble_cuda, assign_cuda,\n"
        "    autoc_cuda, candidates_cuda, lpc_cuda, pack_cuda,\n"
        "    residuals_cuda, restore_cuda, rice_cost_cuda, rice_cuda,\n"
        "    seal_cuda, select_cuda)\n"
        "print(native._lib is None, kernels.LOADED == {},\n"
        "      pack_cuda._lib is None, rice_cuda._lib is None,\n"
        "      restore_cuda._lib is None, assemble_cuda._lib is None,\n"
        "      seal_cuda._lib is None, lpc_cuda._lib is None,\n"
        "      rice_cost_cuda._lib is None, residuals_cuda._lib is None,\n"
        "      select_cuda._lib is None, candidates_cuda._lib is None,\n"
        "      autoc_cuda._lib is None, assign_cuda._lib is None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 14


def test_tf32_is_off():
    assert flac_tpu_torch.__name__ == "flac_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_nothing_is_built_on_import():
    assert kernels.LOADED == {}
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            kernels.nvcc_path()


def test_library_name_covers_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source and the csrc/*.cuh headers, so an
    edit to either gives a new name and the source is rebuilt."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "SRC_DIR", tmp_path)
    names = [kernels._library_path("k")]
    (tmp_path / "h.cuh").write_text("// two\n")
    names.append(kernels._library_path("k"))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    names.append(kernels._library_path("k"))
    assert len(set(names)) == 3
    assert names[-1] == kernels._library_path("k")


@pytest.mark.parametrize("name, module, dispatcher, plain", [
    ("candidate_residuals", "residuals_cuda", "candidate_residuals",
     "candidate_residuals_plain"),
    ("select_realize", "select_cuda", "select_and_realize",
     "select_and_realize_plain")])
def test_search_kernels_take_cuda_tensors_and_hash_their_sources(
        name, module, dispatcher, plain, monkeypatch, tmp_path):
    """K8 and K9: a tensor on the card goes to the kernel's wrapper and
    never to the plain version; the wrapper launches or raises (here, on
    a CPU tensor, it raises: there is no fallback); each library is named
    by a hash of its own source (and the shared headers and flags), so an
    edited source is rebuilt."""
    import hashlib
    import importlib
    import types

    from flac_tpu_torch.models import subframe
    mod = importlib.import_module(f"flac_tpu_torch.ops.{module}")
    wrapper = getattr(mod, dispatcher)
    calls = []
    outputs = getattr(mod, "OUTPUTS", ("res", "order", "f_ok", "fit_ok"))

    def launched(*a):
        calls.append(a)
        return tuple(range(len(outputs)))

    def refuse(*a):
        raise AssertionError("the plain version took a tensor on the card")
    monkeypatch.setattr(mod, dispatcher, launched)
    monkeypatch.setattr(subframe, plain, refuse)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    n_args = 8 if name == "candidate_residuals" else 14
    getattr(subframe, dispatcher)(on_card, *range(1, n_args))
    assert len(calls) == 1 and calls[0][0] is on_card
    monkeypatch.undo()
    with pytest.raises(ValueError, match="not on a GPU"):
        wrapper(torch.zeros((1, 2, 16), dtype=torch.int32),
                *range(1, n_args))
    # the library's name: a hash of the source, the headers and the flags
    src = kernels.SRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes()
                       for h in sorted(kernels.SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(
        kernels.NVCC_FLAGS).encode()).hexdigest()[:12]
    assert kernels._library_path(name).name == f"lib{name}-{digest}.so"
    for f in [src, *kernels.SRC_DIR.glob("*.cuh")]:
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(kernels, "SRC_DIR", tmp_path)
    before = kernels._library_path(name)
    assert before.name == f"lib{name}-{digest}.so"
    (tmp_path / src.name).write_text(src.read_text() + "// edited\n")
    assert kernels._library_path(name) != before


@pytest.mark.parametrize("source", ["assemble_fields.cu", "frame_crc.cu"])
def test_cluster_helpers_come_from_one_header(source):
    """The kernels that launch clusters take the rank, barrier and remote
    store helpers from csrc/cluster.cuh and define none of their own."""
    import re

    csrc = REPO / "flac_tpu_torch" / "csrc"
    text = (csrc / source).read_text()
    header = (csrc / "cluster.cuh").read_text()
    assert '#include "cluster.cuh"' in text
    for fn in ("cluster_rank", "cluster_size", "cluster_arrive_relaxed",
               "cluster_wait", "cluster_barrier", "store_remote"):
        pattern = rf"__device__ __forceinline__ \w+ {fn}\("
        assert re.search(pattern, header)
        assert not re.search(pattern, text)


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
    ("restore.cu", "BARS_BYTES", "BARS_BYTES"),
    ("assemble_fields.cu", "HEAD_FIELDS", "HEAD_FIELDS"),
    ("assemble_fields.cu", "MAX_CHANNELS", "MAX_CHANNELS"),
    ("frame_crc.cu", "POW_TERMS", "POW_TERMS")])
def test_host_mirrors_match_the_kernel_sources(source, name, value):
    """The constants that the host mirrors of the kernels' rules
    (rice_cuda.staged_ctas, pack_cuda.rank_words, the restore's
    folded_subframes, round_len and smem_bytes, the field layout of
    assemble_cuda.field_layout, the size of seal_cuda.tables) and the
    restore's wrapper (its alignment rule) copy are the sources'."""
    import re

    from flac_tpu_torch.ops import (assemble_cuda, pack_cuda, restore_cuda,
                                    rice_cuda, seal_cuda)
    text = (REPO / "flac_tpu_torch" / "csrc" / source).read_text()
    consts = {m[0]: m[1] for m in re.findall(
        r"constexpr int (\w+) = ([^;]+);", text)}
    expr = consts[name]
    for _ in range(3):                   # constants defined by constants
        expr = re.sub(r"[A-Z_]{3,}", lambda m: f"({consts[m[0]]})", expr)
    module = {"rice_codes.cu": rice_cuda, "pack_fields64.cu": pack_cuda,
              "restore.cu": restore_cuda,
              "assemble_fields.cu": assemble_cuda,
              "frame_crc.cu": seal_cuda}[source]
    assert eval(expr) == getattr(module, value)


def test_wide_frame_rule_matches_the_native_source():
    """The device engines and the native fused decode send the same frames
    to their int64 paths: flac_native.cpp's FT_WIDE_BPS is
    decoder_fast.WIDE_BPS."""
    import re

    from flac_tpu_torch import decoder_fast
    text = (REPO / "flac_tpu_torch" / "native" / "flac_native.cpp").read_text()
    found = re.findall(r"constexpr int FT_WIDE_BPS = (\d+);", text)
    assert found == [str(decoder_fast.WIDE_BPS)]
    assert "ch_bps[f * C + c] >= FT_WIDE_BPS" in text


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
