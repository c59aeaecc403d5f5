"""Build and load the package's CUDA sources (`csrc/*.cu`) at first use.

A source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
with a plain C interface, loaded with ctypes.  Libraries go to
`flac_tpu_torch/build/` (listed in .gitignore), named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused within a
checkout.  Several sources build in parallel
(`load_all`: one nvcc each, started together).  Nothing is imported or
built when the package is imported: the CPU paths never need `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (loaded library, nvcc's report or "cached") in this process
LOADED: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("flac_tpu_torch: nvcc not found; the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def _library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    # the headers a source may include (csrc/*.cuh) are part of its hash
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _build(names) -> dict:
    """Build every missing library of `names` with one nvcc per source, all
    started together, so the sources cost one build time, not the sum.
    Returns {name: nvcc's report}, kept beside each library (or "cached"
    for a library built without one); raises with the compiler's output if
    a build fails."""
    reports, procs = {}, {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            saved = lib.with_suffix(".txt")
            reports[name] = saved.read_text() if saved.exists() else "cached"
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        lib.with_suffix(".txt").write_text(out)
        os.replace(tmp, lib)      # atomic: concurrent builds agree
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load_all(names) -> dict:
    """Build the missing libraries of `names` in parallel, then load each;
    returns {name: nvcc's report (register counts, spills, shared
    memory)}."""
    for name, report in _build([n for n in names
                                 if n not in LOADED]).items():
        LOADED[name] = (ctypes.CDLL(str(_library_path(name))), report)
    return {n: LOADED[n][1] for n in names}


def load(name: str) -> tuple[ctypes.CDLL, str]:
    """The loaded library of `csrc/<name>.cu`, built on first use, and
    nvcc's report.  Raises with the compiler's output if the build fails."""
    load_all([name])
    return LOADED[name]


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
