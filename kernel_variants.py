#!/usr/bin/env python3
"""Where the time of kernels K1, K2 and K3 goes, on one NVIDIA GPU.

    python3 kernel_variants.py            # every variant of every kernel
    python3 kernel_variants.py --k1       # K1's only (or --k2, --k3)
    python3 kernel_variants.py --other "old=DIR"  # and DIR/*.cu as they are

Each variant is the kernel's source with one change (a constant, a part of
the work cut out or moved, or timestamps), built by nvcc into a library of
its own under flac_tpu_torch/build/variants/ and timed at the main path's
shapes: K1 on a -5 batch's fields (64 frames of 2263 fields into 8192
words), K2 on the first full decode batch of a 100 s -5 stream (65,536
lanes of 128 codes), K3 on the same batch's residuals (2048 subframes of
4096 samples, int32 in, int16 out).  A variant that cuts work out
computes a wrong result; it is timed only.  `ms` is the device time of one launch
(torch.profiler over 50 launches), taken in turns with the unchanged
kernel ("base") so drift shows.  A "phases" variant also reports, from
one more launch, each CTA's clock64() at numbered points of the kernel
(see PHASE_DEFS).  `--other` times another version of a source (another
commit's csrc/, say) beside them.  Prints one JSON line a variant and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "flac_tpu_torch" / "csrc"
OUT = HERE / "flac_tpu_torch" / "build" / "variants"

# A "phases" variant records clock64() at numbered points of each CTA
# (thread 0's view; PHMAX: the last warp's) and %globaltimer at the CTA's
# start and end; after its timing the script prints where a CTA's cycles go.
PHASE_SLOTS = 10        # per CTA: points 0-7 in cycles, 8-9 globaltimer ns
PHASE_DEFS = r"""
__device__ long long g_ph[65536 * 10];
__device__ __forceinline__ long long gtimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define PH(k) do { if (threadIdx.x == 0) \
    g_ph[blockIdx.x * 10 + (k)] = clock64(); } while (0)
#define PHMAX(k) do { if ((threadIdx.x & 31) == 0) { \
    atomicMax((unsigned long long*)&g_ph[blockIdx.x * 10 + (k)], \
              (unsigned long long)clock64()); \
    atomicMax((unsigned long long*)&g_ph[blockIdx.x * 10 + 9], \
              (unsigned long long)gtimer()); } } while (0)
#define PHSTART() do { if (threadIdx.x == 0) { \
    g_ph[blockIdx.x * 10 + 8] = gtimer(); \
    g_ph[blockIdx.x * 10] = clock64(); } } while (0)
"""
PHASE_TAIL = r"""
extern "C" int flac_phases(void* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, g_ph, n * sizeof(long long));
}
extern "C" int flac_phases_clear(int n) {
    void* p;
    const cudaError_t e = cudaGetSymbolAddress(&p, g_ph);
    return e ? (int)e : (int)cudaMemset(p, 0, n * sizeof(long long));
}
"""

K1_PHASES = [
    ("namespace {\n", "namespace {\n" + PHASE_DEFS),
    ("    __shared__ int share_neg[CLUSTER];\n",
     "    __shared__ int share_neg[CLUSTER];\n    PHSTART();\n"),
    ("    neg = __syncthreads_or(neg);\n",
     "    neg = __syncthreads_or(neg);\n    PH(1);\n"),
    ("        asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n",
     "        asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
     "    PH(2);\n"),
    ("    cluster_barrier();\n\n    // 2.",
     "    cluster_barrier();\n    PH(3);\n\n    // 2."),
    ("                min(W, used + (rank + 1) * zper));\n",
     "                min(W, used + (rank + 1) * zper));\n    PH(4);\n"),
    ("        cluster_barrier();               // every contribution has landed\n",
     "        PH(5);\n        cluster_barrier();\n        PH(6);\n"),
    ("        store_words(out, first, tile, lo, lo, min(used, lo + own));\n    }\n",
     "        store_words(out, first, tile, lo, lo, min(used, lo + own));\n    }\n"
     "    PHMAX(7);\n"),
    ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]
# the zero words past `used` stored after the last cluster barrier, so
# that no barrier's release waits for their stores
K1_ZEROS_LAST = [
    ("    store_words(out, first, nullptr, 0, used + rank * zper,\n"
     "                min(W, used + (rank + 1) * zper));\n", ""),
    ("        store_words(out, first, tile, lo, lo, min(used, lo + own));\n"
     "    }\n",
     "        store_words(out, first, tile, lo, lo, min(used, lo + own));\n"
     "    }\n"
     "    store_words(out, first, nullptr, 0, used + rank * zper,\n"
     "                min(W, used + (rank + 1) * zper));\n")]

# (name, [(old, new), ...]): each old text must occur in the source
K1_VARIANTS = [
    ("base", []),
    ("no deposit", [("if (pb <= 0) continue;", "continue;")]),
    ("launch only", [("    const int rank = (int)cluster.block_rank();",
                      "    if (S > 0) return;\n"
                      "    const int rank = (int)cluster.block_rank();")]),
    ("zeros first", [
        ("        f.load(nzeros, payload, pbits, row, f0 + tid * FPT, f1, true);\n",
         "        f.load(nzeros, payload, pbits, row, f0 + tid * FPT, f1, true);\n"
         "        { const int zh = ((W + CLUSTER - 1) / CLUSTER + 1) & ~1;\n"
         "          store_words(words + (size_t)b * W, (size_t)b * W, nullptr, 0,\n"
         "                      min(W, rank * zh), min(W, (rank + 1) * zh)); }\n"),
        ("    store_words(out, first, nullptr, 0, used + rank * zper,\n"
         "                min(W, used + (rank + 1) * zper));\n", "")]),
    ("phases", K1_PHASES),
    ("zeros last", K1_ZEROS_LAST),
    ("zeros last, phases", K1_ZEROS_LAST + K1_PHASES),
]
K2_VARIANTS = [
    ("base", []),
    ("global path", [("const bool staged = span <= STAGE_ROWS;",
                      "const bool staged = false;")]),
    ("no stores", [
        ("                *out = val;\n",
         "                if (val == 0x7fffffff) *out = val;\n"),
        ("        *out = val;\n        out += L;\n        --rem;\n    }",
         "        if (val == 0x7fffffff) *out = val;\n        out += L;\n"
         "        --rem;\n    }")]),
    ("stage only", [("for (int t = 0; t < T; ++t) {",
                     "for (int t = 0; t < 0; ++t) {")]),
    # the first half (quarter) of the lanes only: the same time means each
    # warp's serial chain sets the pace, half the time that the SM's
    # instruction throughput does
    ("half the lanes", [("const int blocks = (L + THREADS - 1) / THREADS;",
                         "const int blocks = (L / 2 + THREADS - 1) / THREADS;")]),
    ("a quarter of the lanes", [
        ("const int blocks = (L + THREADS - 1) / THREADS;",
         "const int blocks = (L / 4 + THREADS - 1) / THREADS;")]),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __shared__ int warp_lo[NWARPS], warp_hi[NWARPS];\n",
         "    __shared__ int warp_lo[NWARPS], warp_hi[NWARPS];\n    PHSTART();\n"),
        ("    const bool staged = span <= STAGE_ROWS;\n",
         "    const bool staged = span <= STAGE_ROWS;\n    PH(1);\n"),
        ("        if (threadIdx.x == 0) atomicAdd(&g_staged_ctas, 1ull);\n    }\n",
         "        if (threadIdx.x == 0) atomicAdd(&g_staged_ctas, 1ull);\n    }\n"
         "    PH(2);\n"),
        ("    ovf_out[lane] = ovf ? 1 : 0;\n",
         "    ovf_out[lane] = ovf ? 1 : 0;\n    PH(3);\n    PHMAX(4);\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
]


K3_LOAD = ("        load_group<XT>(nxt, rrow, rbytes, n0 + GROUP, N,\n"
           "                       vec_in && n0 + GROUP < N, "
           "live && n0 + GROUP < N);\n")
K3_VARIANTS = [
    ("base", []),
    # residuals made up in registers: no device-memory reads in the loop
    ("no loads", [(K3_LOAD, "#pragma unroll\n        for (int u = 0; u < "
                            "GROUP; ++u) nxt[u] = (XT)(n0 + u);\n")]),
    # the range flag keeps every sample live
    ("no stores", [("        if (live) store_group<XT>(",
                    "        if (live && n0 < 0) store_group<XT>(")]),
    ("no stereo shuffle", [("        if (C == 2) {",
                            "        if (C == 2 && n0 < 0) {")]),
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    XT cur[GROUP];\n", "    PHSTART();\n    XT cur[GROUP];\n"),
        ("    for (int n0 = 0; n0 < N; n0 += GROUP) {\n",
         "    PH(1);\n    for (int n0 = 0; n0 < N; n0 += GROUP) {\n"
         "        if (n0 == 512) PH(2);\n"),
        ("    if (live && bad) oor[frame] = 1;\n",
         "    PH(3);\n    if (live && bad) oor[frame] = 1;\n    PHMAX(4);\n"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
]


def build(kernel: str, variants, others) -> dict:
    """One nvcc per variant, all started together: {name: (library,
    ptxas lines)}.  `others`: {label: directory} of other versions of the
    source (another commit's csrc/), built unchanged."""
    from flac_tpu_torch import kernels
    OUT.mkdir(parents=True, exist_ok=True)
    text = (SRC / f"{kernel}.cu").read_text()
    variants = list(variants) + [
        (label, Path(d) / f"{kernel}.cu") for label, d in others.items()
        if (Path(d) / f"{kernel}.cu").exists()]
    jobs = {}
    for i, (name, edits) in enumerate(variants):
        if isinstance(edits, Path):
            text_i, edits = edits.read_text(), []
        else:
            text_i = text
        src = text_i
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{kernel} variant {name!r}: {old!r} is "
                                 "not in the source")
            src = src.replace(old, new)
        path = OUT / f"{kernel}_v{i}.cu"
        path.write_text(src)
        jobs[name] = (path.with_suffix(".so"), subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if name == "base":
                raise SystemExit(f"nvcc failed for {kernel}:\n{out}")
            print(json.dumps({"kernel": kernel, "variant": name,
                              "nvcc_failed": out[-2000:]}), flush=True)
            continue
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        libs[name] = (ctypes.CDLL(str(lib)), regs)
    return libs


def device_ms(fn, kernel: str, runs: int = 50) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(HERE))
    from chip_smoke import _device_us
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in ev)
    if n != runs:
        raise SystemExit(f"the profiler saw {n} launches of {kernel}")
    return sum(_device_us(e, True) for e in ev) / n / 1e3


def phases(lib, run, ctas: int) -> dict:
    """One launch of a "phases" variant: where each CTA's cycles go.  For
    each point k, the median and the largest count of cycles from the
    CTA's start; `cta_ns`, the median and largest lifetime of a CTA;
    `start_spread_ns`, from the first CTA's start to the last's; `span_ns`,
    from the first start to the last end; `cycles_per_ns`, the SM clock."""
    import numpy as np
    import torch
    n = ctas * PHASE_SLOTS
    lib.flac_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flac_phases_clear.argtypes = [ctypes.c_int]
    torch.cuda.synchronize()
    if lib.flac_phases_clear(n):
        raise SystemExit("flac_phases_clear failed")
    run()
    torch.cuda.synchronize()
    buf = np.zeros(n, np.int64)
    if lib.flac_phases(buf.ctypes.data, n):
        raise SystemExit("flac_phases failed")
    ph = buf.reshape(ctas, PHASE_SLOTS)
    out = {}
    for k in range(1, 8):
        d = ph[:, k] - ph[:, 0]
        d = d[ph[:, k] != 0]
        if len(d):
            out[f"point{k}_cycles"] = [int(np.median(d)), int(d.max())]
    life = ph[:, 9] - ph[:, 8]
    last = max(k for k in range(1, 8) if (ph[:, k] != 0).any())
    out["cta_ns"] = [int(np.median(life)), int(life.max())]
    out["start_spread_ns"] = int(ph[:, 8].max() - ph[:, 8].min())
    out["span_ns"] = int(ph[:, 9].max() - ph[:, 8].min())
    ok = life > 0
    out["cycles_per_ns"] = float(np.median(
        (ph[ok, last] - ph[ok, 0]) / life[ok])) if ok.any() else None
    return out


def k1_inputs():
    """The fields of one -5 batch of the 180 s track's first 64 frames."""
    import numpy as np
    import torch

    from chip_smoke import RATE, TRACK_SECONDS
    from flac_tpu_torch import EncoderConfig, signals
    from flac_tpu_torch.encoder import encode_batch
    from flac_tpu_torch.models import frame as frame_mod
    captured = {}
    real_pack = frame_mod.pack_cuda.pack_fields64

    def capture(nz, pay, pb, W):
        captured["args"] = (nz.clone(), pay.clone(), pb.clone(), W)
        return real_pack(nz, pay, pb, W)
    frame_mod.pack_cuda.pack_fields64 = capture
    try:
        pcm = signals.make_test_signal(TRACK_SECONDS * RATE,
                                       seed=180)[:, :64 * 4096]
        blocks = torch.from_numpy(np.ascontiguousarray(
            pcm.reshape(2, 64, 4096).transpose(1, 0, 2))).cuda()
        cfg = EncoderConfig.from_preset(5, blocksize=4096).resolve()
        encode_batch(blocks, 0, cfg, 4096)
    finally:
        frame_mod.pack_cuda.pack_fields64 = real_pack
    return captured["args"]


def k2_inputs():
    """The first full decode batch of a 100 s -5 stream."""
    import torch

    from chip_smoke import RATE, decode_batch_inputs, encode
    from flac_tpu_torch import signals
    stream, _ = encode(signals.make_test_signal(100 * RATE, seed=180), 5)
    [(arrays, kw)] = decode_batch_inputs(stream, first_only=True)
    return [torch.from_numpy(a).cuda() for a in arrays], kw


def k3_inputs():
    """K3's arguments on the first full decode batch of a 100 s -5 stream,
    as the device engine hands them over: the codes of K2 as the [S, N]
    residual matrix (int32), the subframe tables, int16 PCM out."""
    import numpy as np
    import torch

    from chip_smoke import RATE, encode
    from flac_tpu_torch import decoder_device as dd
    from flac_tpu_torch import native, signals
    from flac_tpu_torch.decoder import scan_frames
    from flac_tpu_torch.ops import bitunpack
    from flac_tpu_torch.ref_decoder import parse_metadata
    stream, _ = encode(signals.make_test_signal(100 * RATE, seed=180), 5)
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    arr = np.frombuffer(stream, np.uint8)
    prep = dd._prep_batch(arr, frames, list(range(1024)), 4096, 2)
    assert (prep[0].status == native.FT_OK).all()
    arrays, kw = dd.batch_inputs(arr, *prep)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    res_tl, _ = bitunpack.rice_codes_plain(*t[:3], T=128, NROW=kw["NROW"],
                                           SEG=kw["SEG"], wide=False)
    S = t[3].shape[0]
    res = res_tl.t().reshape(S, -1)[:, :4096].contiguous()
    return res, t[3:], kw["max_order"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--other", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="also time DIR's pack_fields64.cu/rice_codes.cu/"
                         "restore.cu")
    args = ap.parse_args()
    others = dict(o.split("=", 1) for o in args.other)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from flac_tpu_torch.ops import pack_cuda, restore_cuda, rice_cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    every = not (args.k1 or args.k2 or args.k3)
    do_k1, do_k2, do_k3 = (every or args.k1), (every or args.k2), \
        (every or args.k3)
    with ThreadPoolExecutor(3) as pool:
        f1 = pool.submit(build, "pack_fields64", K1_VARIANTS, others) \
            if do_k1 else None
        f2 = pool.submit(build, "rice_codes", K2_VARIANTS, others) \
            if do_k2 else None
        f3 = pool.submit(build, "restore", K3_VARIANTS, others) \
            if do_k3 else None
        libs1 = f1.result() if f1 else {}
        libs2 = f2.result() if f2 else {}
        libs3 = f3.result() if f3 else {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p = ctypes.c_void_p
    if do_k1:
        nz, pay, pb, W = k1_inputs()
        B, S = nz.shape
        words = torch.empty((B, W), dtype=torch.int64, device="cuda")
        total = torch.empty((B,), dtype=torch.int32, device="cuda")
        for name, (lib, regs) in libs1.items():
            lib.flac_pack_fields64.argtypes = [p] * 5 + [ctypes.c_int] * 3 \
                + [p]

            def run(lib=lib):
                code = lib.flac_pack_fields64(
                    nz.data_ptr(), pay.data_ptr(), pb.data_ptr(),
                    words.data_ptr(), total.data_ptr(), B, S, W, stream())
                if code:
                    raise SystemExit(f"K1 {name!r}: CUDA error {code}")
            ms = device_ms(run, "pack_fields64_kernel")
            base = device_ms(lambda: run(libs1["base"][0]),
                             "pack_fields64_kernel")
            extra = (phases(lib, run, B * pack_cuda.CLUSTER)
                     if name.endswith("phases") else {})
            print(json.dumps({"kernel": "K1", "variant": name, "ms": ms,
                              "base_ms": base, **extra, "ptxas": regs}),
                  flush=True)
    if do_k2:
        (words2d, ls, segs), kw = k2_inputs()
        L = ls.shape[0]
        res = torch.empty((kw["T"], L), dtype=torch.int32, device="cuda")
        ovf = torch.empty((L,), dtype=torch.bool, device="cuda")
        for name, (lib, regs) in libs2.items():
            lib.flac_rice_codes.argtypes = [p, ctypes.c_longlong, p, p, p,
                                            p] + [ctypes.c_int] * 6 + [p]

            def run(lib=lib):
                code = lib.flac_rice_codes(
                    words2d.data_ptr(), words2d.shape[0], ls.data_ptr(),
                    segs.data_ptr(), res.data_ptr(), ovf.data_ptr(), L,
                    kw["T"], kw["NROW"], kw["SEG"], kw["SEG"], 0, stream())
                if code:
                    raise SystemExit(f"K2 {name!r}: CUDA error {code}")
            ms = device_ms(run, "rice_codes_kernel")
            base = device_ms(lambda: run(libs2["base"][0]),
                             "rice_codes_kernel")
            extra = (phases(lib, run, -(-L // rice_cuda.STAGE_LANES))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K2", "variant": name, "ms": ms,
                              "base_ms": base, "L": L, **kw, **extra,
                              "ptxas": regs}), flush=True)
    if do_k3:
        res, (order, shift, qlp, wasted, asg), mo = k3_inputs()
        S, N = res.shape
        pcm = torch.empty((S, N), dtype=torch.int16, device="cuda")
        oor = torch.zeros((S // 2,), dtype=torch.bool, device="cuda")
        i = ctypes.c_int
        for name, (lib, regs) in libs3.items():
            lib.flac_restore.argtypes = [p, i, ctypes.c_longlong, i, p, p, p,
                                         i, p, p, p, i, i, p, i, i, i, i, i,
                                         p]

            def run(lib=lib):
                code = lib.flac_restore(
                    res.data_ptr(), 4, N, 1, order.data_ptr(),
                    shift.data_ptr(), qlp.data_ptr(), mo, wasted.data_ptr(),
                    asg.data_ptr(), pcm.data_ptr(), 1, 1, oor.data_ptr(), S,
                    N, 2, 0, 16, stream())
                if code:
                    raise SystemExit(f"K3 {name!r}: CUDA error {code}")
            ms = device_ms(run, "restore_kernel", runs=20)
            base = device_ms(lambda: run(libs3["base"][0]),
                             "restore_kernel", runs=20)
            extra = (phases(lib, run, -(-S // restore_cuda.THREADS))
                     if name == "phases" else {})
            print(json.dumps({"kernel": "K3", "variant": name, "ms": ms,
                              "base_ms": base, "S": S, "N": N,
                              "max_order": mo, **extra, "ptxas": regs}),
                  flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
