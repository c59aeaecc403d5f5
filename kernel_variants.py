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
4096 samples, int16 out) as each engine gives them: int32 (the device
engine) and int16 (the fast engine).  Before K3's variants, a one-thread
probe times the recursion's chain (cycles a sample, generic and folded,
and the SM clock); each K3 line carries the chain floor it gives,
N x cycles / clock.  A variant that cuts work out
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


K3_WAITS = ("        bar_wait(full_in + 8 * ist, (c / IN_STAGES) & 1);\n"
            "        bar_wait(empty_out + 8 * ost, ((c / OUT_STAGES) & 1) ^ 1);\n")
K3_ARRIVES = ("        bar_arrive(empty_in + 8 * (c % IN_STAGES));\n"
              "        bar_arrive(full_out + 8 * (c % OUT_STAGES));\n")
K3_ADVANCE = "        ++c;\n        u0 = 0;\n        if (c < nch) acquire();\n"
K3_ROLES = "    if (warp == 0) {\n        recurse<MO, WIDE>"
# the recursion warp alone, its residuals made up in registers: no
# producer, no epilogue, no barrier
K3_ALONE = [
    (K3_WAITS, ""), (K3_ARRIVES, ""),
    ("    auto load = [&]() { load_round<R, XT>(r, src, rb, u0); };",
     "    auto load = [&]() {\n#pragma unroll\n"
     "        for (int u = 0; u < R; ++u)\n"
     "            r[u] = (XT)(c * K + u0 + u + lane);\n    };"),
    (K3_ROLES, "    if (warp != 0) return;\n" + K3_ROLES)]
# the folded form's chain only (a wrong result): none of the MO - 1 older
# taps' FP64 multiply-adds
K3_NO_TAPS = [("            for (int j = 1; j < MO; ++j) {",
               "            for (int j = 1; j < 1; ++j) {")]
K3_VARIANTS = [
    ("base", []),
    ("chain only", K3_ALONE),
    ("no off-chain taps", K3_NO_TAPS),
    # both: the probe's work (a funnel shift, a multiply-add and the fold
    # a sample) in the kernel's loop
    ("bare chain", K3_ALONE + K3_NO_TAPS),
    # the folded chain's step by mad.wide.s32 (ptxas: a product and two
    # adds) instead of the carry chain
    ("mad.wide chain", [("        V = mad_cc(q0, x, C);",
                         "        V = mad_wide(q0, x, C);")]),
    # every round in the generic form (int64 multiply-adds for every tap,
    # as before the folded form moved the older taps to the FP64 pipe)
    ("generic form", [("        if (folded && !warm) break;",
                       "        if (folded && !warm && c < 0) break;")]),
    # the residuals not folded into the sums (a wrong result): the cost of
    # r << sh and its add on the recursion warp
    ("no fold", [("        const long long rs = u + 2 < R ? "
                  "fold(r[u + 2 < R ? u + 2 : 0], sh)\n"
                  "                                       : 0;",
                  "        const long long rs = 0;")]),
    # the epilogue warps wait and release the x ring and do nothing else
    ("no epilogue", [("            if (pass >= passes) break;\n"
                      "            const int slot = first + 8 * pass;",
                      "            if (pass >= passes || c >= 0) break;\n"
                      "            const int slot = first + 8 * pass;")]),
    ("ring depth 2", [("constexpr int IN_STAGES = 3;",
                       "constexpr int IN_STAGES = 2;")]),
    # clock64 per role: 1 the recursion's first chunk in, 2 its end, 3 the
    # producer's end, 4 the epilogue's end (the later warp); 5 and 6 the
    # recursion's cycles waiting for residuals and for a free x stage
    ("phases", [
        ("namespace {\n", "namespace {\n" + PHASE_DEFS),
        ("    __syncthreads();\n" + K3_ROLES,
         "    __syncthreads();\n    PHSTART();\n" + K3_ROLES),
        ("    int c = 0, u0 = 0;\n",
         "    int c = 0, u0 = 0;\n    long long w_in = 0, w_out = 0;\n"),
        (K3_WAITS,
         "        long long t = clock64();\n"
         "        bar_wait(full_in + 8 * ist, (c / IN_STAGES) & 1);\n"
         "        w_in += clock64() - t;\n"
         "        if (c == 0) PH(1);\n"
         "        t = clock64();\n"
         "        bar_wait(empty_out + 8 * ost, ((c / OUT_STAGES) & 1) ^ 1);\n"
         "        w_out += clock64() - t;\n"),
        (K3_ADVANCE,
         K3_ADVANCE + "        if (c == nch) {\n"
         "            PH(2);\n"
         "            if (threadIdx.x == 0) {\n"
         "                long long* ph = g_ph + blockIdx.x * 10;\n"
         "                ph[5] = ph[0] + w_in;\n"
         "                ph[6] = ph[0] + w_out;\n"
         "            }\n"
         "        }\n"),
        ("        bar_arrive(full + 8 * st);\n    }\n}\n",
         "        bar_arrive(full + 8 * st);\n    }\n"
         "    if (lane == 0) g_ph[blockIdx.x * 10 + 3] = clock64();\n}\n"),
        ("    // one store of 1 a flagged slot",
         "    PHMAX(4);\n    // one store of 1 a flagged slot"),
        ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + PHASE_TAIL)]),
]

# One thread's chain of dependent samples, as the recursion runs it: the
# generic form (x = (int)(P >> sh) + r; P = q * x + c by mad.wide) and the
# folded one (x = the low word of P >> sh by one funnel shift; P = q * x + c
# by the kernel's carry chain of two 32-bit multiply-adds, the residual in
# c off the chain).  Prints cycles a sample and the SM clock.
CHAIN_PROBE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
    long long d;
    asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
    return d;
}
__device__ __forceinline__ long long mad_cc(int a, int b, long long c) {
    unsigned lo, hi;
    asm("mad.lo.cc.u32 %0, %2, %3, %4;\n\t"
        "madc.hi.s32 %1, %2, %3, %5;"
        : "=r"(lo), "=r"(hi)
        : "r"(a), "r"(b), "r"((unsigned)c),
          "r"((unsigned)((unsigned long long)c >> 32)));
    return (long long)(((unsigned long long)hi << 32) | lo);
}
__device__ __forceinline__ long long gtimer() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
__global__ void chain_probe(long long* out, int n, int q, int sh,
                            long long c) {
    long long P = c;
    const long long g0 = gtimer(), t0 = clock64();
    for (int i = 0; i < n; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int x = (int)(P >> sh) + (i + u);
            P = mad_wide(q, x, c);
        }
    }
    const long long t1 = clock64();
    long long F = c;
    for (int i = 0; i < n; i += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int x = (int)__funnelshift_r(
                (unsigned)F, (unsigned)((unsigned long long)F >> 32), sh);
            F = mad_cc(q, x, c + ((long long)(i + u) << sh));
        }
    }
    const long long t2 = clock64(), g1 = gtimer();
    if (threadIdx.x == 0) {
        out[0] = t1 - t0; out[1] = t2 - t1; out[2] = g1 - g0;
    }
    out[3 + threadIdx.x] = P + F;
}
// `lanes` threads (1 or 32) of one warp run the chains side by side
extern "C" int flac_chain_probe(long long* out, int n, int q, int sh,
                                int lanes, void* stream) {
    chain_probe<<<1, lanes, 0, (cudaStream_t)stream>>>(out, n, q, sh, 12345);
    return (int)cudaGetLastError();
}
"""


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
    outs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    for name, (lib, proc) in jobs.items():
        out = outs[name]
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
    as each engine hands them over: {"int32": the device engine's (the
    codes of K2 as the [S, N] residual matrix), "int16": the fast engine's
    (the native full parse's residuals)}, each (res, [order, shift, qlp,
    wasted, assignment], max_order); int16 PCM out."""
    import numpy as np
    import torch

    from chip_smoke import RATE, encode, restore_batch_inputs
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
    [(farrays, fkw)] = restore_batch_inputs(stream, first_only=True)
    ft = [torch.from_numpy(farrays[k]).cuda() for k in
          ("order", "shift", "qlp", "wasted", "assignment")]
    assert farrays["res"].dtype == np.int16
    return {"int32": (res, t[3:], kw["max_order"]),
            "int16": (torch.from_numpy(farrays["res"]).cuda(), ft,
                      fkw["max_order"])}


def build_chain_probe() -> ctypes.CDLL:
    """nvcc the chain probe (CHAIN_PROBE) into a library of its own."""
    from flac_tpu_torch import kernels
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "chain_probe.cu"
    src.write_text(CHAIN_PROBE)
    lib_path = src.with_suffix(".so")
    out = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)], capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the chain probe:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.flac_chain_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


def chain_probe(lib=None, n: int = 1 << 16) -> dict:
    """One thread's chain, `n` dependent samples of each form: cycles a
    sample (generic: shift, add, multiply-add; folded: funnel shift,
    multiply-add) and the SM clock in cycles a ns over the run; and the
    same with a whole warp's 32 lanes each running a chain (`warp_*`), as
    the recursion warp does."""
    import torch
    lib = lib or build_chain_probe()
    buf = torch.zeros(3 + 32, dtype=torch.int64, device="cuda")
    out = {"samples": n}
    for lanes, key in ((32, "warp_"), (1, "")):
        for _ in range(2):                           # the second is timed
            if lib.flac_chain_probe(buf.data_ptr(), n, 3, 12, lanes,
                                    torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("the chain probe did not launch")
            torch.cuda.synchronize()
        generic, folded, ns = buf[:3].tolist()
        out[key + "generic_cycles_per_sample"] = generic / n
        out[key + "folded_cycles_per_sample"] = folded / n
        out[key + "cycles_per_ns"] = (generic + folded) / ns
    return out


def write_sass(libs: dict, out: Path,
               kernel: str = "restore_kernelILi8ELb0E") -> None:
    """cuobjdump's SASS of the function `kernel` names (by default the
    narrow order-8 K3, which the main path launches) in each built
    library, one file a variant (~0.8 MB each; a whole library's is ~18
    MB)."""
    from flac_tpu_torch import kernels
    tool = Path(kernels.nvcc_path()).with_name("cuobjdump")
    out.mkdir(parents=True, exist_ok=True)
    for name, (lib, _) in libs.items():
        sass = subprocess.run([str(tool), "-sass", lib._name],
                              capture_output=True, text=True).stdout
        keep = [f for f in sass.split("Function : ")
                if kernel in f.partition("\n")[0]]
        slug = "".join(ch if ch.isalnum() else "_" for ch in name)
        (out / f"restore_sass_{slug}.txt").write_text("".join(keep))


def time_k3(libs: dict, inputs: dict, probe: dict) -> None:
    """Time each built K3 library (`build`'s {name: (library, ptxas
    lines)}) on each of `k3_inputs`, in turns with "base", and print a
    JSON line each with the chain floor from `probe`."""
    import torch

    from flac_tpu_torch.ops import restore_cuda
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in libs.items():
        lib.flac_restore.argtypes = [p, i, ctypes.c_longlong, i, p, p, p, i,
                                     p, p, p, i, i, p, i, i, i, i, i, p]
        for label, (res, (order, shift, qlp, wasted, asg), mo) in \
                inputs.items():
            S, N = res.shape
            pcm = torch.empty((S, N), dtype=torch.int16, device="cuda")
            oor = torch.zeros((S // 2,), dtype=torch.bool, device="cuda")

            def run(lib=lib, res=res, order=order, shift=shift, qlp=qlp,
                    wasted=wasted, asg=asg, mo=mo, pcm=pcm, oor=oor):
                code = lib.flac_restore(
                    res.data_ptr(), res.element_size(), N, 1,
                    order.data_ptr(), shift.data_ptr(), qlp.data_ptr(), mo,
                    wasted.data_ptr(), asg.data_ptr(), pcm.data_ptr(), 1, 1,
                    oor.data_ptr(), S, N, 2, 0, 16, stream)
                if code:
                    raise SystemExit(f"K3 {name!r}: CUDA error {code}")
            ms = device_ms(run, "restore_kernel", runs=20)
            base = device_ms(lambda: run(libs["base"][0]), "restore_kernel",
                             runs=20)
            extra = (phases(lib, run, -(-S // restore_cuda.SUBS))
                     if name == "phases" else {})
            # each CTA's chain of N samples at the probe's cycles a sample
            # and clock
            floor = N * probe["folded_cycles_per_sample"] \
                / probe["cycles_per_ns"] / 1e6
            print(json.dumps({"kernel": "K3", "variant": name,
                              "input": label, "ms": ms, "base_ms": base,
                              "chain_floor_ms": floor, "S": S, "N": N,
                              "max_order": mo, **extra, "ptxas": regs}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k1", action="store_true")
    ap.add_argument("--k2", action="store_true")
    ap.add_argument("--k3", action="store_true")
    ap.add_argument("--sass", metavar="DIR",
                    help="write cuobjdump's SASS of the K3 variants' "
                         "narrow order-8 kernel (the main path's) to "
                         "DIR/restore_sass_<variant>.txt")
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
    from flac_tpu_torch.ops import pack_cuda, rice_cuda
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
        probe = chain_probe()
        print(json.dumps({"kernel": "K3", "probe": "chain", **probe}),
              flush=True)
        if args.sass:
            write_sass(libs3, Path(args.sass))
        time_k3(libs3, k3_inputs(), probe)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
