#!/usr/bin/env python3
"""Smoke test of flac_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA GPU
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order, each printing one JSON line; any failure exits non-zero:

1. device:  the GPU's name, and nvidia-smi's name and power limit line.
2. build:   nvcc builds the kernel from flac_tpu_torch/csrc/pack_fields64.cu
            (the slice's one source); the P1 probe runs.
3. kernels: each kernel against its plain PyTorch version on the GPU,
            bit-identical, over random, edge and real-shape cases.
4. main:    the main path at full size — a 180 s 44.1 kHz 16-bit stereo
            track encoded at -5 (blocksize 4096, 64 frames a batch) on the
            GPU, with the kernels' launch counts read just after; the stream
            is decoded by the package's reference decoder and must give the
            samples back with a matching MD5.
5. ab:      a 20 s clip at -5 through the plain packer must give the same
            bytes as through the kernel; -0 and -8 clips and a transient clip
            (which sends frames through the safe re-encode) must round-trip.
6. times:   each kernel's time at the main path's shapes (CUDA events,
            median), its plain version's time and its bound, printed as one
            `kernels` line.
7. profile: torch.profiler over a 10 s encode at -5: the device's busy
            share, device time by stage (the flac.* ranges of encode_batch)
            and the top kernels; the full table goes to
            chiprun_out/profile_encode_-5.txt.

The last line is {"ok": true, "device": {...}}.  Longer logs (the compiler's
register report, the profile table) go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, the only non-tensor rate the data
# sheet gives; K1's integer operations are counted against it
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
RATE = 44100
TRACK_SECONDS = 180          # one album track: 31.75 MB of 16-bit stereo


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, warmup: int = 5, runs: int = 25) -> float:
    """Median milliseconds of one call of `fn` on the GPU (CUDA events
    around each call, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3 cases: K1 against its plain version
# ---------------------------------------------------------------------------

def pack_case(rng, B, S, max_pb=60):
    """The random field lists of tests/test_pack_pallas.py."""
    import numpy as np
    pbits = rng.integers(0, max_pb + 1, (B, S))
    pbits[rng.random((B, S)) < 0.08] = 0
    nzeros = rng.integers(0, 4, (B, S))
    pay = rng.integers(0, 1 << 62, (B, S), dtype=np.int64).astype(np.uint64)
    pay &= (np.uint64(1) << pbits.astype(np.uint64)) - np.uint64(1)
    return nzeros.astype(np.int32), pay.view(np.int64), pbits.astype(np.int32)


def pack_cases():
    import numpy as np
    cases = []
    for B, S, W in ((8, 640, 2048), (3, 130, 1024), (16, 352, 4096)):
        rng = np.random.default_rng(B * 1000 + S)
        cases.append((f"random B{B} S{S} W{W}", *pack_case(rng, B, S), W))
    rng = np.random.default_rng(7)
    pb = rng.integers(1, 5, (8, 1024)).astype(np.int32)
    pay = rng.integers(0, 16, (8, 1024)).astype(np.int64) & ((1 << pb) - 1)
    cases.append(("dense small fields", np.zeros((8, 1024), np.int32), pay,
                  pb, 1024))
    rng = np.random.default_rng(63)
    pb = np.full((4, 500), 63, np.int32)
    pay = rng.integers(0, 1 << 63, (4, 500), dtype=np.int64)
    cases.append(("63-bit fields", rng.integers(0, 3, (4, 500)).astype(
        np.int32), pay, pb, 2048))
    # a 63-bit field starting at bit 1..31 of a word spans three words
    nz = rng.integers(1, 32, (4, 300)).astype(np.int32)
    pb = rng.integers(58, 64, (4, 300)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (4, 300), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    cases.append(("three-word straddles", nz, pay, pb, 1024))
    # ~4000 bits into 64 words: everything past word 63 is dropped
    pb = np.full((2, 100), 40, np.int32)
    pay = rng.integers(0, 1 << 40, (2, 100), dtype=np.int64)
    cases.append(("fields past W", np.zeros((2, 100), np.int32), pay, pb,
                  64))
    # the -5 main-path shape: 64 frames of 2263 fields into 8192 words
    rng = np.random.default_rng(5)
    pb = rng.integers(0, 64, (64, 2263)).astype(np.int32)
    nz = rng.integers(0, 8, (64, 2263)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (64, 2263), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    cases.append(("-5 shape B64 S2263 W8192", nz, pay, pb, 8192))
    return cases


# ---------------------------------------------------------------------------
# phases 4-5 helpers
# ---------------------------------------------------------------------------

def quad_batches(cfg, n_samples: int, batch_frames: int) -> int:
    """Batches of a StreamEncoder run that take the quad layout (and so
    launch K1 once each), from the frame plan alone."""
    from flac_tpu_torch import format as fmt
    N = cfg.blocksize
    full = (n_samples - 1) // N                    # emitted before finish
    sizes = [N] * (-(-full // batch_frames))
    rest = n_samples - full * N
    sizes += [N] * (rest // N)
    if rest % N:
        sizes.append(rest % N)

    def quad(n):
        po = fmt.max_rice_partition_order_limited(
            cfg.max_residual_partition_order, n, 0)
        return (cfg.bits_per_sample <= 26 and n % 4 == 0
                and max(n >> po, 1) % 4 == 0)
    return sum(quad(n) for n in sizes)


def round_trip(stream: bytes, pcm) -> float:
    """Decode with the package's reference decoder (it checks every CRC and
    the STREAMINFO MD5); the samples must equal pcm.  Returns seconds."""
    import numpy as np
    from flac_tpu_torch import ref_decoder
    t0 = time.perf_counter()
    st = ref_decoder.decode_stream(stream, verify_md5=True)
    if st.md5 == b"\x00" * 16:
        raise AssertionError("stream carries no MD5")
    if not np.array_equal(st.samples, pcm):
        raise AssertionError("decoded samples differ from the input")
    return time.perf_counter() - t0


def encode(pcm, level: int, **kw):
    from flac_tpu_torch import EncoderConfig
    from flac_tpu_torch.encoder import StreamEncoder
    buf = io.BytesIO()
    enc = StreamEncoder(buf, EncoderConfig.from_preset(level, blocksize=4096),
                        device="cuda", batch_frames=64, **kw)
    enc.process(pcm)
    enc.finish()
    return buf.getvalue(), enc


def _device_us(event, self_only: bool) -> float:
    """A profiler event's device time in microseconds, across the
    attribute names of torch versions."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_encode(pcm) -> dict:
    """torch.profiler over one -5 encode of `pcm` (after a warm encode of
    the same clip): wall time, device busy share, device time by stage and
    the top kernels.  The full table goes to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    encode(pcm, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode(pcm, 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side entries (kernels, copies); CPU ops carry their kernels'
    # time too, and the flac.* ranges' device spans include idle gaps, so
    # only kernels and copies are summed
    kernels_ = [e for e in events if str(e.device_type).endswith("CUDA")
                and not e.key.startswith("flac.")]
    busy_us = sum(_device_us(e, True) for e in kernels_)
    # per stage: host time in the range, and the device time of the
    # kernels launched inside it (flac.pack nests in flac.assemble)
    stages = {}
    for e in prof.events():
        if e.name.startswith("flac.") and str(e.device_type).endswith("CPU"):
            d = stages.setdefault(e.name, {"calls": 0, "host_ms": 0.0,
                                           "device_ms": 0.0})
            d["calls"] += 1
            d["host_ms"] += e.cpu_time_total / 1e3
            d["device_ms"] += _device_us(e, False) / 1e3
    top = sorted(kernels_, key=lambda e: -_device_us(e, True))[:8]
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(os.path.join(OUT_DIR, "profile_encode_-5.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=40))
    return {"phase": "profile", "preset": -5,
            "seconds_audio": pcm.shape[1] / RATE, "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else
            "not measured",
            "device_kernel_launches": sum(e.count for e in kernels_),
            "stages": stages,
            "top_kernels_ms": {e.key[:60]: _device_us(e, True) / 1e3
                               for e in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    try:
        from flac_tpu_torch import EncoderConfig, kernels, signals
        from flac_tpu_torch.models import frame as frame_mod
        from flac_tpu_torch.ops import bitpack, pack_cuda
    except ImportError as e:
        return fail(f"the flac_tpu_torch package is not here ({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    # ---- 2. build the kernel's source, run the probe ----
    t0 = time.perf_counter()
    _, report = kernels.load("pack_fields64")
    build_s = time.perf_counter() - t0
    pack_cuda.probe()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(f"== pack_fields64 ({build_s:.1f} s)\n{report}\n")
    ptx = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": round(build_s, 2), "probe": "ok",
          "ptxas": ptx})

    # ---- 3. K1 against its plain version, bit-identical ----
    max_err = 0
    for label, nz, pay, pb, W in pack_cases():
        args_gpu = [torch.from_numpy(a).cuda() for a in (nz, pay, pb)]
        kw, kt = pack_cuda.pack_fields64(*args_gpu, W)
        pw, pt = bitpack.pack_fields64(*args_gpu, W)
        torch.cuda.synchronize()
        err = int((kw - pw).abs().max()) if kw.numel() else 0
        ok = torch.equal(kw, pw) and torch.equal(kt, pt)
        emit({"phase": "kernels", "kernel": "pack_fields64", "case": label,
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K1 differs from its plain version on '{label}'")
        max_err = max(max_err, err)
    if args.quick:
        emit({"ok": True, "quick": True, "device": {"platform": "gpu",
              "kind": name, "count": torch.cuda.device_count()}})
        return 0

    # ---- 4. the main path at full size ----
    n = TRACK_SECONDS * RATE
    pcm = signals.make_test_signal(n, seed=180)
    cfg5 = EncoderConfig.from_preset(5, blocksize=4096).resolve()
    expect = quad_batches(cfg5, n, 64)
    t0 = time.perf_counter()
    encode(signals.make_test_signal(5 * RATE, seed=5), 5)   # warm-up
    torch.cuda.synchronize()
    emit({"phase": "main", "warm_up_s": time.perf_counter() - t0})
    pack_cuda.launches = 0
    t0 = time.perf_counter()
    stream, enc = encode(pcm, 5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = pack_cuda.launches
    pcm_bytes = pcm.size * 2
    emit({"phase": "main", "preset": -5, "seconds_audio": TRACK_SECONDS,
          "pcm_mb": pcm_bytes / 1e6, "encode_wall_s": wall,
          "encode_mb_per_s": pcm_bytes / 1e6 / wall,
          "compression_ratio": len(stream) / pcm_bytes,
          "launches": {"pack_fields64": k1_launches},
          "quad_batches": expect, "misfit_frames": enc.misfit_frames})
    if k1_launches <= 0 or k1_launches != expect:
        return fail(f"K1 launched {k1_launches} times on the main path, "
                    f"expected one per quad-layout batch ({expect})")
    dec_s = round_trip(stream, pcm)
    emit({"phase": "main", "round_trip": "ok", "md5": "match",
          "decode_s": dec_s})

    # ---- 5. A/B through the path ----
    clip = signals.make_test_signal(20 * RATE, seed=20)
    s_kernel, _ = encode(clip, 5)
    s_plain, _ = encode(clip, 5, packer="plain")
    if s_kernel != s_plain:
        return fail("-5 stream through the plain packer differs from the "
                    "kernel's")
    emit({"phase": "ab", "case": "-5 kernel vs plain", "identical": True,
          "bytes": len(s_kernel)})
    round_trip(s_kernel, clip)
    for level in (0, 8):
        s, _ = encode(clip, level)
        round_trip(s, clip)
        emit({"phase": "ab", "case": f"-{level} round trip", "ok": True,
              "bytes": len(s)})
    burst = signals.make_transient_signal(20 * RATE, seed=21)
    s, benc = encode(burst, 5)
    round_trip(s, burst)
    emit({"phase": "ab", "case": "transient clip round trip", "ok": True,
          "misfit_frames_safe_reencoded": benc.misfit_frames})
    if benc.misfit_frames <= 0:
        return fail("the transient clip sent no frame to the safe re-encode")

    # ---- 6. times at the main path's shape ----
    captured = {}
    real_pack = frame_mod.pack_cuda.pack_fields64

    def capture(nz, pay, pb, W):
        captured["args"] = (nz.clone(), pay.clone(), pb.clone(), W)
        return real_pack(nz, pay, pb, W)
    frame_mod.pack_cuda.pack_fields64 = capture
    try:
        from flac_tpu_torch.encoder import encode_batch
        blocks = torch.from_numpy(np.ascontiguousarray(
            pcm[:, :64 * 4096].reshape(2, 64, 4096).transpose(1, 0, 2))).cuda()
        encode_batch(blocks, 0, cfg5, 4096)
    finally:
        frame_mod.pack_cuda.pack_fields64 = real_pack
    nz, pay, pb, W = captured["args"]
    B, S = nz.shape
    kw, kt = pack_cuda.pack_fields64(nz, pay, pb, W)
    pw, pt = bitpack.pack_fields64(nz, pay, pb, W)
    if not (torch.equal(kw, pw) and torch.equal(kt, pt)):
        return fail("K1 differs from its plain version on real -5 fields")
    max_err = max(max_err, int((kw - pw).abs().max()))
    # plain, kernel, kernel, plain: the pairs bracket drift in the card
    plain_ms = cuda_time_ms(lambda: bitpack.pack_fields64(nz, pay, pb, W))
    kernel_ms = cuda_time_ms(lambda: pack_cuda.pack_fields64(
        nz, pay, pb, W))
    kernel_ms2 = cuda_time_ms(lambda: pack_cuda.pack_fields64(
        nz, pay, pb, W))
    plain_ms2 = cuda_time_ms(lambda: bitpack.pack_fields64(nz, pay, pb, W))
    # each input read once (nzeros, payload, pbits), each output written
    # once: the deposit's words are uint32 (that the kernel stores them
    # zero-extended in int64 is the port's layout, not the function's
    # work), and total_bits; per field: one scan add, three clamped
    # shifts, ORs and index tests, about 16 integer operations
    nbytes = B * S * (4 + 8 + 4) + B * W * 4 + B * 4
    nops = B * S * 16
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / NON_TENSOR_OPS_PER_S * 1e3
    emit({"phase": "times", "kernel": "pack_fields64", "B": B, "S": S,
          "W": W, "kernel_ms_runs": [kernel_ms, kernel_ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], "bytes": nbytes,
          "operations": nops})
    k_ms = min(kernel_ms, kernel_ms2)
    plain_ms = min(plain_ms, plain_ms2)
    emit({"kernels": [{
        "name": "pack_fields64", "route": "cuda",
        "source": pack_cuda.SOURCE, "replaces": pack_cuda.REPLACES,
        "launches": k1_launches, "max_abs_err": max_err,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this deposit",
    }]})
    # ---- 7. where the time goes in a steady encode ----
    emit(profile_encode(signals.make_test_signal(10 * RATE, seed=7)))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
