#!/usr/bin/env python3
"""Smoke test of flac_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA GPU
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order, each printing one JSON line; any failure exits non-zero:

1. device:  the GPU's name, and nvidia-smi's name and power limit line.
2. build:   nvcc builds the three kernel sources of flac_tpu_torch/csrc/
            (pack_fields64.cu, rice_codes.cu, restore.cu; one nvcc each,
            started together) while g++ builds the native host runtime; the
            probes P1 and P2 run; each kernel's registers, spills and
            static shared memory from ptxas (K3 must not spill), and K3's
            dynamic shared memory (its rings) for each residual width,
            which must equal the host mirror's; the chain probe of
            kernel_variants.py builds beside them.
3. kernels: each kernel against its plain PyTorch version on the GPU:
            K1 bit-identical on random, edge, cluster (ops/pack_synth.py)
            and real-shape field lists; K2 (narrow and wide) on the tile
            tables of real -5 and -8 streams, on synthetic bitstreams and
            on the staging lanes (ops/rice_synth.py): `ovf` identical on
            every lane, the codes on every lane without it; K3 bit-identical
            (PCM and flags) on the corners of ops/restore_synth.py (every
            order bucket, int32 wrap, wide int64, int16 narrowing, 1, 2 and
            6 channels with every stereo assignment, the ring's chunk
            edges, unaligned rows, a 65535-sample frame, a partial CTA,
            taps past 16 bits and out-of-range shifts) and on the first
            native.parse_frames batch of the -5 and -8 clips.
4. main:    the main path at full size: a 180 s 44.1 kHz 16-bit stereo
            track encoded at -5 (blocksize 4096, 64 frames a batch) on the
            GPU, then decoded on the GPU 1024 frames a batch by
            decode_stream_tpu with engine "device" (K2 and K3) and with
            engine "fast" (the native full parse and K3), each with the
            kernels' launch counts (and K2's count of CTAs that staged)
            read just after; each decode must give the samples back with a
            matching MD5, equal the port's host engine and launch K3 once a
            decode batch; every CTA of every K2 launch must have staged, as
            the host mirror of the rule predicts.  The MB/s of the three
            engines, the link probe and the engine "auto" picks.
5. ab:      a 20 s clip at -5 through the plain packer must give the same
            bytes as through the kernel; -5, -0 and -8 clips and a transient
            clip (which sends frames through the safe re-encode) must
            round-trip through the reference decoder and through the device
            decode on the GPU; a tolerant decode on the GPU of the -5 clip
            with a corrupted and a cut frame must equal the host engine's
            (samples and errors); the "scan" engine on the GPU must equal
            the host engine on a short -0 clip (blocksize 1152).
6. times:   each kernel at the main path's shapes: `ms`, its device time
            per launch (torch.profiler; CUDA events around calls queued
            behind a sleep kernel, `ms_queued_events`, beside it, and in
            its place where three traces miss launches, as `ms_by` says),
            `kernel_ms` and `plain_ms`, the
            kernel's and its plain version's time per call (CUDA events
            around back-to-back calls), and its bound, printed as one
            `kernels` line with each kernel's ptxas usage, K1's cluster
            size and K2's staged CTAs per main-path launch.  K3 is timed
            on both engines' inputs (int32 and int16 residuals) with its
            chain floor (N x the chain probe's cycles a sample / the SM
            clock) beside the bound; the device engine's transpose copy
            of K2's codes is timed on its own line before it.
7. profile: torch.profiler over a 10 s encode and 10 s decodes with the
            "device" and "fast" engines: the device's busy share, time by
            stage (the flac.* ranges) and the top kernels; the tables go to
            OUT_DIR/profile_*.txt.

The last line is {"ok": true, "device": {...}}.  Longer logs (the compiler's
register report, the profile tables) go to OUT_DIR, beside this script.
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
# sheet gives; the kernels' integer operations are counted against it
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
RATE = 44100
TRACK_SECONDS = 180          # one album track: 31.75 MB of 16-bit stereo
DECODE_BATCH = 1024          # frames a decode batch (the reference's)
K2_OPS_PER_CODE = 30         # segment pop, 3 window reads, clz, shifts, zigzag
# K3 a sample: a multiply and an add a tap of the subframe's order, then the
# shift, the residual add, the wasted-bit shift, the stereo undo (~3) and
# the two range compares
K3_OPS_PER_TAP = 2
K3_OPS_PER_SAMPLE = 8


def ptxas_usage(report: str, kernel: str) -> dict:
    """Registers, spill bytes and static shared memory of each function of
    nvcc's -Xptxas -v `report` whose name contains `kernel`."""
    import re
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_static_bytes"] = int(m.group(1)) if m else 0
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, warmup: int = 5, runs: int = 25) -> float:
    """Milliseconds of one call of `fn` on the GPU: CUDA events around
    `runs` back-to-back calls after warm-up, over the count.  Where the
    host launches more slowly than the card runs, this is the host's
    rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def queued_device_ms(fn, runs: int = 25) -> float:
    """Device milliseconds of one call of `fn`: the median over `runs` calls
    of CUDA events recorded just before and after each call, all queued
    while a sleep kernel holds the stream, so that the card runs them back
    to back and no host launch gap falls between a pair.  Counts whatever
    else the call launches (a wrapper's fills) with the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    held = torch.cuda.Event()
    cycles = 1 << 26                     # ~35 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        held.record()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        # the sleep still running means every call was queued behind it
        queued = not held.query()
        torch.cuda.synchronize()
        if queued:
            return statistics.median(a.elapsed_time(b) for a, b in pairs)
        cycles *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "longest sleep")


def kernel_device_ms(fn, kernel: str, runs: int = 25,
                     attempts: int = 3) -> dict:
    """Device milliseconds of one launch of the CUDA kernel whose name
    contains `kernel`: {"ms", "ms_by" (how "ms" was taken),
    "ms_queued_events" (`queued_device_ms`, always taken beside it)}.
    "ms" comes from torch.profiler's trace of `runs` calls of `fn` after a
    warm call: the kernel alone, without the host's launch gaps.  CUPTI now
    and then delivers no kernel record of a traced window; a trace that
    does not hold exactly `runs` launches is taken again, and after
    `attempts` such traces "ms" is the queued events' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    queued = queued_device_ms(fn, runs)
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count == runs:
            return {"ms": sum(_device_us(e, True) for e in events) / count
                    / 1e3, "ms_by": "torch.profiler",
                    "ms_queued_events": queued}
        emit({"phase": "times", "kernel": kernel, "trace": attempt,
              "profiler_launches_seen": count, "expected": runs})
    return {"ms": queued, "ms_by": "cuda events, calls queued",
            "ms_queued_events": queued}


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
    from flac_tpu_torch.ops import pack_synth
    return cases + [(f"cluster: {c[0]}", *c[1:])
                    for c in pack_synth.cluster_cases()]


# ---------------------------------------------------------------------------
# phase 3 cases: K2 against its plain version
# ---------------------------------------------------------------------------

def stream_batches(stream: bytes):
    """The decode batches of `stream` as the engines form them (each
    (blocksize, channels) group in stream order, DECODE_BATCH frames a
    batch): yields (stream bytes as uint8, frames, frame indices,
    blocksize, channels, bits per sample)."""
    import numpy as np
    from flac_tpu_torch.decoder import scan_frames
    from flac_tpu_torch.ref_decoder import parse_metadata
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
    arr = np.frombuffer(stream, np.uint8)
    for (blocksize, channels), idxs in groups.items():
        for lo in range(0, len(idxs), DECODE_BATCH):
            yield (arr, frames, idxs[lo:lo + DECODE_BATCH], blocksize,
                   channels, st.bits_per_sample)


def decode_batch_inputs(stream: bytes, first_only: bool = False) -> list:
    """The host arrays of each decode batch of `stream` as the device
    engine builds them: [((words2d, lane_start, segs), K2's static
    arguments)], or only the first batch's."""
    from flac_tpu_torch import decoder_device as dd
    out = []
    for arr, frames, idxs, blocksize, channels, _ in stream_batches(stream):
        prep = dd._prep_batch(arr, frames, idxs, blocksize, channels)
        arrays, kw = dd.batch_inputs(arr, *prep)
        out.append((arrays[:3], dict(T=dd._tile_T(blocksize),
                                     NROW=kw["NROW"], SEG=kw["SEG"],
                                     wide=kw["wide"])))
        if first_only:
            break
    return out


def k2_compare(args, kw) -> tuple[bool, int, int]:
    """K2 and its plain version on the same GPU tensors.  Returns (ovf
    identical everywhere and codes identical on every lane without ovf,
    max |difference| of those codes, lanes with ovf)."""
    import torch
    from flac_tpu_torch.ops import bitunpack, rice_cuda
    kres, kovf = rice_cuda.rice_codes(*args, **kw)
    pres, povf = bitunpack.rice_codes_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = ~povf
    same = (kres.dtype == pres.dtype and torch.equal(kovf, povf)
            and torch.equal(kres[:, keep], pres[:, keep]))
    err = 0 if same or not keep.any() else int(
        (kres[:, keep] - pres[:, keep]).abs().max())
    return same, err, int(povf.sum())


def k2_cases(clips: dict):
    """(label, host arrays, static arguments): the first batch of each
    clip's stream, read narrow and wide, and the synthetic bitstreams."""
    from flac_tpu_torch.ops import rice_synth
    cases = []
    for label, stream in clips.items():
        [(arrays, kw)] = decode_batch_inputs(stream, first_only=True)
        for wide in (False, True):
            cases.append((f"{label} stream, {'wide' if wide else 'narrow'}",
                          arrays, dict(kw, wide=wide)))
    for wide in (False, True):
        for lanes in (None, 4096):
            arrays = rice_synth.synthetic_lanes(lanes or 1, wide=wide,
                                                lanes=lanes)
            cases.append((f"synthetic {'wide' if wide else 'narrow'} "
                          f"{len(arrays[1])} lanes", arrays,
                          dict(T=rice_synth.T, NROW=rice_synth.NROW,
                               SEG=rice_synth.SEG, wide=wide)))
        cases.append((f"staging lanes {'wide' if wide else 'narrow'}",
                      rice_synth.staging_lanes(6, wide=wide),
                      dict(T=rice_synth.T, NROW=rice_synth.STAGING_NROW,
                           SEG=rice_synth.SEG, wide=wide)))
    return cases


# ---------------------------------------------------------------------------
# phase 3 cases: K3 against its plain version
# ---------------------------------------------------------------------------

RESTORE_KEYS = ("res", "order", "shift", "qlp", "wasted", "assignment")


def restore_batch_inputs(stream: bytes, first_only: bool = False) -> list:
    """The host arrays of each decode batch of `stream` as the "fast"
    engine gives them to K3 (the native full parse, int16 residuals where
    they fit): [(arrays, K3's static arguments)], or only the first
    batch's."""
    from flac_tpu_torch import decoder_fast as df
    out = []
    for arr, frames, idxs, blocksize, channels, bps in \
            stream_batches(stream):
        pg, asg = df._parse_batch(arr, frames, idxs, blocksize, channels)
        arrays, kw = df.restore_inputs(pg, asg, blocksize, channels, bps)
        out.append((dict(zip(RESTORE_KEYS, arrays)), kw))
        if first_only:
            break
    return out


def k3_compare(t: dict, kw) -> tuple[bool, int]:
    """K3 and its plain version on the same GPU tensors (res cut to the
    blocksize).  Returns (PCM and flags identical, max |difference|)."""
    import torch
    from flac_tpu_torch.ops import bitunpack, restore_cuda
    args = (t["res"][:, :kw["blocksize"]], *(t[k] for k in RESTORE_KEYS[1:]))
    kpcm, koor = restore_cuda.restore_undo(*args, **kw)
    ppcm, poor = bitunpack.restore_undo_body(*args, **kw)
    torch.cuda.synchronize()
    same = (kpcm.dtype == ppcm.dtype and torch.equal(kpcm, ppcm)
            and torch.equal(koor, poor))
    err = 0 if same or kpcm.shape != ppcm.shape else int(
        (kpcm.to(torch.int64) - ppcm.to(torch.int64)).abs().max())
    return same, err


def k3_cases(clips: dict):
    """(label, host arrays, static arguments): the synthetic corners, then
    the first parsed batch of each clip's stream, as the "fast" engine
    gives it (int16 residuals, int16 PCM) and as the "device" engine does
    (int32 residuals)."""
    from flac_tpu_torch.ops import restore_synth
    cases = list(restore_synth.cases())
    for label, stream in clips.items():
        [(arrays, kw)] = restore_batch_inputs(stream, first_only=True)
        cases.append((f"{label} stream, first parsed batch", arrays, kw))
        cases.append((f"{label} stream, int32 residuals, int32 PCM",
                      dict(arrays, res=arrays["res"].astype("int32")),
                      dict(kw, out16=False)))
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


def device_round_trip(stream: bytes, pcm) -> float:
    """Decode on the GPU through K2 (decode_stream_tpu, engine "device":
    every CRC and the MD5 checked); the samples must equal pcm.  Returns
    seconds."""
    import numpy as np
    import torch
    from flac_tpu_torch import decode_stream_tpu
    t0 = time.perf_counter()
    st = decode_stream_tpu(stream, engine="device")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not st.md5_ok or not np.array_equal(st.samples, pcm):
        raise AssertionError("the device decode differs from the input")
    return wall


def decode_batches(frames: list) -> int:
    """Decode batches of the device engine (one K2 launch each): each
    (blocksize, channels) group in batches of up to DECODE_BATCH frames."""
    groups: dict = {}
    for f in frames:
        key = (f["blocksize"], f["channels"])
        groups[key] = groups.get(key, 0) + 1
    return sum(-(-n // DECODE_BATCH) for n in groups.values())


def encode(pcm, level: int, blocksize: int = 4096, **kw):
    from flac_tpu_torch import EncoderConfig
    from flac_tpu_torch.encoder import StreamEncoder
    buf = io.BytesIO()
    enc = StreamEncoder(buf, EncoderConfig.from_preset(level,
                                                       blocksize=blocksize),
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


def profile_run(run, label: str, ranges: tuple, own: tuple) -> dict:
    """torch.profiler over one call of `run` (after a warm call): wall
    time, device busy share, host and device time of each flac.* range,
    the device time of the package's own kernels (`own`: launched through
    ctypes, so the profiler does not attribute them to a range), and the
    top kernels.  The full table goes to OUT_DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    # kernels launched inside it
    stages = {r: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
              for r in ranges}
    for e in prof.events():
        if e.name in stages and str(e.device_type).endswith("CPU"):
            d = stages[e.name]
            d["calls"] += 1
            d["host_ms"] += e.cpu_time_total / 1e3
            d["device_ms"] += _device_us(e, False) / 1e3
    top = sorted(kernels_, key=lambda e: -_device_us(e, True))[:8]
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=40))
    own_ms = {k: sum(_device_us(e, True) for e in kernels_ if k in e.key)
              / 1e3 for k in own}
    return {"phase": "profile", "run": label, "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else
            "not measured",
            "device_kernel_launches": sum(e.count for e in kernels_),
            "stages": stages, "own_kernels_device_ms": own_ms,
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
        from flac_tpu_torch import (EncoderConfig, decode_stream_tpu,
                                    kernels, native, signals)
        from flac_tpu_torch.models import frame as frame_mod
        from flac_tpu_torch import decoder as decoder_mod
        from flac_tpu_torch.ops import bitpack, bitunpack, pack_cuda, \
            restore_cuda, rice_cuda
    except ImportError as e:
        return fail(f"the flac_tpu_torch package is not here ({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": dev_info["kind"],
          "count": dev_info["count"], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    # ---- 2. build the kernel sources together, and the native runtime;
    # run the probes ----
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    import kernel_variants
    with ThreadPoolExecutor(max_workers=2) as pool:
        host_lib = pool.submit(native.lib)
        probe_lib = pool.submit(kernel_variants.build_chain_probe)
        reports = kernels.load_all(["pack_fields64", "rice_codes",
                                    "restore"])
        build_s = time.perf_counter() - t0
        host_lib.result()
        probe_lib = probe_lib.result()
    host_s = time.perf_counter() - t0
    pack_cuda.probe()
    rice_cuda.probe()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for lib_name, report in reports.items():
            f.write(f"== {lib_name} (parallel build {build_s:.1f} s)\n"
                    f"{report}\n")
    usage = {"pack_fields64": ptxas_usage(reports["pack_fields64"],
                                          "pack_fields64_kernel"),
             "rice_codes": ptxas_usage(reports["rice_codes"],
                                       "rice_codes_kernel"),
             "restore": ptxas_usage(reports["restore"], "restore_kernel")}
    # K3's dynamic shared memory (its rings), by the kernel's own count and
    # by the host mirror, for each residual width, narrow and wide
    k3_lib = restore_cuda._library()
    k3_smem = {f"{8 * rb}-bit res, {'wide' if wide else 'narrow'}":
               (k3_lib.flac_restore_smem(rb, int(wide)),
                restore_cuda.smem_bytes(rb, wide))
               for rb in (2, 4, 8) for wide in (False, True)}
    emit({"phase": "build", "nvcc_seconds": round(build_s, 2),
          "native_seconds": round(host_s, 2), "probes": ["P1", "P2"],
          "ptxas": usage,
          "restore_smem_dynamic_bytes": {k: v[0] for k, v in
                                         k3_smem.items()}})
    k3_spills = {fn: u for fn, u in usage["restore"].items()
                 if u.get("spill_stores") or u.get("spill_loads")}
    if len(usage["restore"]) != 2 * len(restore_cuda.ORDER_BUCKETS) \
            or k3_spills:
        return fail(f"K3's instantiations (narrow and wide a bucket) spill "
                    f"or are missing: {usage['restore']}")
    if any(a != b or a > 232448 for a, b in k3_smem.values()):
        return fail(f"K3's dynamic shared memory differs from the host "
                    f"mirror or passes 227 KB: {k3_smem}")

    # ---- 3. each kernel against its plain version ----
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
    clips = {f"-{lv}": encode(signals.make_test_signal(
        5 * RATE, seed=30 + lv), lv)[0] for lv in (5, 8)}
    k2_err = 0
    for label, arrays, static in k2_cases(clips):
        ok, err, n_ovf = k2_compare(
            [torch.from_numpy(a).cuda() for a in arrays], static)
        staged = rice_cuda.staged_ctas(arrays[1], static["NROW"])
        emit({"phase": "kernels", "kernel": "rice_codes", "case": label,
              "lanes": len(arrays[1]), "ovf_lanes": n_ovf, **static,
              "staged_ctas": int(staged.sum()), "ctas": len(staged),
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K2 differs from its plain version on '{label}'")
        k2_err = max(k2_err, err)
    k3_err = 0
    for label, arrays, static in k3_cases(clips):
        t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
        ok, err = k3_compare(t, static)
        emit({"phase": "kernels", "kernel": "restore", "case": label,
              "subframes": int(arrays["res"].shape[0]),
              "res": str(arrays["res"].dtype), **static,
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K3 differs from its plain version on '{label}'")
        k3_err = max(k3_err, err)
    if args.quick:
        emit({"phase": "done", "quick": True,
              "seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit({"ok": True, "device": dev_info})
        return 0

    # ---- 4. the main path at full size: encode, then decode ----
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
    enc_mbps = pcm_bytes / 1e6 / wall
    emit({"phase": "main", "preset": -5, "seconds_audio": TRACK_SECONDS,
          "pcm_mb": pcm_bytes / 1e6, "encode_wall_s": wall,
          "encode_mb_per_s": enc_mbps,
          "compression_ratio": len(stream) / pcm_bytes,
          "launches": {"pack_fields64": k1_launches},
          "quad_batches": expect, "misfit_frames": enc.misfit_frames})
    if k1_launches <= 0 or k1_launches != expect:
        return fail(f"K1 launched {k1_launches} times on the main path, "
                    f"expected one per quad-layout batch ({expect})")
    t0 = time.perf_counter()
    decode_stream_tpu(stream)                                # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    staged_before = rice_cuda.staged_ctas_count()
    rice_cuda.launches = restore_cuda.launches = 0
    t0 = time.perf_counter()
    st = decode_stream_tpu(stream, max_batch=DECODE_BATCH)
    torch.cuda.synchronize()
    dec_wall = time.perf_counter() - t0
    k2_launches = rice_cuda.launches
    k3_launches = restore_cuda.launches
    k2_staged = rice_cuda.staged_ctas_count() - staged_before
    batches = decode_batches(st.frames)
    emit({"phase": "main", "decode": "device", "warm_up_s": warm_s,
          "decode_wall_s": dec_wall,
          "decode_mb_per_s": pcm_bytes / 1e6 / dec_wall,
          "encode_mb_per_s": enc_mbps, "frames": len(st.frames),
          "launches": {"rice_codes": k2_launches, "restore": k3_launches},
          "decode_batches": batches})
    if not st.md5_ok or not np.array_equal(st.samples, pcm):
        return fail("the device decode of the main track differs from the "
                    "input")
    if k2_launches <= 0 or k2_launches != batches:
        return fail(f"K2 launched {k2_launches} times on the main path, "
                    f"expected one per decode batch ({batches})")
    if k3_launches != batches:
        return fail(f"K3 launched {k3_launches} times in the device "
                    f"engine's decode, expected one per batch ({batches})")
    # the staged CTAs of each main-path launch, by the host mirror of the
    # kernel's rule; their sum must be the kernel's own count
    per_launch = []
    for arrays, kw in decode_batch_inputs(stream):
        staged = rice_cuda.staged_ctas(arrays[1], kw["NROW"])
        per_launch.append([int(staged.sum()), len(staged)])
    emit({"phase": "main", "decode": "staging",
          "staged_ctas_per_launch": per_launch,
          "staged_ctas_counted_by_kernel": k2_staged})
    if sum(s for s, _ in per_launch) != k2_staged:
        return fail(f"K2 counted {k2_staged} staged CTAs on the main path, "
                    f"the host mirror of its rule {per_launch}")
    if any(s != n for s, n in per_launch):
        return fail(f"not every CTA of the main path's K2 launches staged: "
                    f"{per_launch}")
    t0 = time.perf_counter()
    decode_stream_tpu(stream, engine="fast")                 # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rice_cuda.launches = restore_cuda.launches = 0
    t0 = time.perf_counter()
    fast = decode_stream_tpu(stream, engine="fast", max_batch=DECODE_BATCH)
    torch.cuda.synchronize()
    fast_wall = time.perf_counter() - t0
    k3_fast_launches = restore_cuda.launches
    emit({"phase": "main", "decode": "fast", "warm_up_s": warm_s,
          "decode_wall_s": fast_wall,
          "decode_mb_per_s": pcm_bytes / 1e6 / fast_wall,
          "launches": {"rice_codes": rice_cuda.launches,
                       "restore": k3_fast_launches},
          "decode_batches": batches})
    if not fast.md5_ok or not np.array_equal(fast.samples, pcm):
        return fail("the fast engine's decode of the main track differs "
                    "from the input")
    if k3_fast_launches != batches or rice_cuda.launches:
        return fail(f"the fast engine launched K3 {k3_fast_launches} times "
                    f"(expected {batches}) and K2 {rice_cuda.launches} "
                    "times (expected 0)")
    decode_stream_tpu(stream, engine="host")                 # warm-up
    t0 = time.perf_counter()
    host = decode_stream_tpu(stream, engine="host")
    host_s = time.perf_counter() - t0
    if not np.array_equal(host.samples, st.samples):
        return fail("the host engine's decode differs from the device's")
    cores = os.cpu_count() or 1
    link = decoder_mod.probe_link_bandwidth("cuda")
    emit({"phase": "main", "round_trip": "ok", "md5": "match",
          "host_engine": "equal", "host_decode_s": host_s,
          "decode_mb_per_s": {"device": pcm_bytes / 1e6 / dec_wall,
                              "fast": pcm_bytes / 1e6 / fast_wall,
                              "host": pcm_bytes / 1e6 / host_s},
          "cpu_count": cores,
          "host_mb_per_s_per_core": pcm_bytes / 1e6 / host_s
          / min(cores, 8),
          "link_mb_per_s": link,
          "auto_picks": decoder_mod._pick_engine(st.frames,
                                                 torch.device("cuda"))})

    # ---- 5. A/B through the path ----
    clip = signals.make_test_signal(20 * RATE, seed=20)
    s_kernel, _ = encode(clip, 5)
    s_plain, _ = encode(clip, 5, packer="plain")
    if s_kernel != s_plain:
        return fail("-5 stream through the plain packer differs from the "
                    "kernel's")
    emit({"phase": "ab", "case": "-5 kernel vs plain", "identical": True,
          "bytes": len(s_kernel)})
    ref_s = round_trip(s_kernel, clip)
    emit({"phase": "ab", "case": "-5 round trip", "ok": True,
          "reference_decode_s": ref_s,
          "device_decode_s": device_round_trip(s_kernel, clip)})
    for level in (0, 8):
        s, _ = encode(clip, level)
        ref_s = round_trip(s, clip)
        emit({"phase": "ab", "case": f"-{level} round trip", "ok": True,
              "bytes": len(s), "reference_decode_s": ref_s,
              "device_decode_s": device_round_trip(s, clip)})
    burst = signals.make_transient_signal(20 * RATE, seed=21)
    s, benc = encode(burst, 5)
    ref_s = round_trip(s, burst)
    emit({"phase": "ab", "case": "transient clip round trip", "ok": True,
          "misfit_frames_safe_reencoded": benc.misfit_frames,
          "reference_decode_s": ref_s,
          "device_decode_s": device_round_trip(s, burst)})
    if benc.misfit_frames <= 0:
        return fail("the transient clip sent no frame to the safe re-encode")
    # tolerant decoding on the GPU: a corrupted and a cut frame
    frames = decode_stream_tpu(s_kernel, engine="host").frames
    bad = bytearray(s_kernel)
    f3, f7 = frames[3], frames[7]
    bad[f3["offset"] + f3["size"] // 2] ^= 0x10
    bad = bytes(bad[:f7["offset"] + f7["size"] // 2]
                + bad[f7["offset"] + f7["size"]:])
    want = decode_stream_tpu(bad, tolerant=True, engine="host")
    for engine in ("device", "fast"):
        t0 = time.perf_counter()
        got = decode_stream_tpu(bad, tolerant=True, engine=engine)
        torch.cuda.synchronize()
        tol_s = time.perf_counter() - t0
        same = (np.array_equal(got.samples, want.samples)
                and got.errors == want.errors)
        emit({"phase": "ab", "case": f"tolerant decode, {engine} engine",
              "equal_to_host": same, "errors": got.errors,
              "decode_s": tol_s})
        if not same or len(got.errors) < 2:
            return fail(f"the tolerant {engine} decode differs from the "
                        "host engine's, or found too few errors")
    # the "scan" engine (plain torch ops, the oracle) on a short -0 clip
    short0 = signals.make_test_signal(RATE, seed=0)
    s0, _ = encode(short0, 0, blocksize=1152)
    t0 = time.perf_counter()
    got = decode_stream_tpu(s0, engine="scan")
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    host0 = decode_stream_tpu(s0, engine="host")
    same = (got.md5_ok and np.array_equal(got.samples, host0.samples)
            and np.array_equal(got.samples, short0))
    emit({"phase": "ab", "case": "scan engine, 1 s at -0, blocksize 1152",
          "equal_to_host": same, "frames": len(got.frames),
          "decode_s": scan_s})
    if not same:
        return fail("the scan engine's decode differs from the host's")

    # ---- 6. times at the main path's shapes ----
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
    k1_dev = kernel_device_ms(lambda: pack_cuda.pack_fields64(
        nz, pay, pb, W), "pack_fields64_kernel")
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
          "W": W, "device_ms": k1_dev["ms"],
          "kernel_ms_runs": [kernel_ms, kernel_ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], "bytes": nbytes,
          "operations": nops})
    k1 = {"name": "pack_fields64", "route": "cuda",
          "source": pack_cuda.SOURCE, "replaces": pack_cuda.REPLACES,
          "launches": k1_launches, "max_abs_err": max_err,
          **k1_dev,
          "kernel_ms": min(kernel_ms, kernel_ms2),
          "plain_ms": min(plain_ms, plain_ms2),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          "library_ms": None,
          "library_note": "no single PyTorch call computes this deposit",
          "cluster": pack_cuda.CLUSTER,
          "smem_dynamic_bytes": pack_cuda.rank_words(W) * 4,
          "ptxas": usage["pack_fields64"]}

    # K2 on the main path's first full decode batch
    [(arrays, k2kw)] = decode_batch_inputs(stream, first_only=True)
    words2d, lane_start, segs = (torch.from_numpy(a).cuda() for a in arrays)
    ok, err, n_ovf = k2_compare([words2d, lane_start, segs], k2kw)
    if not ok:
        return fail("K2 differs from its plain version on the main path's "
                    "first batch")
    k2_err = max(k2_err, err)

    def k2_kernel():
        rice_cuda.rice_codes(words2d, lane_start, segs, **k2kw)

    def k2_plain():
        bitunpack.rice_codes_plain(words2d, lane_start, segs, **k2kw)
    plain_ms = cuda_time_ms(k2_plain, warmup=1, runs=5)
    kernel_ms = cuda_time_ms(k2_kernel)
    kernel_ms2 = cuda_time_ms(k2_kernel)
    plain_ms2 = cuda_time_ms(k2_plain, warmup=1, runs=5)
    k2_dev = kernel_device_ms(k2_kernel, "rice_codes_kernel")
    # each input read once (the batch's stream words, lane_start, the SEG
    # segment slots of each lane), each output written once (res [T, L]
    # int32 or int64, ovf one byte a lane); the operations count the codes
    # this batch really decodes (real segments, at most T a lane)
    T, SEG = k2kw["T"], k2kw["SEG"]
    L = arrays[1].shape[0]
    counts = ((arrays[2] >> 7) & 0xFF) * (arrays[2] != bitunpack.SEG_INERT)
    codes = int(counts.sum(axis=1).clip(max=T).sum())
    nbytes = (arrays[0].nbytes + L * 4 + L * SEG * 4
              + T * L * (8 if k2kw["wide"] else 4) + L)
    nops = codes * K2_OPS_PER_CODE
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / NON_TENSOR_OPS_PER_S * 1e3
    emit({"phase": "times", "kernel": "rice_codes", "L": L, "T": T,
          "NROW": k2kw["NROW"], "SEG": SEG, "wide": k2kw["wide"],
          "codes": codes, "ovf_lanes": n_ovf,
          "staged_ctas_per_launch": per_launch, "device_ms": k2_dev["ms"],
          "kernel_ms_runs": [kernel_ms, kernel_ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], "bytes": nbytes,
          "operations": nops})
    k2 = {"name": "rice_codes", "route": "cuda",
          "source": rice_cuda.SOURCE, "replaces": rice_cuda.REPLACES,
          "launches": k2_launches, "max_abs_err": k2_err,
          **k2_dev,
          "kernel_ms": min(kernel_ms, kernel_ms2),
          "plain_ms": min(plain_ms, plain_ms2),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          "library_ms": None,
          "library_note": "no PyTorch call decodes Rice codes",
          "staged_ctas_per_launch": per_launch,
          "smem_dynamic_bytes": rice_cuda.STAGE_ROWS * 64,
          "ptxas": usage["rice_codes"]}

    # K3 on the main path's first full decode batch, as the device engine
    # gives it: K2's codes as the [S, N] residual matrix, int16 PCM out
    from flac_tpu_torch import decoder_device as dd
    arr = np.frombuffer(stream, np.uint8)
    prep = dd._prep_batch(arr, st.frames, list(range(DECODE_BATCH)), 4096, 2)
    barrays, bkw = dd.batch_inputs(arr, *prep)
    tensors = [torch.from_numpy(a).cuda() for a in barrays]
    res_tl, _ = rice_cuda.rice_codes(*tensors[:3], T=dd._tile_T(4096),
                                     NROW=bkw["NROW"], SEG=bkw["SEG"],
                                     wide=bkw["wide"])
    S = tensors[3].shape[0]
    # the device engine's lanes -> residual matrix copy
    # (ops/bitunpack.py rice_decode_restore), timed on its own
    transpose_ms = queued_device_ms(
        lambda: res_tl.t().reshape(S, -1), runs=25)
    emit({"phase": "times", "step": "res_tl.t().reshape(S, -1)",
          "shape": list(res_tl.shape), "dtype": str(res_tl.dtype),
          "device_ms_queued_events": transpose_ms,
          "bytes": 2 * res_tl.numel() * res_tl.element_size()})
    k3t = dict(zip(RESTORE_KEYS, [res_tl.t().reshape(S, -1)[:, :4096],
                                  *tensors[3:]]))
    k3kw = dict(blocksize=4096, channels=2, max_order=bkw["max_order"],
                wide=bkw["wide"], out16=True, bps=16)
    ok, err = k3_compare(k3t, k3kw)
    if not ok:
        return fail("K3 differs from its plain version on the main path's "
                    "first batch")
    k3_err = max(k3_err, err)
    k3args = (k3t["res"], *(k3t[k] for k in RESTORE_KEYS[1:]))

    def k3_kernel():
        restore_cuda.restore_undo(*k3args, **k3kw)

    def k3_plain():
        bitunpack.restore_undo_body(*k3args, **k3kw)
    plain_ms = cuda_time_ms(k3_plain, warmup=0, runs=1)
    kernel_ms = cuda_time_ms(k3_kernel)
    kernel_ms2 = cuda_time_ms(k3_kernel)
    plain_ms2 = cuda_time_ms(k3_plain, warmup=0, runs=1)
    k3_dev = kernel_device_ms(k3_kernel, "restore_kernel")
    # the fast engine's input: int16 residuals of the same frames
    [(farrays, fkw)] = restore_batch_inputs(stream, first_only=True)
    ft = {k: torch.from_numpy(v).cuda() for k, v in farrays.items()}
    fargs = (ft["res"], *(ft[k] for k in RESTORE_KEYS[1:]))
    k3_fast = kernel_device_ms(
        lambda: restore_cuda.restore_undo(*fargs, **fkw), "restore_kernel")
    # the chain's floor: each CTA's N samples at the probe's cycles a
    # sample (the folded form, which the main path takes) and SM clock
    probe = kernel_variants.chain_probe(probe_lib)
    chain_floor_ms = (4096 * probe["folded_cycles_per_sample"]
                      / probe["cycles_per_ns"] / 1e6)
    # each input read once (res as the device engine hands it over, in
    # int32; order, shift, wasted, the taps, the assignments), each output
    # written once (int16 PCM, a flag a frame); the operations count each
    # subframe's own order, not the bucket's
    N = 4096
    B = S // 2
    order_np = barrays[3].astype(np.int64)
    nbytes = (S * N * 4 + S * 4 * 3 + S * bkw["max_order"] * 4 + B * 4
              + S * N * 2 + B)
    nops = int(N * (K3_OPS_PER_TAP * order_np + K3_OPS_PER_SAMPLE).sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / NON_TENSOR_OPS_PER_S * 1e3
    emit({"phase": "times", "kernel": "restore", "S": S, "N": N,
          "max_order": bkw["max_order"], "device_ms": k3_dev["ms"],
          "device_ms_fast_engine_input": k3_fast["ms"],
          "chain_probe": probe, "chain_floor_ms": chain_floor_ms,
          "kernel_ms_runs": [kernel_ms, kernel_ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], "bytes": nbytes,
          "operations": nops})
    k3 = {"name": "restore", "route": "cuda",
          "source": restore_cuda.SOURCE, "replaces": restore_cuda.REPLACES,
          "launches": k3_launches, "launches_fast_engine": k3_fast_launches,
          "max_abs_err": k3_err, **k3_dev,
          "ms_int16_input": k3_fast["ms"],
          "ms_int16_input_by": k3_fast["ms_by"],
          "kernel_ms": min(kernel_ms, kernel_ms2),
          "plain_ms": min(plain_ms, plain_ms2),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
          "chain_floor_ms": chain_floor_ms,
          "transpose_copy_ms": transpose_ms,
          "smem_dynamic_bytes": restore_cuda.smem_bytes(
              k3t["res"].element_size(), bkw["wide"]),
          "library_ms": None,
          "library_note": "no PyTorch call computes an integer IIR restore",
          "ptxas": usage["restore"]}
    emit({"kernels": [k1, k2, k3]})

    # ---- 7. where the time goes in a steady encode and decode ----
    short = signals.make_test_signal(10 * RATE, seed=7)
    emit(profile_run(lambda: encode(short, 5), "encode_-5",
                     ("flac.search", "flac.assign", "flac.assemble",
                      "flac.pack"), ("pack_fields64_kernel",)))
    short_stream, _ = encode(short, 5)
    emit(profile_run(lambda: decode_stream_tpu(short_stream), "decode",
                     ("flac.tile_scan", "flac.upload", "flac.codes",
                      "flac.restore", "flac.fetch"),
                     ("rice_codes_kernel", "restore_kernel")))
    emit(profile_run(lambda: decode_stream_tpu(short_stream, engine="fast"),
                     "decode_fast",
                     ("flac.parse", "flac.upload", "flac.restore",
                      "flac.fetch"), ("restore_kernel",)))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": dev_info})
    return 0


if __name__ == "__main__":
    sys.exit(main())
