"""One run of one cell: set-up, the measured window, the check, the
result line.

The window encodes files one after another, as the `flac` command line
and `encode_file_to_flac` do: a StreamEncoder on the card with the
program's defaults, one process() call with the whole file, finish(), the
stream into memory.  It closes at the end of the first round of the mix
(traffic.Plan) that ends past `seconds`, so every seed sends the same
work; its length is the host clock's from the first file's start to the
last file's end, and every file in it counts whole.
"""

from __future__ import annotations

import gc
import inspect
import io
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from . import cells, reference, trace as trace_mod, traffic, work

# modules the process that prints a result may not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "flac_tpu")
FAULTS = ("lsb", "flip", "half")


@dataclass
class FileRun:
    index: int
    samples: int
    pcm_bytes: int
    start: float
    processed: float
    end: float
    out: io.BytesIO
    misfits: int
    ops_calls: int       # program calls of a key seen for the first time
    captures: int = 0    # program calls that captured a graph


@dataclass
class Run:
    """What a run measured; the per-layer readers read it."""
    cell: cells.Cell
    seed: int
    enc: work.Encoding
    blocksize: int
    files: list = field(default_factory=list)
    window_s: float = 0.0
    trace: trace_mod.Trace | None = None
    launches: dict = field(default_factory=dict)   # kernel counter deltas
    calls: list = field(default_factory=list)      # work.Call of the window
    parses: dict = field(default_factory=dict)     # file index -> parse
    log: object = print

    @property
    def pcm_bytes(self) -> int:
        return sum(f.pcm_bytes for f in self.files)

    @property
    def frames(self) -> int:
        return sum(-(-f.samples // self.blocksize) for f in self.files)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def encoder_config(config: dict):
    """The program's configuration for a configuration file: the flac
    level on the format, with every setting the file states put over the
    level's, as resolved; each stated setting is then held to what the
    program resolved, so a file states what runs (a mono file states no
    mid-side search, which the program drops for one channel)."""
    from flac_tpu_torch.config import EncoderConfig
    settings = {k: tuple(v) if isinstance(v, list) else v
                for k, v in config["encoder"].items()}
    cfg = EncoderConfig.from_preset(config["level"], **config["format"],
                                    **settings).resolve()
    for key, want in settings.items():
        have = getattr(cfg, key)
        if want != have:
            raise RuntimeError(f"{config['name']}: the program resolves "
                               f"{key} to {have!r}, the configuration "
                               f"states {want!r}")
    return cfg


def encoder_options(config: dict) -> dict:
    """StreamEncoder's keyword options a configuration file states under
    `stream_encoder` (flac's -V is {"verify": true}); the program's
    defaults where it states none."""
    return dict(config.get("stream_encoder", {}))


def encoding(config: dict) -> work.Encoding:
    fmt, e = config["format"], config["encoder"]
    return work.Encoding(
        channels=fmt["channels"], bps=fmt["bits_per_sample"],
        max_lpc_order=e["max_lpc_order"],
        max_partition_order=e["max_residual_partition_order"],
        apodizations=tuple(e["apodizations"]), mid_side=e["do_mid_side"],
        loose=e["loose_mid_side"],
        exhaustive=e["do_exhaustive_model_search"],
        precision_search=e["do_qlp_coeff_prec_search"])


def pipeline_shape(stream_encoder, options: dict) -> tuple[int, int]:
    """(frames a batch, batches a super-chunk): the options', else
    StreamEncoder's defaults."""
    p = inspect.signature(stream_encoder).parameters
    return tuple(options.get(k, p[k].default)
                 for k in ("batch_frames", "super_batches"))


def parse_sum(parse: dict, lo: int, hi: int) -> work.Parse:
    pr = work.Parse()
    for ch in parse["channels"]:
        res = ch["has_res"][lo:hi].astype(bool)
        typ = ch["type"][lo:hi]
        pr.res_subframes += int(res.sum())
        pr.verbatim_subframes += int((typ == 1).sum())
        pr.lpc_subframes += int((typ == 3).sum())
        pr.partitions += int((res * (1 << ch["po"][lo:hi])).sum())
    lens = parse["byte_len"][lo:hi].astype(np.int64)
    pr.crc_bytes = int((lens - 2).clip(min=0).sum())
    pr.words = int(((lens + 3) // 4).sum())
    return pr


def file_calls(enc: work.Encoding, n: int, N: int, B: int, G: int,
               parse_of, misfits: int) -> list:
    """The encode program calls one file made, with the parse of their
    frames (`parse_of(lo, hi)`, a work.Parse of frames lo .. hi - 1): each
    unit's call, and the safe pass of each unit whose frames misfit the
    quad layout (where every quad frame misfit; where only some did, one
    call of the misfit frames alone, with no parse).  A model of the
    program's batching: the kernels' reader holds its launch counts to the
    program's counters."""
    in_bytes = 2 if enc.bps <= 16 else 4
    calls, safe, f, quad_frames = [], [], 0, 0
    for kind, v in traffic.units(n, N, B, G):
        size = N if kind != "tail" else v
        frames = v * B if kind == "super" else (v if kind == "batch" else 1)
        quad = enc.quad(size)
        for lo in range(f, f + frames, B if kind == "super" else frames):
            hi = min(lo + B, f + frames)
            calls.append(work.Call(hi - lo, size, in_bytes, quad,
                                   parse_of(lo, hi)))
        if quad:
            quad_frames += frames
            pad = frames if kind == "super" or frames > max(8, frames // 8) \
                else 1 << (frames - 1).bit_length()
            safe.append(work.Call(pad, size, 4, False,
                                  parse_of(f, f + frames)))
        f += frames
    if misfits and misfits == quad_frames:
        calls += safe
    elif misfits:
        calls.append(work.Call(misfits, N, 4, False))
    return calls


def card_name() -> str:
    """The card's name and power limit by nvidia-smi, for the log."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class _FlipSink(io.BytesIO):
    """The `flip` fault: one bit of the first frames written is flipped
    as the program writes them."""

    def __init__(self):
        super().__init__()
        self.flipped = False

    def write(self, b):
        if not self.flipped and self.tell() > 4200 and len(b) > 64:
            b = bytearray(b)
            b[len(b) // 2] ^= 0x10
            self.flipped = True
        return super().write(b)


def _half_batches(encode_batch):
    """The `half` fault: the second half of each batch is left out (its
    samples zeroed) before the program encodes it."""
    def wrapped(pcm, *a, **kw):
        pcm = pcm.clone()
        pcm[pcm.shape[0] // 2:] = 0
        return encode_batch(pcm, *a, **kw)
    return wrapped


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, *,
             t0: float, device: str = "cuda", fault: str | None = None,
             log=print) -> dict:
    """One run of `cell`; returns the result line's object (with the
    Run under "_run")."""
    from flac_tpu_torch import encoder as encoder_mod, kernels, native
    from flac_tpu_torch.encoder import StreamEncoder
    cfg = encoder_config(cell.config)
    options = encoder_options(cell.config)
    enc = encoding(cell.config)
    fmt = cell.config["format"]
    C, bps, rate = fmt["channels"], fmt["bits_per_sample"], fmt["sample_rate"]
    content = cell.mix["content"]
    traffic.check_content(content, bps)
    N = cfg.blocksize
    B, G = pipeline_shape(StreamEncoder, options)
    cuda = device == "cuda"
    if cuda:
        log(f"card: {card_name()}")
        torch.cuda.set_device(0)
        kernels.load_all(sorted(p.stem for p in kernels.SRC_DIR.glob("*.cu")))
    native.lib()
    plan = traffic.Plan(cell.mix, rate, N, seed)
    pool = traffic.make_pool(plan, C, bps, device, content)
    warm = traffic.warm_lengths(plan, B, G)
    warm_pcm = traffic.make_buffer(seed, plan.pool, max(warm), C, bps, rate,
                                   device, content)
    for n in warm:
        for _ in range(2):        # a key's first call runs the ops, the
            e = StreamEncoder(io.BytesIO(), cfg, device=device,   # second
                              **options)                          # captures
            e.process(warm_pcm[:, :n])
            e.finish()
    sound_encode_batch = encoder_mod.encode_batch
    if fault == "half":
        encoder_mod.encode_batch = _half_batches(sound_encode_batch)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what set-up left is kept out of the collector's later passes, so a
    # full collection inside the window walks only the window's objects
    gc.collect()
    gc.freeze()
    run = Run(cell, seed, enc, N, log=log)
    counted = {k: encoder_mod.COUNTED_KERNELS[v].launches
               for k, v in work.COUNTERS.items()}
    setup_s = time.perf_counter() - t0
    span = torch.profiler.record_function if traced else \
        (lambda name: nullcontext())
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    nbytes = (bps + 7) // 8
    rounds = int(cell.mix["sizes_per_round"])
    with span("bench.window"):
        start = time.perf_counter()
        k = 0
        while True:
            f = plan.file(k)
            pcm = pool[f.buffer][:, f.offset:f.offset + f.samples]
            if fault == "lsb":
                pcm = pcm & ~1
            out = _FlipSink() if fault == "flip" else io.BytesIO()
            seen = len(encoder_mod._PROGRAMS.seen)
            graphs = len(encoder_mod._PROGRAMS.graphs)
            ta = time.perf_counter()
            with span("bench.file"):
                e = StreamEncoder(out, cfg, device=device, **options)
                with span("bench.process"):
                    e.process(pcm)
                tp = time.perf_counter()
                with span("bench.finish"):
                    e.finish()
            tf = time.perf_counter()
            run.files.append(FileRun(
                k, f.samples, f.samples * C * nbytes, ta, tp, tf, out,
                e.misfit_frames, len(encoder_mod._PROGRAMS.seen) - seen,
                len(encoder_mod._PROGRAMS.graphs) - graphs))
            k += 1
            if tf - start >= seconds and k % rounds == 0:
                break
    run.window_s = tf - start
    if prof is not None:
        prof.__exit__(None, None, None)
    gc.unfreeze()
    run.launches = {k: encoder_mod.COUNTED_KERNELS[v].launches - counted[k]
                    for k, v in work.COUNTERS.items()}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    encoder_mod.encode_batch = sound_encode_batch
    log_window(run)
    # the program's state is freed before the reference runs
    del e
    encoder_mod._PROGRAMS.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded in this process: {bad}")
    if traced:
        run.trace = trace_mod.reduce(prof)
        del prof
    checks, failed = check(run, pool, plan, bps, rate, N, device)
    if traced:
        mean = frame_mean(run)
        for f in run.files:
            p = run.parses.get(f.index)
            parse_of = (lambda lo, hi, p=p: parse_sum(p, lo, hi)) \
                if p is not None else \
                (lambda lo, hi: estimated(mean, hi - lo))
            run.calls += file_calls(enc, f.samples, N, B, G, parse_of,
                                    f.misfits)
    correct = all(v == 0 for k, v in checks.items() if k != "files_checked") \
        and checks["files_checked"] > 0
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = cells.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"encode_MBps": run.pcm_bytes / run.window_s / 1e6,
                  "size_pct": 100.0 * sum(len(f.out.getbuffer())
                                          for f in run.files)
                  / run.pcm_bytes,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(run.files),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": 1 if cuda else 0,
                         "memory_peak_bytes": int(memory_peak)}}
    if traced:
        tr = run.trace
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        ops = tr.kernel_seconds()
        for name, kind, s, e in tr.ops:
            if kind != "kernel":
                ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": tr.idle_by_host()}
    result["checks"] = {k: [v, 0] for k, v in checks.items()
                        if k != "files_checked"}
    result["checks"]["files_checked"] = [checks["files_checked"],
                                         "at least 1"]
    result["_run"] = run
    return result


def log_window(run: Run) -> None:
    """The window's files for the log: their rates, and the files that
    ran a program call op by op or captured one against the rest."""
    files = run.files
    rates = [f.pcm_bytes / (f.end - f.start) / 1e6 for f in files]
    ms = {kind: [(f.end - f.start) * 1e3 for f in files if test(f)]
          for kind, test in (("op by op", lambda f: f.ops_calls),
                             ("captured", lambda f: f.captures),
                             ("replayed only",
                              lambda f: not f.ops_calls and not f.captures))}
    run.log(f"window {run.window_s:.3f} s, {len(files)} files; a file's "
            f"MB/s p10 {np.percentile(rates, 10):.1f} p50 "
            f"{np.median(rates):.1f} p90 {np.percentile(rates, 90):.1f}; "
            + ", ".join(f"{len(v)} {kind} (mean {np.mean(v):.2f} ms)"
                        for kind, v in ms.items() if v))


def frame_mean(run: Run) -> dict:
    """The checked files' parse sums over all their frames, a frame."""
    sums = dict.fromkeys(vars(work.Parse()), 0)
    frames = 0
    for p in run.parses.values():
        F = len(p["byte_len"])
        frames += F
        for k, v in vars(parse_sum(p, 0, F)).items():
            sums[k] += v
    return {k: v / max(frames, 1) for k, v in sums.items()}


def estimated(mean: dict, frames: int) -> work.Parse:
    """An estimate of the parse sums of `frames` frames the reference did
    not check: the checked files' mean a frame, times the frames."""
    return work.Parse(**{k: round(v * frames) for k, v in mean.items()})


def check(run: Run, pool, plan, bps, rate, N, device):
    """Hold the window's streams to their inputs with the plain
    reference: files in an order drawn from the seed, the longest first,
    for a quarter as long as the window lasted (at least one).  The
    inputs' MD5s are computed on two threads ahead of the checks.  Returns
    (the summed counts, the files that failed)."""
    files = run.files
    order = np.random.default_rng(run.seed + 1).permutation(len(files))
    longest = max(range(len(files)), key=lambda i: files[i].samples)
    order = [longest] + [int(i) for i in order if i != longest]
    sums = {"bad_frames": 0, "bad_samples": 0, "md5_bad": 0, "info_bad": 0,
            "files_checked": 0}
    failed = 0

    def pcm_of(i):
        pf = plan.file(files[i].index)
        return pool[pf.buffer][:, pf.offset:pf.offset + pf.samples]

    t = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        md5s = {}
        for j, i in enumerate(order):
            for ahead in order[j:j + 3]:
                if ahead not in md5s:
                    md5s[ahead] = ex.submit(reference.md5_of_pcm,
                                            pcm_of(ahead), bps)
            if sums["files_checked"] and \
                    time.perf_counter() - t > run.window_s / 4:
                break
            f = files[i]
            r = reference.check_stream(
                bytes(f.out.getbuffer()), pcm_of(i), bps=bps, rate=rate,
                blocksize=N, device=device, md5=md5s.pop(i).result())
            run.parses[f.index] = r["parse"]
            for k in ("bad_frames", "bad_samples", "md5_bad", "info_bad"):
                sums[k] += r[k]
            sums["files_checked"] += 1
            failed += int(any(r[k] for k in ("bad_frames", "bad_samples",
                                             "md5_bad", "info_bad")))
        for fut in md5s.values():
            fut.cancel()
    return sums, failed
