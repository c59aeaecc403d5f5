"""`flacjax` command-line tool — flag-compatible with the essential surface
of the reference `flac` CLI (src/flac/main.c): encode, decode, test,
analyze, presets -0..-8, blocksize/apodization/order overrides.

Port of flac_tpu/cli.py.  `python -m flac_tpu_torch.cli` encodes and
decodes on the GPU and raises without one; `main(argv, device="cpu")`
runs on the CPU.  -j N sets StreamEncoder's pipeline_depth to max(2, N),
as flac_tpu's does; the bytes do not depend on it.  -a (analyze) runs on
the host through the pure-Python reference decoder.
"""

from __future__ import annotations

import argparse
import io
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flacjax",
        description="FLAC encoder/decoder on a CUDA GPU (flac_tpu_torch)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-d", "--decode", action="store_true")
    mode.add_argument("-t", "--test", action="store_true",
                      help="decode and verify without writing output")
    mode.add_argument("-a", "--analyze", action="store_true",
                      help="dump per-frame/subframe analysis")
    for lvl in range(9):
        p.add_argument(f"-{lvl}", dest="preset", action="store_const",
                       const=lvl, help=argparse.SUPPRESS)
    p.set_defaults(preset=5)
    p.add_argument("--fast", dest="preset", action="store_const", const=0)
    p.add_argument("--best", dest="preset", action="store_const", const=8)
    p.add_argument("-o", "--output-name")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-s", "--silent", action="store_true")
    p.add_argument("-b", "--blocksize", type=int)
    p.add_argument("-l", "--max-lpc-order", type=int)
    p.add_argument("-m", "--mid-side", action="store_true", default=None)
    p.add_argument("-M", "--adaptive-mid-side", action="store_true",
                   default=None)
    p.add_argument("-r", "--rice-partition-order",
                   help="[min,]max residual partition order")
    p.add_argument("-A", "--apodization", action="append")
    p.add_argument("-q", "--qlp-coeff-precision", type=int)
    p.add_argument("-P", "--padding", type=int, default=4096)
    p.add_argument("-S", "--seekpoint", action="append", default=[],
                   help="seektable spec: {#|X|#x|#s} (main.c -S)")
    p.add_argument("--no-seektable", action="store_true",
                   help="do not write a SEEKTABLE (default is -S 10s)")
    p.add_argument("-T", "--tag", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="add a VORBIS_COMMENT tag while encoding")
    p.add_argument("--tag-from-file", action="append", default=[],
                   metavar="FIELD=FILENAME",
                   help="add a tag whose value is FILENAME's contents "
                        "(main.c:135)")
    p.add_argument("--no-utf8-convert", action="store_true",
                   help="do not charset-convert tag values; store the "
                        "raw bytes (main.c:204)")
    p.add_argument("--input-size", type=int, metavar="BYTES",
                   help="size of raw input when encoding from stdin "
                        "(main.c:182; only with --force-raw-format and "
                        "'-')")
    p.add_argument("--skip",
                   help="skip samples at start: '#' or 'mm:ss.ss'")
    p.add_argument("--until",
                   help="stop at sample: '#', '+#', '-#' or '[+|-]mm:ss.ss'")
    p.add_argument("--cuesheet", metavar="FILENAME",
                   help="(encode) import cuesheet as a CUESHEET block")
    p.add_argument("--cue", metavar="[#.#][-[#.#]]",
                   help="(decode) section to decode by cuesheet track/index "
                   "points, e.g. --cue=1.0-2.1")
    p.add_argument("--replay-gain", action="store_true",
                   help="(encode) compute and store ReplayGain tags")
    p.add_argument("-V", "--verify", action="store_true",
                   help="(encode) decode every frame while encoding and "
                   "compare sample-exactly against the input")
    p.add_argument("-F", "--decode-through-errors", action="store_true",
                   help="(decode) continue through stream errors: resync "
                   "on bad CRC, conceal lost frames with silence")
    p.add_argument("--ogg", action="store_true",
                   help="use Ogg as transport layer (Ogg FLAC)")
    p.add_argument("--serial-number", type=int, default=0x464C4143,
                   help="(--ogg) serial number of the Ogg stream")
    p.add_argument("--lax", action="store_true",
                   help="allow non-subset encodings")
    p.add_argument("--batch-frames", type=int, default=64,
                   help="frames per device batch")
    p.add_argument("-j", "--threads", type=int, default=None,
                   help="worker parallelism hint (reference -j; here it "
                   "scales the fetch/dispatch pipeline depth — frames "
                   "are always batch-parallel on device)")
    p.add_argument("-e", "--exhaustive-model-search", action="store_true",
                   help="evaluate every LPC order instead of the guess")
    p.add_argument("-p", "--qlp-coeff-precision-search", action="store_true",
                   help="search multiple qlp precisions per subframe")
    p.add_argument("--limit-min-bitrate", action="store_true",
                   help="keep the last subframe of all-constant frames "
                   "non-constant (stream_encoder.c:3874-3879)")
    p.add_argument("--apply-replaygain-which-is-not-lossless", nargs="?",
                   const="", default=None, metavar="SPEC",
                   help="(decode) apply ReplayGain: [preamp dB]"
                   "[a|t][l|L][n0-3] (main.c:767-790)")
    p.add_argument("--force-aiff-format", action="store_true")
    p.add_argument("--force-aiff-c-none-format", action="store_true")
    p.add_argument("--force-aiff-c-sowt-format", action="store_true")
    p.add_argument("--force-rf64-format", action="store_true")
    p.add_argument("--force-wave64-format", action="store_true")
    p.add_argument("--force-legacy-wave-format", action="store_true",
                   help="(decode) never use WAVEFORMATEXTENSIBLE")
    p.add_argument("--residual-text", action="store_true",
                   help="(-a) include residual signal in the analysis")
    p.add_argument("--residual-gnuplot", action="store_true",
                   help="(-a) write residual-distribution gnuplot files")
    p.add_argument("--keep-foreign-metadata", action="store_true",
                   help="store/restore non-audio container chunks in "
                   "APPLICATION blocks (foreign_metadata.c)")
    p.add_argument("--keep-foreign-metadata-if-present", action="store_true",
                   help="like --keep-foreign-metadata but silently skip "
                   "when the input has none")
    p.add_argument("--picture", action="append", default=[],
                   metavar="SPECIFICATION",
                   help="import picture into PICTURE block(s) "
                        "([TYPE]|MIME|[DESC]|[WxHxD[/COLORS]]|FILE)")
    p.add_argument("--ignore-chunk-sizes", action="store_true",
                   help="ignore data chunk sizes in WAVE/AIFF; read to EOF")
    p.add_argument("--delete-input-file", action="store_true",
                   help="delete the input file after a successful encode"
                        "/decode")
    p.add_argument("--preserve-modtime", dest="preserve_modtime",
                   action="store_true", default=True,
                   help="output files keep the input's timestamp (default)")
    p.add_argument("--no-preserve-modtime", dest="preserve_modtime",
                   action="store_false")
    p.add_argument("--force-raw-format", action="store_true")
    p.add_argument("--channels", type=int, help="(raw input) channel count")
    p.add_argument("--bps", type=int, help="(raw input) bits per sample")
    p.add_argument("--sample-rate", type=int, help="(raw input) sample rate")
    p.add_argument("--sign", choices=["signed", "unsigned"],
                   default="signed")
    p.add_argument("--endian", choices=["little", "big"], default="little")
    p.add_argument("files", nargs="+")
    return p


def make_config(args, info):
    from .config import EncoderConfig
    cfg = EncoderConfig.from_preset(
        args.preset, sample_rate=info.sample_rate, channels=info.channels,
        bits_per_sample=info.bits_per_sample)
    over = {}
    if args.blocksize is not None:
        over["blocksize"] = args.blocksize
    if args.max_lpc_order is not None:
        over["max_lpc_order"] = args.max_lpc_order
    if args.mid_side:
        over["do_mid_side"] = True
        over["loose_mid_side"] = False
    if args.adaptive_mid_side:
        over["do_mid_side"] = True
        over["loose_mid_side"] = True
    if args.rice_partition_order:
        parts = args.rice_partition_order.split(",")
        if len(parts) == 2:
            over["min_residual_partition_order"] = int(parts[0])
            over["max_residual_partition_order"] = int(parts[1])
        else:
            over["max_residual_partition_order"] = int(parts[0])
    if args.apodization:
        over["apodizations"] = tuple(args.apodization)
    if args.qlp_coeff_precision is not None:
        over["qlp_coeff_precision"] = args.qlp_coeff_precision
    if args.exhaustive_model_search:
        over["do_exhaustive_model_search"] = True
    if args.qlp_coeff_precision_search:
        over["do_qlp_coeff_prec_search"] = True
    if args.limit_min_bitrate:
        over["limit_min_bitrate"] = True
    if args.lax:
        over["streamable_subset"] = False
    import dataclasses
    return dataclasses.replace(cfg, **over).resolve()


def parse_time_spec(spec: str, sample_rate: int) -> tuple[int, int]:
    """'#' (samples) or '[mm:]ss.sss' (time) -> (samples, sign).

    Leading +/- marks a relative spec (reference --skip/--until grammar,
    src/flac/main.c utils.c:local__parse_timecode)."""
    sign = 0
    if spec and spec[0] in "+-":
        sign = 1 if spec[0] == "+" else -1
        spec = spec[1:]
    if ":" in spec or "." in spec:
        parts = spec.split(":")
        secs = float(parts[-1])
        if len(parts) == 2:
            secs += 60 * int(parts[0])
        n = int(round(secs * sample_rate))
    else:
        n = int(spec)
    return n, sign


def resolve_skip_until(args, sample_rate: int, total: int) -> tuple[int, int]:
    """Returns (start_sample, end_sample) within [0, total]."""
    start = 0
    if args.skip:
        start, _ = parse_time_spec(args.skip, sample_rate)
    end = total
    if args.until:
        n, sign = parse_time_spec(args.until, sample_rate)
        if sign > 0:
            end = start + n
        elif sign < 0:
            end = total - n
        else:
            end = n
    if not (0 <= start <= end <= total):
        raise SystemExit(f"--skip/--until out of range (stream has {total} "
                         "samples)")
    return start, end


def make_seektable(args, sample_rate: int, total_samples: int):
    """-S spec list -> SeekTableBlock template (grabbag/seektable.c)."""
    from . import metadata as md
    if args.no_seektable:
        return None
    specs = args.seekpoint or ["10s"]
    points = []
    for spec in specs:
        for one in spec.split(";"):
            one = one.strip()
            if not one:
                continue
            try:
                if one == "X":
                    points.append(md.SeekPoint(0xFFFFFFFFFFFFFFFF, 0, 0))
                elif one.endswith("x"):
                    points.extend(md.SeekTableBlock.template_count(
                        int(one[:-1]), total_samples).points)
                elif one.endswith("s"):
                    points.extend(md.SeekTableBlock.template_spaced(
                        total_samples, sample_rate, float(one[:-1])).points)
                else:
                    points.append(md.SeekPoint(int(one), 0, 0))
            except ValueError:
                raise SystemExit(
                    f"bad -S seekpoint spec: {one!r} (want #, X, #x or #s)")
    tbl = md.SeekTableBlock(points=points)
    if not points:
        return None
    return tbl


def _read_input(path: str, args, device):
    from . import container
    data = sys.stdin.buffer.read() if path == "-" else open(path, "rb").read()
    if getattr(args, "input_size", None):
        if not (path == "-" and args.force_raw_format):
            raise SystemExit(
                "--input-size only applies to raw input from stdin")
        data = data[:args.input_size]
    if args.force_raw_format:
        if not (args.channels and args.bps and args.sample_rate):
            raise SystemExit("raw input needs --channels --bps --sample-rate")
        return container.read_raw(
            data, sample_rate=args.sample_rate, channels=args.channels,
            bits_per_sample=args.bps, big_endian=args.endian == "big",
            signed=args.sign == "signed"), data
    if getattr(args, "ignore_chunk_sizes", False):
        if args.until or args.cue:
            raise SystemExit(
                "--ignore-chunk-sizes not allowed with --until/--cue")
        return container.sniff_and_read(data, True, device=device), data
    return container.sniff_and_read(data, device=device), data


def _finalize_files(args, in_path: str, out_name: str) -> None:
    """--preserve-modtime (default on) + --delete-input-file semantics
    after a successful conversion (main.c:1787,2047)."""
    import os
    if in_path == "-" or out_name == "-":
        return
    if args.preserve_modtime and os.path.exists(out_name) \
            and os.path.exists(in_path):
        s = os.stat(in_path)
        os.utime(out_name, (s.st_atime, s.st_mtime))
    if args.delete_input_file and os.path.exists(in_path):
        os.remove(in_path)


def do_encode(args, path: str, device=None) -> int:
    from .encoder import StreamEncoder
    info, raw_data = _read_input(path, args, device)
    cfg = make_config(args, info)
    samples = info.samples
    foreign_blocks = []
    if args.keep_foreign_metadata or args.keep_foreign_metadata_if_present:
        from . import foreign
        from . import format as fmt
        scanned = None
        try:
            scanned = foreign.scan_foreign(raw_data)
        except foreign.ForeignError as e:
            raise SystemExit(f"{path}: --keep-foreign-metadata: {e}")
        if scanned is None:
            if args.keep_foreign_metadata:
                raise SystemExit(
                    f"{path}: --keep-foreign-metadata requires WAV/RF64/"
                    "AIFF/Wave64 input")
        else:
            appid, blocks = scanned
            foreign_blocks = [(fmt.METADATA_TYPE_APPLICATION, appid + b)
                              for b in blocks]
    if args.skip or args.until:
        start, end = resolve_skip_until(args, info.sample_rate,
                                        samples.shape[1])
        samples = samples[:, start:end]
    out_name = args.output_name or (
        path.rsplit(".", 1)[0] + (".oga" if args.ogg else ".flac")
        if path != "-" else "-")
    t0 = time.time()
    # '-' output: stdout pipes are not seekable, so buffer the stream in
    # memory and flush once — keeping the STREAMINFO/seekpoint backpatch
    # (update_metadata_, stream_encoder.c:3139) intact for piped output
    to_stdout = out_name == "-"
    real_out = io.BytesIO() if to_stdout else open(out_name, "wb")
    if args.ogg:
        # streaming Ogg encode: pages go out as frame batches land
        # (ogg_encoder_aspect.c:113-230); peak RSS is independent of
        # input length
        from . import ogg
        out = ogg.OggFlacSink(real_out, serial=args.serial_number)
    else:
        out = real_out
    extra = []
    extra.extend(foreign_blocks)
    if info.metadata:
        # FLAC-to-FLAC re-encode preserves metadata blocks (encode.c:805)
        extra.extend(info.metadata)
    if args.cuesheet:
        from .cuesheet import CueSheetParseError, parse_cuesheet
        is_cdda = (info.sample_rate == 44100 and info.channels == 2
                   and info.bits_per_sample == 16)
        try:
            cue = parse_cuesheet(open(args.cuesheet).read(),
                                 info.sample_rate, is_cdda,
                                 samples.shape[1])
        except CueSheetParseError as e:
            raise SystemExit(f"{args.cuesheet}: {e}")
        extra.append((cue.TYPE, cue.to_bytes()))
    for spec in args.picture:
        from . import metadata as md
        try:
            pic = md.PictureBlock.from_specification(spec)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--picture: {e}")
        extra.append((pic.TYPE, pic.to_bytes()))
    if args.tag or args.tag_from_file or args.replay_gain:
        from . import metadata as md
        vc = md.VorbisCommentBlock()
        for t in args.tag:
            if "=" not in t:
                raise SystemExit(f"bad tag (need FIELD=VALUE): {t}")
            if getattr(args, "no_utf8_convert", False):
                # store the argv bytes verbatim (main.c:204 semantics):
                # argv round-trips through surrogateescape, undo it
                t = t.encode("utf-8", "surrogateescape") \
                    .decode("latin-1") if any(ord(c) > 0xFFFF or
                                              0xDC80 <= ord(c) <= 0xDCFF
                                              for c in t) else t
            vc.comments.append(t)
        for t in args.tag_from_file:
            if "=" not in t:
                raise SystemExit(
                    f"bad tag (need FIELD=FILENAME): {t}")
            field, fname = t.split("=", 1)
            try:
                val = open(fname, "rb").read().decode(
                    "utf-8", "replace").rstrip("\r\n")
            except OSError as e:
                raise SystemExit(f"can't read tag file {fname}: {e}")
            vc.comments.append(f"{field}={val}")
        if args.replay_gain:
            from . import replaygain as rg
            if not rg.valid_sample_rate(info.sample_rate):
                raise SystemExit(f"{path}: sample rate {info.sample_rate} "
                                 "unsupported for --replay-gain")
            an = rg.GainAnalyzer(info.sample_rate)
            an.analyze_pcm(samples[:2], info.bits_per_sample)
            gain = an.title_gain()
            for k, v in rg.format_tags(gain, an.track_peak,
                                       an.album_gain(), an.album_peak):
                vc.comments.append(f"{k}={v}")
        extra.append((vc.TYPE, vc.to_bytes()))
    seektable = make_seektable(args, info.sample_rate, samples.shape[1]) \
        if not to_stdout else None
    progress = None
    if not args.silent and not to_stdout:
        nb = (info.bits_per_sample + 7) // 8
        total = max(samples.shape[1], 1)

        def progress(frames_done, blocksize, bytes_written):
            # live print_stats analogue (src/flac/encode.c:2729)
            done = min(frames_done * blocksize, total)
            ratio = bytes_written / max(done * cfg.channels * nb, 1)
            print(f"\r{path}: {done * 100 // total}% complete, "
                  f"ratio={ratio:.3f}", end="", file=sys.stderr)
    enc_kw = {}
    if args.threads:
        enc_kw["pipeline_depth"] = max(2, args.threads)
    with StreamEncoder(out, cfg, batch_frames=args.batch_frames,
                       padding=args.padding, extra_metadata=extra,
                       seektable=seektable, verify=args.verify,
                       progress_callback=progress, device=device,
                       **enc_kw) as enc:
        enc.process(samples)
        st = enc.finish()
    if progress is not None:
        print(file=sys.stderr)
    if args.ogg:
        out.finalize()
    if to_stdout:
        sys.stdout.buffer.write(real_out.getvalue())
        sys.stdout.buffer.flush()
    else:
        size = real_out.tell()
        real_out.close()
        dt = time.time() - t0
        raw = samples.size * ((info.bits_per_sample + 7) // 8)
        if not args.silent:
            print(f"{path}: wrote {out_name} ratio={size/raw:.3f} "
                  f"({samples.shape[1]/info.sample_rate/dt:.1f}x "
                  f"realtime)", file=sys.stderr)
    _finalize_files(args, path, out_name)
    return 0


def resolve_cue_bounds(data: bytes, spec: str) -> tuple[int, int]:
    """--cue=[#.#][-[#.#]]: section bounds from the embedded CUESHEET
    (main.c --cue handling).  '#.#' is track.index; a missing index means
    the track's first index; missing endpoints mean stream start/end."""
    from . import format as fmt
    from . import metadata as md
    chain = md.Chain.read(data)
    cue = chain.get(fmt.METADATA_TYPE_CUESHEET)
    if cue is None:
        raise SystemExit("--cue requires a CUESHEET block in the input")
    lead_out = cue.tracks[-1].offset if cue.tracks else 0

    def point(part: str, default: int) -> int:
        if not part:
            return default
        tnum, _, inum = part.partition(".")
        for t in cue.tracks:
            if t.number == int(tnum):
                if inum == "":
                    return t.offset + (t.indices[0].offset if t.indices
                                       else 0)
                for ix in t.indices:
                    if ix.number == int(inum):
                        return t.offset + ix.offset
                raise SystemExit(f"--cue: track {tnum} has no index {inum}")
        raise SystemExit(f"--cue: no track number {tnum} in CUESHEET")

    a, dash, b = spec.partition("-")
    start = point(a, 0)
    end = point(b, lead_out) if dash else lead_out
    return start, end


def do_decode(args, path: str, device=None) -> int:
    from . import container
    from .decoder import decode_stream_auto
    data = sys.stdin.buffer.read() if path == "-" else open(path, "rb").read()
    t0 = time.time()
    from . import ogg
    if args.cue and not ogg.is_ogg(data):
        start, end = resolve_cue_bounds(data, args.cue)
        args.skip, args.until = str(start), str(end)
    if ogg.is_ogg(data):
        if args.skip or args.until or args.cue:
            # ranged decode through the Ogg seek path: only covering
            # frame packets are decoded (ogg_decoder_aspect.c seek)
            from .decoder import parse_metadata
            link = ogg.unwrap_ogg_flac(data)[0]
            if args.cue:
                start, end = resolve_cue_bounds(link.flac, args.cue)
                args.skip, args.until = str(start), str(end)
            st0, _ = parse_metadata(link.flac, 4)
            total = st0.total_samples or link.total_samples
            start, end = resolve_skip_until(args, st0.sample_rate, total)
            st = ogg.decode_ogg_flac_range(
                data, start, end - start,
                tolerant=args.decode_through_errors, device=device)
        else:
            st = ogg.decode_ogg_flac(data, device=device)
    elif args.skip or args.until:
        # ranged decode through the seek path — only covering frames
        # are decoded (FLAC__stream_decoder_seek_absolute analogue)
        from .seek import FlacReader
        rd = FlacReader(data, device=device)
        start, end = resolve_skip_until(args, rd.st.sample_rate,
                                        rd.total_samples)
        if start:
            rd.seek_absolute(start)
        pcm = rd.read_range(start, end - start)
        st = rd.st
        st.samples = pcm
    else:
        st = decode_stream_auto(data,
                                tolerant=args.decode_through_errors,
                                device=device)
        for err in getattr(st, "errors", []):
            print(f"{path}: WARNING, error {err[0]} at {err[1]} "
                  "(concealed)", file=sys.stderr)
    dt = time.time() - t0
    if args.test:
        if not args.silent:
            print(f"{path}: ok ({st.samples.shape[1]/st.sample_rate/dt:.1f}x"
                  " realtime)", file=sys.stderr)
        return 0
    if args.apply_replaygain_which_is_not_lossless is not None:
        st.samples = apply_replaygain_on_decode(
            data, st, args.apply_replaygain_which_is_not_lossless, path)
    if args.keep_foreign_metadata or args.keep_foreign_metadata_if_present:
        from . import foreign
        from .metadata import parse_metadata_blocks
        found = None
        if data[:4] == b"fLaC":
            found = foreign.extract_from_flac_metadata(
                parse_metadata_blocks(data))
        if found is None:
            if args.keep_foreign_metadata:
                raise SystemExit(f"{path}: --keep-foreign-metadata: input "
                                 "has no foreign metadata blocks")
        else:
            appid, blocks = found
            kind = foreign.foreign_kind(appid, blocks)
            payload = container._pcm_to_bytes(
                st.samples, st.bits_per_sample,
                big_endian=kind in ("aiff", "aiff-c-none"),
                unsigned8=kind in ("wav", "rf64", "w64"))
            restored = foreign.restore_foreign(appid, blocks, payload)
            out_name = args.output_name or (
                path.rsplit(".", 1)[0] + _DECODE_EXT.get(kind, ".wav"))
            if out_name == "-":
                sys.stdout.buffer.write(restored)
            else:
                open(out_name, "wb").write(restored)
            if not args.silent:
                print(f"{path}: done (foreign metadata restored)",
                      file=sys.stderr)
            _finalize_files(args, path, out_name)
            return 0
    fmt_name = decode_output_format(args)
    out_name = args.output_name or (
        path.rsplit(".", 1)[0] + _DECODE_EXT[fmt_name])
    payload = write_decoded(st, fmt_name, args)
    if out_name == "-":
        sys.stdout.buffer.write(payload)
    else:
        open(out_name, "wb").write(payload)
    if not args.silent:
        print(f"{path}: done", file=sys.stderr)
    _finalize_files(args, path, out_name)
    return 0


_DECODE_EXT = {"wav": ".wav", "rf64": ".rf64", "w64": ".w64",
               "aiff": ".aiff", "aiff-c-none": ".aifc",
               "aiff-c-sowt": ".aifc", "raw": ".raw"}


def decode_output_format(args) -> str:
    """Output container from --force-* flags, else the -o extension, else
    WAV (decode.c:121-132 format selection)."""
    flags = [("aiff", args.force_aiff_format),
             ("aiff-c-none", args.force_aiff_c_none_format),
             ("aiff-c-sowt", args.force_aiff_c_sowt_format),
             ("rf64", args.force_rf64_format),
             ("w64", args.force_wave64_format),
             ("raw", args.force_raw_format)]
    chosen = [n for n, v in flags if v]
    if len(chosen) > 1:
        raise SystemExit("only one --force-*-format may be given")
    if chosen:
        return chosen[0]
    ext = (args.output_name or "").rsplit(".", 1)[-1].lower() \
        if args.output_name and "." in args.output_name else ""
    return {"aif": "aiff", "aiff": "aiff", "aifc": "aiff-c-none",
            "rf64": "rf64", "w64": "w64", "raw": "raw",
            "pcm": "raw"}.get(ext, "wav")


def write_decoded(st, fmt_name: str, args) -> bytes:
    from . import container
    pcm, rate, bps = st.samples, st.sample_rate, st.bits_per_sample
    if fmt_name == "wav":
        if args.force_legacy_wave_format:
            ext = container._wav_needs_ext
            container_needs = ext(pcm.shape[0], bps)
            if container_needs:
                print("WARNING: --force-legacy-wave-format with >2 "
                      "channels or odd bps", file=sys.stderr)
        return container.write_wav(pcm, rate, bps)
    if fmt_name == "rf64":
        return container.write_rf64(pcm, rate, bps)
    if fmt_name == "w64":
        return container.write_w64(pcm, rate, bps)
    if fmt_name == "aiff":
        return container.write_aiff(pcm, rate, bps)
    if fmt_name == "aiff-c-none":
        return container.write_aiff(pcm, rate, bps, compression=b"NONE")
    if fmt_name == "aiff-c-sowt":
        return container.write_aiff(pcm, rate, bps, compression=b"sowt")
    if fmt_name == "raw":
        return container.write_raw(pcm, bps,
                                   big_endian=args.endian == "big",
                                   signed=args.sign == "signed")
    raise SystemExit(f"unknown output format {fmt_name}")


def apply_replaygain_on_decode(data: bytes, st, spec: str, path: str):
    """--apply-replaygain-which-is-not-lossless (decode.c + main.c:767-790
    + replaygain_synthesis.c): read gain/peak tags, build the scale, apply
    with optional peak/hard limiting and noise-shaped dither."""
    from . import format as fmt
    from . import metadata as md
    from . import replaygain as rg

    # defaults (main.c:605-609); an explicit spec resets limiter/shaping
    use_album, limiter, shaping, preamp = True, "hard", 1, 0.0
    if spec:
        i = 0
        while i < len(spec) and (spec[i].isdigit() or spec[i] in "+-."):
            i += 1
        if i:
            preamp = float(spec[:i])
        limiter, shaping = "none", 0
        j = i
        while j < len(spec):
            c = spec[j]
            if c == "a":
                use_album = True
            elif c == "t":
                use_album = False
            elif c == "l":
                limiter = "peak"
            elif c == "L":
                limiter = "hard"
            elif c == "n" and j + 1 < len(spec) and spec[j + 1] in "0123":
                shaping = int(spec[j + 1])
                j += 1
            else:
                raise SystemExit(
                    f"bad --apply-replaygain specification {spec!r}")
            j += 1
    try:
        chain = md.Chain.read(data)
        vc = chain.get(fmt.METADATA_TYPE_VORBIS_COMMENT)
    except Exception:
        vc = None
    tags = {}
    if vc is not None:
        for c in vc.comments:
            k, _, v = c.partition("=")
            tags[k.upper()] = v
    order = ["ALBUM", "TRACK"] if use_album else ["TRACK", "ALBUM"]
    gain = peak = None
    for which in order:
        g = rg.parse_gain_tag(tags.get(f"REPLAYGAIN_{which}_GAIN", ""))
        if g is not None:
            gain = g
            try:
                peak = float(tags.get(f"REPLAYGAIN_{which}_PEAK", "0"))
            except ValueError:
                peak = 0.0
            break
    if gain is None:
        print(f"{path}: WARNING, no ReplayGain tags found, not applying",
              file=sys.stderr)
        return st.samples
    scale = 10.0 ** ((gain + preamp) / 20.0)
    if limiter == "peak" and peak and scale * peak > 1.0:
        scale = 1.0 / peak
    dither = rg.DitherContext(st.bits_per_sample, shaping) \
        if shaping > 0 else None
    return rg.apply_gain(st.samples, st.bits_per_sample,
                         st.bits_per_sample, scale,
                         hard_limit=limiter == "hard", dither=dither)


def do_analyze(args, path: str) -> int:
    """`-a` analysis dump (src/flac/analyze.c): per-frame/subframe model
    decisions, warmup/coefficients/partition parameters, optional residual
    text and residual statistics files."""
    import numpy as np

    from .ref_decoder import decode_stream
    data = open(path, "rb").read()
    st = decode_stream(data, verify_md5=False)
    out = open(args.output_name, "w") if args.output_name else sys.stdout
    all_res = []
    for f in st.frames:
        print(f"frame={f['number']}\toffset={f['offset']}\tbits={f['size']*8}"
              f"\tblocksize={f['blocksize']}\tsample_rate={f['sample_rate']}"
              f"\tchannels={len(f['subframes'])}"
              f"\tchannel_assignment={f['assignment']}", file=out)
        for c, s in enumerate(f["subframes"]):
            line = (f"\tsubframe={c}\twasted_bits={s['wasted']}"
                    f"\ttype={s['type']}")
            if s["type"] == "CONSTANT":
                line += f"\tvalue={s['value']}"
            if s["type"] in ("FIXED", "LPC"):
                rtype = "RICE2" if s.get("method") else "RICE"
                line += f"\torder={s['order']}"
                if s["type"] == "LPC":
                    line += (f"\tqlp_coeff_precision={s['precision']}"
                             f"\tquantization_level={s['shift']}")
                line += (f"\tresidual_type={rtype}"
                         f"\tpartition_order={s['partition_order']}")
            print(line, file=out)
            if s["type"] == "LPC":
                for i, q in enumerate(s["qlp"]):
                    print(f"\t\tqlp_coeff[{i}]={q}", file=out)
            if s["type"] in ("FIXED", "LPC"):
                for i, w in enumerate(s["warmup"]):
                    print(f"\t\twarmup[{i}]={w}", file=out)
                for i, k in enumerate(s["params"]):
                    if isinstance(k, tuple):
                        print(f"\t\tparameter[{i}]=ESCAPE, raw_bits={k[1]}",
                              file=out)
                    else:
                        print(f"\t\tparameter[{i}]={k}", file=out)
                res = np.asarray(s["residual"])
                if args.residual_text:
                    for i, r in enumerate(res):
                        print(f"\t\tresidual[{i}]={int(r)}", file=out)
                if args.residual_gnuplot:
                    all_res.append(res)
                    _dump_residual_stats(res, f"f{f['number']:06d}.s{c}.gp")
    if args.residual_gnuplot and all_res:
        _dump_residual_stats(np.concatenate(all_res), "all")
    return 0


def _dump_residual_stats(res, filename: str) -> None:
    """Residual statistics + gnuplot data (analyze.c init/update/compute/
    dump_stats): histogram of residual values with mean/stddev header."""
    import numpy as np
    res = np.asarray(res, np.float64)
    n = max(len(res), 1)
    mean = res.sum() / n
    variance = (res * res).sum() / n - mean * mean
    stddev = float(np.sqrt(max(variance, 0.0)))
    vals, counts = (np.unique(res.astype(np.int64), return_counts=True)
                    if len(res) else (np.array([], np.int64),
                                      np.array([], np.int64)))
    with open(filename, "w") as f:
        f.write("plot '-' title "
                f"'{filename}: mean={mean:f} stddev={stddev:f}' "
                "with impulses\n")
        for v, cnt in zip(vals, counts):
            f.write(f"{int(v)} {int(cnt)}\n")
        f.write("e\n")


def main(argv=None, *, device=None) -> int:
    """Run the tool on argv (sys.argv[1:] when None).  device: None means
    "cuda" (raises without a GPU); "cpu" runs every path on the CPU."""
    args = build_parser().parse_args(argv)
    rc = 0
    for path in args.files:
        if args.analyze:
            rc |= do_analyze(args, path)
        elif args.decode or args.test:
            rc |= do_decode(args, path, device)
        else:
            rc |= do_encode(args, path, device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
