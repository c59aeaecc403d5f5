"""`metaflac`-compatible CLI over flac_tpu_torch.metadata.

Port of flac_tpu/metaflac_cli.py, on the host: nothing here reaches the
GPU.  Covers the reference tool's primary surface
(src/metaflac/options.c:42-103): listing, streaminfo getters/setters, tag
import/export/edit, picture and cuesheet import/export, seekpoints,
padding ops.  --add-replay-gain decodes through the pure-Python reference
decoder.
"""

from __future__ import annotations

import argparse
import sys

from . import format as fmt
from . import metadata as md


# picture type names (format-mandated strings,
# FLAC__StreamMetadata_Picture_TypeString, format.c:185)
_PICTURE_TYPES = (
    "Other", "32x32 pixels 'file icon' (PNG only)", "Other file icon",
    "Cover (front)", "Cover (back)", "Leaflet page",
    "Media (e.g. label side of CD)", "Lead artist/lead performer/soloist",
    "Artist/performer", "Conductor", "Band/Orchestra", "Composer",
    "Lyricist/text writer", "Recording Location", "During recording",
    "During performance", "Movie/video screen capture",
    "A bright coloured fish", "Illustration", "Band/artist logotype",
    "Publisher/Studio logotype")


def _hexdump(buf: bytes, indent: str, out) -> None:
    """metaflac's 16-byte hexdump lines (utils.c:94): missing bytes in
    the final row print as 00 in the hex area and spaces in the chars."""
    for i in range(0, len(buf), 16):
        chunk = buf[i:i + 16]
        hexes = " ".join(
            f"{chunk[j]:02X}" if j < len(chunk) else "00"
            for j in range(16))
        chars = "".join(
            (chr(chunk[j]) if 32 <= chunk[j] < 127 else ".")
            if j < len(chunk) else " " for j in range(16))
        print(f"{indent}{i:08X}: {hexes} {chars}", file=out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="metaflac-tpu")
    p.add_argument("--list", action="store_true")
    p.add_argument("--block-number", type=str)
    p.add_argument("--block-type", type=str)
    p.add_argument("--except-block-type", type=str)
    p.add_argument("--show-md5sum", action="store_true")
    p.add_argument("--show-min-blocksize", action="store_true")
    p.add_argument("--show-max-blocksize", action="store_true")
    p.add_argument("--show-min-framesize", action="store_true")
    p.add_argument("--show-max-framesize", action="store_true")
    p.add_argument("--show-sample-rate", action="store_true")
    p.add_argument("--show-channels", action="store_true")
    p.add_argument("--show-bps", action="store_true")
    p.add_argument("--show-total-samples", action="store_true")
    p.add_argument("--show-vendor-tag", action="store_true")
    p.add_argument("--show-tag", action="append", default=[])
    p.add_argument("--show-all-tags", action="store_true")
    p.add_argument("--set-tag", action="append", default=[])
    p.add_argument("--set-tag-from-file", action="append", default=[])
    p.add_argument("--remove-tag", action="append", default=[])
    p.add_argument("--remove-first-tag", action="append", default=[])
    p.add_argument("--remove-all-tags-except", type=str,
                   help="'='-separated tag names to keep")
    p.add_argument("--remove-all-tags", action="store_true")
    p.add_argument("--export-tags-to")
    p.add_argument("--import-tags-from")
    p.add_argument("--import-picture-from")
    p.add_argument("--export-picture-to")
    p.add_argument("--import-cuesheet-from")
    p.add_argument("--export-cuesheet-to")
    p.add_argument("--add-replay-gain", action="store_true")
    p.add_argument("--scan-replay-gain", action="store_true")
    p.add_argument("--remove-replay-gain", action="store_true")
    p.add_argument("--add-seekpoint", action="append", default=[])
    p.add_argument("--add-padding", type=int)
    p.add_argument("--remove", action="store_true")
    p.add_argument("--remove-all", action="store_true")
    p.add_argument("--merge-padding", action="store_true")
    p.add_argument("--sort-padding", action="store_true")
    p.add_argument("--dont-use-padding", action="store_true",
                   help="always rewrite the file instead of resizing "
                        "padding in place")
    p.add_argument("--preserve-modtime", action="store_true",
                   help="keep the file's modification time across edits")
    p.add_argument("--no-cued-seekpoints", action="store_true",
                   help="with --import-cuesheet-from: do not add "
                        "seekpoints for track indices")
    p.add_argument("--with-filename", dest="with_filename",
                   action="store_true", default=None)
    p.add_argument("--no-filename", dest="with_filename",
                   action="store_false")
    p.add_argument("--append", action="store_true",
                   help="append binary metadata block(s) from stdin after "
                   "--block-number (operations.c:235-330)")
    p.add_argument("--data-format", choices=["text", "binary",
                                             "binary-headerless"],
                   default="text",
                   help="--list output form (options.c:101)")
    p.add_argument("--set-md5sum")
    p.add_argument("--set-min-blocksize", type=int)
    p.add_argument("--set-max-blocksize", type=int)
    p.add_argument("--set-min-framesize", type=int)
    p.add_argument("--set-max-framesize", type=int)
    p.add_argument("--set-sample-rate", type=int)
    p.add_argument("--set-channels", type=int)
    p.add_argument("--set-bps", type=int)
    p.add_argument("--set-total-samples", type=int)
    p.add_argument("files", nargs="+")
    return p


def _block_number_set(args) -> set[int] | None:
    if not args.block_number:
        return None
    try:
        return {int(x) for x in args.block_number.split(",")}
    except ValueError:
        raise SystemExit(f"bad --block-number: {args.block_number!r}")


_TYPE_NAMES = {
    fmt.METADATA_TYPE_STREAMINFO: "STREAMINFO",
    fmt.METADATA_TYPE_PADDING: "PADDING",
    fmt.METADATA_TYPE_APPLICATION: "APPLICATION",
    fmt.METADATA_TYPE_SEEKTABLE: "SEEKTABLE",
    fmt.METADATA_TYPE_VORBIS_COMMENT: "VORBIS_COMMENT",
    fmt.METADATA_TYPE_CUESHEET: "CUESHEET",
    fmt.METADATA_TYPE_PICTURE: "PICTURE",
}


def _type_filter(args):
    """--block-type / --except-block-type name sets (upper-cased)."""
    want = {t.strip().upper() for t in args.block_type.split(",")} \
        if getattr(args, "block_type", None) else None
    block = {t.strip().upper() for t in args.except_block_type.split(",")} \
        if getattr(args, "except_block_type", None) else None
    return want, block


def list_blocks(chain: md.Chain, out=None, only: set | None = None,
                data_format: str = "text",
                type_want: set | None = None,
                type_block: set | None = None) -> None:
    """Print the blocks metaflac --list prints; out=None prints to
    sys.stdout as it is at the call, so a caller can redirect it."""
    def skip(i, b):
        if only is not None and i not in only:
            return True
        name = _TYPE_NAMES.get(b.TYPE, "UNKNOWN")
        if type_want is not None and name not in type_want:
            return True
        return type_block is not None and name in type_block

    if data_format in ("binary", "binary-headerless"):
        raw = sys.stdout.buffer
        for i, b in enumerate(chain.blocks):
            if skip(i, b):
                continue
            body = b.to_bytes()
            if data_format == "binary":
                raw.write(md.block_header(
                    b.TYPE, len(body), i == len(chain.blocks) - 1))
            raw.write(body)
        raw.flush()
        return
    for i, b in enumerate(chain.blocks):
        if skip(i, b):
            continue
        body = b.to_bytes()
        name = _TYPE_NAMES.get(b.TYPE, "UNKNOWN")
        print(f"METADATA block #{i}", file=out)
        print(f"  type: {b.TYPE} ({name})", file=out)
        print(f"  is last: {'true' if i == len(chain.blocks)-1 else 'false'}",
              file=out)
        print(f"  length: {len(body)}", file=out)
        if isinstance(b, md.StreamInfoBlock):
            print(f"  minimum blocksize: {b.min_blocksize} samples", file=out)
            print(f"  maximum blocksize: {b.max_blocksize} samples", file=out)
            print(f"  minimum framesize: {b.min_framesize} bytes", file=out)
            print(f"  maximum framesize: {b.max_framesize} bytes", file=out)
            print(f"  sample_rate: {b.sample_rate} Hz", file=out)
            print(f"  channels: {b.channels}", file=out)
            print(f"  bits-per-sample: {b.bits_per_sample}", file=out)
            print(f"  total samples: {b.total_samples}", file=out)
            print(f"  MD5 signature: {b.md5.hex()}", file=out)
        elif isinstance(b, md.VorbisCommentBlock):
            print(f"  vendor string: {b.vendor}", file=out)
            print(f"  comments: {len(b.comments)}", file=out)
            for j, c in enumerate(b.comments):
                print(f"    comment[{j}]: {c}", file=out)
        elif isinstance(b, md.SeekTableBlock):
            print(f"  seek points: {len(b.points)}", file=out)
            for j, pt in enumerate(b.points):
                if pt.is_placeholder:
                    print(f"    point {j}: PLACEHOLDER", file=out)
                else:
                    print(f"    point {j}: sample_number={pt.sample_number}, "
                          f"stream_offset={pt.stream_offset}, "
                          f"frame_samples={pt.frame_samples}", file=out)
        elif isinstance(b, md.PictureBlock):
            tname = _PICTURE_TYPES[b.picture_type] \
                if 0 <= b.picture_type < len(_PICTURE_TYPES) else "UNDEFINED"
            print(f"  type: {b.picture_type} ({tname})", file=out)
            print(f"  MIME type: {b.mime_type}", file=out)
            print(f"  description: {b.description}", file=out)
            print(f"  width: {b.width}", file=out)
            print(f"  height: {b.height}", file=out)
            print(f"  depth: {b.depth}", file=out)
            print(f"  colors: {b.colors}"
                  f"{' (unindexed)' if b.colors == 0 else ''}", file=out)
            print(f"  data length: {len(b.data)}", file=out)
            print("  data:", file=out)
            _hexdump(b.data, "    ", out)


def _vc(chain: md.Chain, create=True) -> md.VorbisCommentBlock | None:
    vc = chain.get(fmt.METADATA_TYPE_VORBIS_COMMENT)
    if vc is None and create:
        vc = md.VorbisCommentBlock()
        chain.blocks.insert(1, vc)
    return vc


def replay_gain_ops(args, paths: list[str]) -> int:
    """Album-scoped ReplayGain (operations.c do_shorthand_operation__add_
    replay_gain): all files on the command line form one album; per-track
    gains/peaks plus a shared album gain/peak are written as tags."""
    from . import replaygain as rg
    from .ref_decoder import decode_stream

    first_si = md.get_streaminfo(paths[0])
    if not rg.valid_sample_rate(first_si.sample_rate):
        print(f"{paths[0]}: unsupported sample rate "
              f"{first_si.sample_rate} for ReplayGain", file=sys.stderr)
        return 1
    an = rg.GainAnalyzer(first_si.sample_rate)
    results = []
    for path in paths:
        si = md.get_streaminfo(path)
        if (si.sample_rate != first_si.sample_rate
                or si.channels != first_si.channels
                or si.bits_per_sample != first_si.bits_per_sample):
            print(f"{path}: stream parameters differ across the album",
                  file=sys.stderr)
            return 1
        st = decode_stream(open(path, "rb").read(), verify_md5=False)
        an.next_track()
        an.analyze_pcm(st.samples[:2], si.bits_per_sample)
        results.append((path, an.title_gain(), an.track_peak))
    album_gain = an.album_gain()
    album_peak = an.album_peak
    for path, gain, peak in results:
        if args.scan_replay_gain:
            print(f"{path}: track gain {gain:+.2f} dB, peak {peak:.8f}")
            continue
        chain = md.Chain.read_file(path)
        vc = chain.get(fmt.METADATA_TYPE_VORBIS_COMMENT)
        if vc is None:
            vc = md.VorbisCommentBlock()
            chain.blocks.insert(1, vc)
        vc.comments = [c for c in vc.comments
                       if not c.upper().startswith("REPLAYGAIN_")]
        for k, v in rg.format_tags(gain, peak, album_gain, album_peak):
            vc.comments.append(f"{k}={v}")
        chain.write_file(path)
    if args.scan_replay_gain and album_gain is not None:
        print(f"album gain {album_gain:+.2f} dB, peak {album_peak:.8f}")
    return 0


def process_file(args, path: str) -> int:
    chain = md.Chain.read_file(path)
    si = chain.streaminfo
    dirty = False

    for flag, val in (("show_md5sum", si.md5.hex()),
                      ("show_min_blocksize", si.min_blocksize),
                      ("show_max_blocksize", si.max_blocksize),
                      ("show_min_framesize", si.min_framesize),
                      ("show_max_framesize", si.max_framesize),
                      ("show_sample_rate", si.sample_rate),
                      ("show_channels", si.channels),
                      ("show_bps", si.bits_per_sample),
                      ("show_total_samples", si.total_samples)):
        if getattr(args, flag):
            print(val)
    if args.show_vendor_tag:
        vc = _vc(chain, create=False)
        print(vc.vendor if vc else "")
    for name in args.show_tag:
        vc = _vc(chain, create=False)
        if vc:
            for v in vc.get(name):
                print(f"{name}={v}")
    if args.show_all_tags:
        vc = _vc(chain, create=False)
        for c in (vc.comments if vc else []):
            print(c)
    for spec in args.set_tag:
        name, _, value = spec.partition("=")
        _vc(chain).set(name, value, replace_all=False)
        dirty = True
    for spec in args.set_tag_from_file:
        # NAME=FILENAME: the file's contents become the tag value
        # (vorbiscomment.c flac__vorbiscomment_add value_from_file path)
        name, sep, fname = spec.partition("=")
        if not sep or not fname:
            print(f"{path}: bad --set-tag-from-file (need NAME=FILE): "
                  f"{spec}", file=sys.stderr)
            return 1
        try:
            value = open(fname, "rb").read().decode("utf-8")
        except (OSError, UnicodeDecodeError) as e:
            print(f"{path}: --set-tag-from-file: {e}", file=sys.stderr)
            return 1
        if value.endswith("\n"):
            value = value[:-1]
        _vc(chain).set(name, value, replace_all=False)
        dirty = True
    for name in args.remove_tag:
        vc = _vc(chain, create=False)
        if vc and vc.remove(name):
            dirty = True
    for name in args.remove_first_tag:
        vc = _vc(chain, create=False)
        if vc:
            for j, c in enumerate(vc.comments):
                if c.upper().startswith(name.upper() + "="):
                    del vc.comments[j]
                    dirty = True
                    break
    if args.remove_all_tags_except is not None:
        keep = {n.strip().upper()
                for n in args.remove_all_tags_except.split("=") if n}
        vc = _vc(chain, create=False)
        if vc:
            kept = [c for c in vc.comments
                    if c.split("=", 1)[0].upper() in keep]
            if kept != vc.comments:
                vc.comments = kept
                dirty = True
    if args.remove_all_tags:
        vc = _vc(chain, create=False)
        if vc:
            vc.comments = []
            dirty = True
    if args.remove_replay_gain:
        vc = _vc(chain, create=False)
        if vc:
            kept = [c for c in vc.comments
                    if not c.upper().startswith("REPLAYGAIN_")]
            if len(kept) != len(vc.comments):
                vc.comments = kept
                dirty = True
    if args.export_tags_to:
        vc = _vc(chain, create=False)
        out = sys.stdout if args.export_tags_to == "-" else \
            open(args.export_tags_to, "w")
        for c in (vc.comments if vc else []):
            print(c, file=out)
        if out is not sys.stdout:
            out.close()
    if args.import_tags_from:
        src = sys.stdin if args.import_tags_from == "-" else \
            open(args.import_tags_from)
        vc = _vc(chain)
        for line in src:
            line = line.rstrip("\n")
            if line:
                vc.comments.append(line)
        dirty = True
    if args.import_picture_from:
        # SPEC: [TYPE]|[MIME]|[DESC]|[WxHxD[/COLORS]]|file or a file path
        chain.blocks.append(
            md.PictureBlock.from_specification(args.import_picture_from))
        dirty = True
    if args.export_picture_to:
        pic = chain.get(fmt.METADATA_TYPE_PICTURE)
        if pic is None:
            print(f"{path}: no PICTURE block", file=sys.stderr)
            return 1
        with open(args.export_picture_to, "wb") as f:
            f.write(pic.data)
    if args.import_cuesheet_from:
        from .cuesheet import CueSheetParseError, parse_cuesheet
        src = sys.stdin if args.import_cuesheet_from == "-" else \
            open(args.import_cuesheet_from)
        is_cdda = si.sample_rate == 44100    # CD-DA when plausible,
        # like metaflac's default (options.c: cuesheet import assumes CDDA
        # unless sample rate forbids it)
        try:
            cue = parse_cuesheet(src.read(), si.sample_rate, is_cdda,
                                 si.total_samples)
        except CueSheetParseError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 1
        finally:
            if src is not sys.stdin:
                src.close()
        chain.blocks = [b for b in chain.blocks
                        if b.TYPE != fmt.METADATA_TYPE_CUESHEET]
        chain.blocks.insert(1, cue)
        if not args.no_cued_seekpoints:
            # seekpoints at every track index offset (grabbag
            # seektable.c cued-seekpoints behavior)
            pts = sorted({t.offset + ix.offset for t in cue.tracks
                          for ix in (t.indices or [])
                          if t.number != 170})
            if pts:
                tbl = chain.get(fmt.METADATA_TYPE_SEEKTABLE)
                if tbl is None:
                    tbl = md.SeekTableBlock(points=[])
                    chain.blocks.insert(1, tbl)
                have = {p.sample_number for p in tbl.points}
                for sp in pts:
                    if sp not in have:
                        tbl.points.append(md.SeekPoint(sp, 0, 0))
                tbl.points.sort(key=lambda p: (
                    p.sample_number == 0xFFFFFFFFFFFFFFFF,
                    p.sample_number))
        dirty = True
    if args.export_cuesheet_to:
        from .cuesheet import emit_cuesheet
        cue = chain.get(fmt.METADATA_TYPE_CUESHEET)
        if cue is None:
            print(f"{path}: FLAC file has no CUESHEET block",
                  file=sys.stderr)
            return 1
        text = emit_cuesheet(cue, f'"{path}" FLAC')
        if args.export_cuesheet_to == "-":
            sys.stdout.write(text)
        else:
            with open(args.export_cuesheet_to, "w") as f:
                f.write(text)
    for spec in args.add_seekpoint:
        st = chain.get(fmt.METADATA_TYPE_SEEKTABLE)
        if st is None:
            st = md.SeekTableBlock()
            chain.blocks.insert(1, st)
        if spec.endswith("x"):
            tmpl = md.SeekTableBlock.template_count(int(spec[:-1]),
                                                    si.total_samples)
        elif spec.endswith("s"):
            tmpl = md.SeekTableBlock.template_spaced(
                si.total_samples, si.sample_rate, float(spec[:-1]))
        else:
            tmpl = md.SeekTableBlock(points=[
                md.SeekPoint(int(spec), 0, 0)])
        st.points.extend(tmpl.points)
        dirty = True
    if args.add_padding is not None:
        chain.blocks.append(md.PaddingBlock(args.add_padding))
        dirty = True
    if args.remove and (args.block_type or args.block_number
                        or args.except_block_type):
        wanted, blocked = _type_filter(args)
        numbers = _block_number_set(args)
        keep = []
        for i, b in enumerate(chain.blocks):
            name = _TYPE_NAMES.get(b.TYPE, "UNKNOWN")
            hit = ((wanted is not None and name in wanted)
                   or (numbers is not None and i in numbers)
                   or (blocked is not None and name not in blocked))
            if hit and name != "STREAMINFO":
                dirty = True
                continue
            keep.append(b)
        chain.blocks = keep
    if args.append:
        numbers = _block_number_set(args)
        if numbers is not None and len(numbers) > 1:
            print("ERROR: more than one block number specified with "
                  "--append", file=sys.stderr)
            return 1
        after = min(numbers) if numbers else len(chain.blocks) - 1
        insert_at = min(after + 1, len(chain.blocks))
        raw = sys.stdin.buffer.read()
        pos = 0
        has_vc = chain.get(fmt.METADATA_TYPE_VORBIS_COMMENT) is not None
        while pos + 4 <= len(raw):
            hdr = int.from_bytes(raw[pos:pos + 4], "big")
            btype = (hdr >> 24) & 0x7F
            length = hdr & 0xFFFFFF
            body = raw[pos + 4:pos + 4 + length]
            if len(body) != length:
                print(f"ERROR: couldn't read metadata block from stdin",
                      file=sys.stderr)
                return 1
            if btype == fmt.METADATA_TYPE_STREAMINFO:
                print("ERROR: can't add streaminfo to file",
                      file=sys.stderr)
                return 1
            if btype == fmt.METADATA_TYPE_SEEKTABLE:
                print("ERROR: can't add seektable to file, please use "
                      "--add-seekpoint instead", file=sys.stderr)
                return 1
            if btype == fmt.METADATA_TYPE_VORBIS_COMMENT and has_vc:
                print("ERROR: can't add another vorbis comment block to "
                      "file, it already has one", file=sys.stderr)
                return 1
            blk = md.parse_block(btype, body)
            if btype == fmt.METADATA_TYPE_VORBIS_COMMENT:
                has_vc = True
            chain.blocks.insert(insert_at, blk)
            insert_at += 1
            dirty = True
            pos += 4 + length
    si_sets = (("set_min_blocksize", "min_blocksize"),
               ("set_max_blocksize", "max_blocksize"),
               ("set_min_framesize", "min_framesize"),
               ("set_max_framesize", "max_framesize"),
               ("set_sample_rate", "sample_rate"),
               ("set_channels", "channels"),
               ("set_bps", "bits_per_sample"),
               ("set_total_samples", "total_samples"))
    for flag, attr in si_sets:
        v = getattr(args, flag)
        if v is not None:
            setattr(si, attr, v)
            dirty = True
    if args.set_md5sum is not None:
        try:
            si.md5 = bytes.fromhex(args.set_md5sum)
            assert len(si.md5) == 16
        except (ValueError, AssertionError):
            print(f"{path}: bad --set-md5sum (need 32 hex digits)",
                  file=sys.stderr)
            return 1
        dirty = True
    if args.remove_all:
        chain.blocks = [b for b in chain.blocks
                        if b.TYPE == fmt.METADATA_TYPE_STREAMINFO]
        dirty = True
    if args.merge_padding or args.sort_padding:
        chain.sort_padding()
        dirty = True

    if args.list:
        want, block = _type_filter(args)
        list_blocks(chain, only=_block_number_set(args),
                    data_format=args.data_format,
                    type_want=want, type_block=block)

    if dirty:
        import os
        mtime = os.stat(path) if args.preserve_modtime else None
        if args.dont_use_padding:
            # read the frames before the open truncates the file
            blob = chain._serialize(use_padding=False) + chain._load_frames()
            with open(path, "wb") as f:
                f.write(blob)
        else:
            chain.write_file(path)
        if mtime is not None:
            os.utime(path, (mtime.st_atime, mtime.st_mtime))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rc = 0
    if args.add_replay_gain or args.scan_replay_gain:
        rc |= replay_gain_ops(args, args.files)
    for path in args.files:
        rc |= process_file(args, path)
    return rc


if __name__ == "__main__":
    sys.exit(main())
