"""Cuesheet text <-> CUESHEET metadata block conversion.

Port of flac_tpu/cuesheet.py, over this package's metadata.CueSheetBlock.
Capability port of src/share/grabbag/cuesheet.c (682 LoC): the CDRDAO-style
.cue mini-language (CATALOG / FILE / FLAGS / INDEX / ISRC / TRACK / REM),
CD-DA validation rules, the REM FLAC__lead-in/lead-out extension, and the
emitter used by `metaflac --export-cuesheet-to`.  Semantics (error strings,
ordering rules, offset storage as track-relative index offsets, the forced
lead-out track) follow the reference one-for-one so round-trips through the
reference tools are byte-compatible.
"""

from __future__ import annotations

from .metadata import CueSheetBlock, CueSheetTrack, CueSheetTrackIndex

CDDA_LEAD_IN = 2 * 44100          # default CD-DA lead-in (cuesheet.c:283)


class CueSheetParseError(ValueError):
    def __init__(self, line_number: int, message: str):
        super().__init__(f"cuesheet line {line_number}: {message}")
        self.line_number = line_number
        self.reason = message


def _get_field(line: str, allow_quotes: bool):
    """local__get_field_ (cuesheet.c:220-264): whitespace-delimited token,
    optionally double-quoted (no escapes)."""
    line = line.lstrip(" \t\r\n")
    if not line:
        return None, ""
    if allow_quotes and line[0] == '"':
        end = line.find('"', 1)
        if end < 0:
            return None, None      # unterminated quote -> error sentinel
        return line[1:end], line[end + 1:]
    for i, ch in enumerate(line):
        if ch in " \t\r\n":
            return line[:i], line[i + 1:]
    return line, ""


def _parse_int(s: str) -> int:
    """Non-negative decimal or -1 (local__parse_int64_)."""
    if not s or not s.isdigit():
        return -1
    return int(s)


def _parse_msf(s: str, sample_rate: int) -> int:
    """'[0-9]+:[0-9][0-9]?:[0-9][0-9]?' (sec<60, frame<75) -> samples,
    or -1 (local__parse_msf_, cuesheet.c:79-135)."""
    parts = s.split(":")
    if len(parts) != 3 or not all(p.isdigit() and p for p in parts):
        return -1
    m, sec, f = (int(p) for p in parts)
    if len(parts[1]) > 2 or len(parts[2]) > 2 or sec > 59 or f > 74:
        return -1
    return (m * 60 + sec) * sample_rate + f * (sample_rate // 75)


def _parse_ms(s: str, sample_rate: int) -> int:
    """'MM:SS.SS' (fractional seconds) -> samples, or -1
    (local__parse_ms_, cuesheet.c:137-218)."""
    parts = s.split(":")
    if len(parts) != 2 or not parts[0].isdigit():
        return -1
    sec_part = parts[1]
    if "." in sec_part:
        whole, _, frac = sec_part.partition(".")
        if not (whole.isdigit() and (frac == "" or frac.isdigit())):
            return -1
        sec = float(sec_part)
    elif sec_part.isdigit():
        sec = float(sec_part)
    else:
        return -1
    if sec >= 60:
        return -1
    return round((int(parts[0]) * 60 + sec) * sample_rate)


def parse_cuesheet(text: str, sample_rate: int, is_cdda: bool,
                   lead_out_offset: int) -> CueSheetBlock:
    """grabbag__cuesheet_parse: text -> CUESHEET block.

    lead_out_offset: total stream samples (used for the forced lead-out
    track when the cuesheet has no REM FLAC__lead-out).
    Raises CueSheetParseError with the reference's error strings.
    """
    if is_cdda and sample_rate != 44100:
        raise CueSheetParseError(
            0, "CD-DA cuesheet only allowed with 44.1kHz sample rate")

    cs = CueSheetBlock(lead_in=CDDA_LEAD_IN if is_cdda else 0,
                       is_cd=is_cdda)
    disc_has_catalog = False
    track_has_flags = track_has_isrc = False
    in_track_num = in_index_num = -1
    has_forced_leadout = False
    forced_leadout = (0, 0)

    def check_last_track(ln):
        prev = cs.tracks[-1]
        bad = (not prev.indices
               or (is_cdda
                   and ((len(prev.indices) == 1
                         and prev.indices[0].number != 1)
                        or (len(prev.indices) == 2
                            and prev.indices[0].number != 1
                            and prev.indices[1].number != 1))))
        if bad:
            raise CueSheetParseError(
                ln, "previous TRACK must specify at least one INDEX 01"
                if is_cdda else
                "previous TRACK must specify at least one INDEX")

    for ln, raw in enumerate(text.splitlines(), start=1):
        field, rest = _get_field(raw, allow_quotes=False)
        if field is None:
            continue
        cmd = field.upper()

        if cmd == "CATALOG":
            if disc_has_catalog:
                raise CueSheetParseError(ln,
                                         "found multiple CATALOG commands")
            field, rest = _get_field(rest, allow_quotes=True)
            if field is None:
                raise CueSheetParseError(
                    ln, "CATALOG is missing catalog number")
            if len(field) >= 128:
                raise CueSheetParseError(ln, "CATALOG number is too long")
            if is_cdda and (len(field) != 13 or not field.isdigit()):
                raise CueSheetParseError(
                    ln, "CD-DA CATALOG number must be 13 decimal digits")
            cs.media_catalog_number = field.encode().ljust(128, b"\x00")
            disc_has_catalog = True

        elif cmd == "FLAGS":
            if track_has_flags:
                raise CueSheetParseError(ln, "found multiple FLAGS commands")
            if in_track_num < 0 or in_index_num >= 0:
                raise CueSheetParseError(
                    ln, "FLAGS command must come after TRACK but before "
                    "INDEX")
            while True:
                field, rest = _get_field(rest, allow_quotes=False)
                if field is None:
                    break
                if field.upper() == "PRE":
                    cs.tracks[-1].pre_emphasis = True
            track_has_flags = True

        elif cmd == "INDEX":
            if in_track_num < 0:
                raise CueSheetParseError(ln, "found INDEX before any TRACK")
            field, rest = _get_field(rest, allow_quotes=False)
            if field is None:
                raise CueSheetParseError(ln, "INDEX is missing index number")
            in_index_num = _parse_int(field)
            if in_index_num < 0:
                raise CueSheetParseError(ln, "INDEX has invalid index number")
            track = cs.tracks[-1]
            if not track.indices:
                if in_index_num > 1:
                    raise CueSheetParseError(
                        ln, "first INDEX number of a TRACK must be 0 or 1")
            elif in_index_num != track.indices[-1].number + 1:
                raise CueSheetParseError(ln,
                                         "INDEX numbers must be sequential")
            if is_cdda and in_index_num > 99:
                raise CueSheetParseError(
                    ln, "CD-DA INDEX number must be between 0 and 99, "
                    "inclusive")
            field, rest = _get_field(rest, allow_quotes=False)
            if field is None:
                raise CueSheetParseError(
                    ln, "INDEX is missing an offset after the index number")
            xx = _parse_msf(field, sample_rate)
            if xx < 0:
                if is_cdda:
                    raise CueSheetParseError(
                        ln, "illegal INDEX offset (not of the form MM:SS:FF)")
                xx = _parse_ms(field, sample_rate)
                if xx < 0:
                    xx = _parse_int(field)
                    if xx < 0:
                        raise CueSheetParseError(ln, "illegal INDEX offset")
            elif sample_rate % 75 and xx:
                raise CueSheetParseError(
                    ln, "illegal INDEX offset (MM:SS:FF form not allowed if "
                    "sample rate is not a multiple of 75)")
            if (is_cdda and len(cs.tracks) == 1 and not track.indices
                    and xx != 0):
                raise CueSheetParseError(
                    ln, "first INDEX of first TRACK must have an offset of "
                    "00:00:00")
            if (is_cdda and track.indices
                    and xx <= track.offset + track.indices[-1].offset):
                raise CueSheetParseError(
                    ln, "CD-DA INDEX offsets must increase in time")
            if not track.indices:
                track.offset = xx
            if is_cdda and len(cs.tracks) > 1:
                prev = cs.tracks[-2]
                if xx <= prev.offset + prev.indices[-1].offset:
                    raise CueSheetParseError(
                        ln, "CD-DA INDEX offsets must increase in time")
            track.indices.append(
                CueSheetTrackIndex(xx - track.offset, in_index_num))

        elif cmd == "ISRC":
            if track_has_isrc:
                raise CueSheetParseError(ln, "found multiple ISRC commands")
            if in_track_num < 0 or in_index_num >= 0:
                raise CueSheetParseError(
                    ln, "ISRC command must come after TRACK but before INDEX")
            field, rest = _get_field(rest, allow_quotes=False)
            if field is None:
                raise CueSheetParseError(ln, "ISRC is missing ISRC number")
            isrc = field.replace("-", "").upper()
            ok = (len(isrc) == 12
                  and all(c.isalnum() and (c.isdigit() or c.isupper())
                          for c in isrc[:5])
                  and isrc[5:].isdigit())
            if not ok:
                raise CueSheetParseError(ln, "invalid ISRC number")
            cs.tracks[-1].isrc = isrc.encode()
            track_has_isrc = True

        elif cmd == "TRACK":
            if cs.tracks:
                check_last_track(ln)
            field, rest = _get_field(rest, allow_quotes=False)
            if field is None:
                raise CueSheetParseError(ln, "TRACK is missing track number")
            in_track_num = _parse_int(field)
            if in_track_num < 0:
                raise CueSheetParseError(ln, "TRACK has invalid track number")
            if in_track_num == 0:
                raise CueSheetParseError(
                    ln, "TRACK number must be greater than 0")
            if is_cdda:
                if in_track_num > 99:
                    raise CueSheetParseError(
                        ln, "CD-DA TRACK number must be between 1 and 99, "
                        "inclusive")
            elif in_track_num == 255:
                raise CueSheetParseError(
                    ln, "TRACK number 255 is reserved for the lead-out")
            elif in_track_num > 255:
                raise CueSheetParseError(
                    ln, "TRACK number must be between 1 and 254, inclusive")
            if (is_cdda and cs.tracks
                    and in_track_num != cs.tracks[-1].number + 1):
                raise CueSheetParseError(
                    ln, "CD-DA TRACK numbers must be sequential")
            field, rest = _get_field(rest, allow_quotes=False)
            if field is None:
                raise CueSheetParseError(
                    ln, "TRACK is missing a track type after the track "
                    "number")
            cs.tracks.append(CueSheetTrack(
                number=in_track_num,
                is_audio=field.upper() == "AUDIO", indices=[]))
            in_index_num = -1
            track_has_flags = track_has_isrc = False

        elif cmd == "REM":
            field, rest = _get_field(rest, allow_quotes=False)
            if field == "FLAC__lead-in":
                field, rest = _get_field(rest, allow_quotes=False)
                if field is None:
                    raise CueSheetParseError(
                        ln, "FLAC__lead-in is missing offset")
                xx = _parse_int(field)
                if xx < 0:
                    raise CueSheetParseError(
                        ln, "illegal FLAC__lead-in offset")
                if is_cdda and xx % 588:
                    raise CueSheetParseError(
                        ln, "illegal CD-DA FLAC__lead-in offset, must be "
                        "even multiple of 588 samples")
                cs.lead_in = xx
            elif field == "FLAC__lead-out":
                if has_forced_leadout:
                    raise CueSheetParseError(
                        ln, "multiple FLAC__lead-out commands")
                field, rest = _get_field(rest, allow_quotes=False)
                if field is None:
                    raise CueSheetParseError(
                        ln, "FLAC__lead-out is missing track number")
                tn = _parse_int(field)
                if tn < 0:
                    raise CueSheetParseError(
                        ln, "illegal FLAC__lead-out track number")
                field, rest = _get_field(rest, allow_quotes=False)
                if field is None:
                    raise CueSheetParseError(
                        ln, "FLAC__lead-out is missing offset")
                xx = _parse_int(field)
                if xx < 0:
                    raise CueSheetParseError(
                        ln, "illegal FLAC__lead-out offset")
                forced_leadout = (tn, xx)
                has_forced_leadout = True
        # FILE / PERFORMER / TITLE / etc. are ignored, like the reference

    if not cs.tracks:
        raise CueSheetParseError(0, "there must be at least one TRACK "
                                 "command")
    check_last_track(0)

    if not has_forced_leadout:
        forced_leadout = (170 if is_cdda else 255, lead_out_offset)
    cs.tracks.append(CueSheetTrack(
        offset=forced_leadout[1], number=forced_leadout[0], indices=[]))
    return cs


def _frame_to_msf(frame: int):
    return frame // (75 * 60), (frame // 75) % 60, frame % 75


def emit_cuesheet(cs: CueSheetBlock, file_reference: str) -> str:
    """grabbag__cuesheet_emit: CUESHEET block -> .cue text."""
    out = []
    mcn = cs.media_catalog_number.rstrip(b"\x00").decode(
        "ascii", "replace")
    if mcn:
        out.append(f"CATALOG {mcn}")
    out.append(f"FILE {file_reference}")
    for track in cs.tracks[:-1]:
        out.append(f"  TRACK {track.number:02d} "
                   f"{'AUDIO' if track.is_audio else 'DATA'}")
        if track.pre_emphasis:
            out.append("    FLAGS PRE")
        isrc = track.isrc.rstrip(b"\x00").decode("ascii", "replace")
        if isrc:
            out.append(f"    ISRC {isrc}")
        for idx in track.indices:
            if cs.is_cd:
                m, s, f = _frame_to_msf(
                    (track.offset + idx.offset) // (44100 // 75))
                out.append(f"    INDEX {idx.number:02d} "
                           f"{m:02d}:{s:02d}:{f:02d}")
            else:
                out.append(f"    INDEX {idx.number:02d} "
                           f"{track.offset + idx.offset}")
    lead = cs.tracks[-1]
    out.append(f"REM FLAC__lead-in {cs.lead_in}")
    out.append(f"REM FLAC__lead-out {lead.number} {lead.offset}")
    return "\n".join(out) + "\n"
