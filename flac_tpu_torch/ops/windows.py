"""Apodization window families and the `-A` specification mini-language.

TPU-native counterpart of src/libFLAC/window.c:50-292 (the 15 window
families) and FLAC__stream_encoder_set_apodization
(stream_encoder.c:1940-2065, the spec parser).  Windows are precomputed
host-side numpy tensors; the encoder consumes them as a [W, N] bank whose
per-candidate autocorrelations are combined by a [A, W] matrix (identity
rows for plain windows; +1/-1 rows to express subdivide_tukey punchouts as
autocorrelation subtraction, mirroring apply_apodization_,
stream_encoder.c:4293-4391).

All formulas follow window.c; trig is evaluated in float64 and cast to
float32 (the reference uses cosf — sub-ulp differences are absorbed by
coefficient quantization and never affect correctness, only ±0.01% size).
"""

from __future__ import annotations

import numpy as np

from ..format import MAX_LPC_ORDER

MAX_APODIZATIONS = 32          # stream_encoder.c:2056


# ---------------------------------------------------------------------------
# Window families (window.c:50-292)
# ---------------------------------------------------------------------------

def bartlett(L: int) -> np.ndarray:
    """window.c:50-67."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    half = N // 2 if (L & 1) else L // 2 - 1
    w = np.where(n <= half, 2.0 * n / N, 2.0 - 2.0 * n / N)
    return w.astype(np.float32)


def bartlett_hann(L: int) -> np.ndarray:
    """window.c:69-76."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.62 - 0.48 * np.abs(n / N - 0.5)
            - 0.38 * np.cos(2 * np.pi * n / N)).astype(np.float32)


def blackman(L: int) -> np.ndarray:
    """window.c:78-85."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.42 - 0.5 * np.cos(2 * np.pi * n / N)
            + 0.08 * np.cos(4 * np.pi * n / N)).astype(np.float32)


def blackman_harris_4term_92db(L: int) -> np.ndarray:
    """window.c:87-95 (4-term -92dB sidelobe)."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.35875 - 0.48829 * np.cos(2 * np.pi * n / N)
            + 0.14128 * np.cos(4 * np.pi * n / N)
            - 0.01168 * np.cos(6 * np.pi * n / N)).astype(np.float32)


def connes(L: int) -> np.ndarray:
    """window.c:97-108."""
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / N2
    k = 1.0 - k * k
    return (k * k).astype(np.float32)


def flattop(L: int) -> np.ndarray:
    """window.c:110-117 (normalised flattop)."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.21557895 - 0.41663158 * np.cos(2 * np.pi * n / N)
            + 0.277263158 * np.cos(4 * np.pi * n / N)
            - 0.083578947 * np.cos(6 * np.pi * n / N)
            + 0.006947368 * np.cos(8 * np.pi * n / N)).astype(np.float32)


def gauss(L: int, stddev: float) -> np.ndarray:
    """window.c:119-137; out-of-range stddev falls back to 0.25."""
    if not (stddev > 0.0 and stddev <= 0.5):
        stddev = 0.25
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / (stddev * N2)
    return np.exp(-0.5 * k * k).astype(np.float32)


def hamming(L: int) -> np.ndarray:
    """window.c:139-146."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2 * np.pi * n / N)).astype(np.float32)


def hann(L: int) -> np.ndarray:
    """window.c:148-155."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / N)).astype(np.float32)


def kaiser_bessel(L: int) -> np.ndarray:
    """window.c:157-164."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.402 - 0.498 * np.cos(2 * np.pi * n / N)
            + 0.098 * np.cos(4 * np.pi * n / N)
            - 0.001 * np.cos(6 * np.pi * n / N)).astype(np.float32)


def nuttall(L: int) -> np.ndarray:
    """window.c:166-173."""
    N = L - 1
    n = np.arange(L, dtype=np.float64)
    return (0.3635819 - 0.4891775 * np.cos(2 * np.pi * n / N)
            + 0.1365995 * np.cos(4 * np.pi * n / N)
            - 0.0106411 * np.cos(6 * np.pi * n / N)).astype(np.float32)


def rectangle(L: int) -> np.ndarray:
    """window.c:175-181."""
    return np.ones(L, dtype=np.float32)


def triangle(L: int) -> np.ndarray:
    """window.c:183-199."""
    n = np.arange(1, L + 1, dtype=np.float64)
    half = (L + 1) // 2 if (L & 1) else L // 2
    w = np.where(n <= half, 2.0 * n / (L + 1.0),
                 2.0 * (L - n + 1) / (L + 1.0))
    return w.astype(np.float32)


def tukey(L: int, p: float) -> np.ndarray:
    """window.c:201-223 (p<=0 -> rectangle, p>=1 -> hann, NaN -> 0.5)."""
    if p <= 0.0:
        return rectangle(L)
    if p >= 1.0:
        return hann(L)
    if not (0.0 < p < 1.0):          # NaN
        p = 0.5
    Np = int(np.float32(p) / 2.0 * L) - 1
    w = np.ones(L, dtype=np.float64)
    if Np > 0:
        n = np.arange(Np + 1, dtype=np.float64)
        w[:Np + 1] = 0.5 - 0.5 * np.cos(np.pi * n / Np)
        w[L - Np - 1:] = 0.5 - 0.5 * np.cos(np.pi * (n + Np) / Np)
    return w.astype(np.float32)


def partial_tukey(L: int, p: float, start: float, end: float) -> np.ndarray:
    """window.c:225-257: tukey over [start*L, end*L), zero elsewhere."""
    if p <= 0.0:
        p = 0.05
    elif p >= 1.0:
        p = 0.95
    elif not (0.0 < p < 1.0):
        p = 0.5
    start_n = int(start * L)
    end_n = int(end * L)
    N = end_n - start_n
    Np = int(np.float32(p) / 2.0 * N)
    w = np.zeros(L, dtype=np.float64)
    n = np.arange(L, dtype=np.float64)
    if Np > 0:
        rise = (n >= start_n) & (n < start_n + Np)
        w = np.where(rise, 0.5 - 0.5 * np.cos(np.pi * (n - start_n + 1) / Np),
                     w)
        flat = (n >= start_n + Np) & (n < end_n - Np)
        w = np.where(flat, 1.0, w)
        fall = (n >= end_n - Np) & (n < end_n)
        w = np.where(fall, 0.5 - 0.5 * np.cos(np.pi * (end_n - n) / Np), w)
    else:
        w = np.where((n >= start_n) & (n < end_n), 1.0, w)
    return w.astype(np.float32)


def punchout_tukey(L: int, p: float, start: float, end: float) -> np.ndarray:
    """window.c:259-292: tukey everywhere EXCEPT [start*L, end*L)."""
    if p <= 0.0:
        p = 0.05
    elif p >= 1.0:
        p = 0.95
    elif not (0.0 < p < 1.0):
        p = 0.5
    start_n = int(start * L)
    end_n = int(end * L)
    Ns = int(np.float32(p) / 2.0 * start_n)
    Ne = int(np.float32(p) / 2.0 * (L - end_n))
    w = np.zeros(L, dtype=np.float64)
    n = np.arange(L, dtype=np.float64)
    # leading lobe [0, start_n)
    if Ns > 0:
        w = np.where(n < Ns, 0.5 - 0.5 * np.cos(np.pi * (n + 1) / Ns), w)
        w = np.where((n >= Ns) & (n < start_n - Ns), 1.0, w)
        w = np.where((n >= start_n - Ns) & (n < start_n),
                     0.5 - 0.5 * np.cos(np.pi * (start_n - n) / Ns), w)
    else:
        w = np.where(n < start_n, 1.0, w)
    # trailing lobe [end_n, L)
    if Ne > 0:
        w = np.where((n >= end_n) & (n < end_n + Ne),
                     0.5 - 0.5 * np.cos(np.pi * (n - end_n + 1) / Ne), w)
        w = np.where((n >= end_n + Ne) & (n < L - Ne), 1.0, w)
        w = np.where(n >= L - Ne,
                     0.5 - 0.5 * np.cos(np.pi * (L - n) / Ne), w)
    else:
        w = np.where(n >= end_n, 1.0, w)
    return w.astype(np.float32)


def welch(L: int) -> np.ndarray:
    """window.c:294-304."""
    N = L - 1
    N2 = N / 2.0
    k = (np.arange(L, dtype=np.float64) - N2) / N2
    return (1.0 - k * k).astype(np.float32)


_SIMPLE = {
    "bartlett": bartlett,
    "bartlett_hann": bartlett_hann,
    "blackman": blackman,
    "blackman_harris_4term_92db": blackman_harris_4term_92db,
    "connes": connes,
    "flattop": flattop,
    "hamming": hamming,
    "hann": hann,
    "kaiser_bessel": kaiser_bessel,
    "nuttall": nuttall,
    "rectangle": rectangle,
    "triangle": triangle,
    "welch": welch,
}


# ---------------------------------------------------------------------------
# Specification mini-language (stream_encoder.c:1940-2065)
# ---------------------------------------------------------------------------

def _strtod(s: str) -> float:
    """C strtod prefix-parse: longest valid float prefix, else 0."""
    i, n = 0, len(s)
    while i < n and s[i].isspace():
        i += 1
    j = i
    if j < n and s[j] in "+-":
        j += 1
    seen = False
    while j < n and (s[j].isdigit() or s[j] == "."):
        seen = seen or s[j].isdigit()
        j += 1
    if j < n and seen and s[j] in "eE":
        k = j + 1
        if k < n and s[k] in "+-":
            k += 1
        if k < n and s[k].isdigit():
            while k < n and s[k].isdigit():
                k += 1
            j = k
    try:
        return float(s[i:j]) if seen else 0.0
    except ValueError:
        return 0.0


def parse_specs(specification: str) -> tuple:
    """Parse a ';'-separated apodization spec string into canonical tuples.

    Mirrors FLAC__stream_encoder_set_apodization exactly: unknown or
    out-of-range items are silently skipped, expansion of
    partial/punchout_tukey(n/ov/p) into n window entries happens here, at
    most 32 entries are kept, and an empty result defaults to tukey(0.5).

    Returns a tuple of canonical spec strings consumed by expand_bank:
      "tukey(<p>)", "gauss(<stddev>)", "<simple-name>",
      "partial_tukey_one(<p>/<start>/<end>)",
      "punchout_tukey_one(<p>/<start>/<end>)",
      "subdivide_tukey(<parts>/<p_scaled>)"
    """
    out: list[str] = []
    for item in str(specification).split(";"):
        if len(out) >= MAX_APODIZATIONS:
            break
        item = item.strip()
        if item in _SIMPLE:
            out.append(item)
        elif item.startswith("gauss(") and len(item) > 7:
            stddev = _strtod(item[6:])
            if 0.0 < stddev <= 0.5:
                out.append(f"gauss({stddev!r})")
        elif item.startswith("tukey(") and len(item) > 7:
            p = _strtod(item[6:])
            if 0.0 <= p <= 1.0:
                out.append(f"tukey({p!r})")
        elif (item.startswith("partial_tukey(") and len(item) > 15) or \
                (item.startswith("punchout_tukey(") and len(item) > 16):
            kind = "partial" if item.startswith("partial_tukey(") else \
                "punchout"
            body = item[item.index("(") + 1:]
            parts = int(_strtod(body))
            fields = body.split("/")
            default_ov = 0.1 if kind == "partial" else 0.2
            overlap = min(_strtod(fields[1]), 0.99) if len(fields) > 1 \
                else default_ov
            ou = 1.0 / (1.0 - overlap) - 1.0
            p = _strtod(fields[2]) if len(fields) > 2 else 0.2
            if parts <= 1:
                out.append(f"tukey({p!r})")
            elif len(out) + parts < MAX_APODIZATIONS:
                for m in range(parts):
                    start = m / (parts + ou)
                    end = (m + 1 + ou) / (parts + ou)
                    out.append(
                        f"{kind}_tukey_one({p!r}/{start!r}/{end!r})")
        elif item.startswith("subdivide_tukey(") and len(item) > 17:
            body = item[16:]
            parts = int(_strtod(body))
            if parts > 1:
                fields = body.split("/")
                p = _strtod(fields[1]) if len(fields) > 1 else 0.5
                p = min(max(p, 0.0), 1.0)
                out.append(f"subdivide_tukey({parts}/{p / parts!r})")
    if not out:
        out = ["tukey(0.5)"]
    return tuple(out[:MAX_APODIZATIONS])


def _args(item: str) -> list[float]:
    return [float(a) for a in item[item.index("(") + 1:-1].split("/")]


def _partial_window_full_length(root: np.ndarray, part_size: int,
                                shift: int) -> np.ndarray:
    """Zero-padded full-length equivalent of FLAC__lpc_window_data_partial
    (lpc.c:81-93): the segment [shift, shift+2*part_size) is windowed by
    the root window's first and last part_size samples; elsewhere 0, so a
    full-length autocorrelation equals the reference's segment one."""
    L = len(root)
    w = np.zeros(L, dtype=np.float32)
    if part_size + shift >= L:
        return w
    w[shift:shift + part_size] = root[:part_size]
    n2 = min(part_size, L - part_size - shift)
    w[shift + part_size:shift + part_size + n2] = root[L - part_size:
                                                       L - part_size + n2]
    return w


def expand_bank(blocksize: int, specs: tuple):
    """Expand canonical specs into (windows [W,N], combine [A,W], names).

    Plain windows get identity combine rows.  subdivide_tukey expands into
    the root window + per-depth partial windows, with punchout candidates
    expressed as (root - partial) autocorrelation rows — exactly the
    candidate set apply_apodization_/set_next_subdivide_tukey iterates
    (stream_encoder.c:4293-4391): depth 2 contributes partials only, depths
    3..parts contribute partial+punchout pairs.
    """
    windows: list[np.ndarray] = []
    rows: list[np.ndarray] = []
    names: list[str] = []

    def add_window(w) -> int:
        windows.append(w)
        return len(windows) - 1

    def add_row(name, **weights):
        r = np.zeros(MAX_APODIZATIONS * 8, dtype=np.float32)
        for idx, v in weights.items():
            r[int(idx)] = v
        rows.append(r)
        names.append(name)

    for item in specs:
        base = item.split("(")[0]
        if base in _SIMPLE:
            add_row(item, **{str(add_window(_SIMPLE[base](blocksize))): 1.0})
        elif base == "gauss":
            add_row(item, **{str(add_window(
                gauss(blocksize, _args(item)[0]))): 1.0})
        elif base == "tukey":
            add_row(item, **{str(add_window(
                tukey(blocksize, _args(item)[0]))): 1.0})
        elif base == "partial_tukey_one":
            p, start, end = _args(item)
            add_row(item, **{str(add_window(
                partial_tukey(blocksize, p, start, end))): 1.0})
        elif base == "punchout_tukey_one":
            p, start, end = _args(item)
            add_row(item, **{str(add_window(
                punchout_tukey(blocksize, p, start, end))): 1.0})
        elif base == "subdivide_tukey":
            a = _args(item)
            parts, p = int(a[0]), a[1]
            root = tukey(blocksize, p)
            root_idx = add_window(root)
            add_row(f"subdivide_tukey({parts})@root",
                    **{str(root_idx): 1.0})
            for b in range(2, parts + 1):
                if blocksize // b <= MAX_LPC_ORDER:
                    break       # tiny parts skipped (stream_encoder.c:4350)
                part_size = blocksize // b // 2
                for c in range(b):
                    shift = (c * blocksize) // b
                    widx = add_window(
                        _partial_window_full_length(root, part_size, shift))
                    add_row(f"subdivide_tukey({parts})@{b}/{c}",
                            **{str(widx): 1.0})
                    if b > 2:   # punchout = root - partial (depth > 2 only)
                        add_row(f"subdivide_tukey({parts})@{b}/{c}^c",
                                **{str(root_idx): 1.0, str(widx): -1.0})
        else:
            raise ValueError(f"unsupported apodization spec: {item}")

    W = len(windows)
    combine = np.stack([r[:W] for r in rows]).astype(np.float32)
    return np.stack(windows), combine, tuple(names)
