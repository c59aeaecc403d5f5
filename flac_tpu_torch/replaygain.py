"""ReplayGain analysis and synthesis.

Capability port (not a code port) of the reference's ReplayGain stack:

- analysis: src/share/replaygain_analysis/replaygain_analysis.c (the
  David Robinson / Glen Sawyer algorithm) — a Yule-Walker(10) +
  Butterworth(2) equal-loudness cascade, 50 ms RMS windows, a 0.01 dB
  histogram, and the 95th-percentile pink-noise-referenced gain.
- scaling + tags: src/share/grabbag/replaygain.c — bps normalization,
  peak tracking, and the REPLAYGAIN_* vorbis-comment entries.
- synthesis: src/share/replaygain_synthesis/replaygain_synthesis.c —
  gain application with optional 6 dB tanh hard limiting and
  noise-shaped dither.

Copy of flac_tpu/replaygain.py.  Architecturally this is a HOST
utility, not a device pipeline: the IIR feedback recurrences are
inherently sequential, so the hot loop lives in the native C++ library
(flac_native.ft_iir, through native.iir_filter); everything around the
filters (windowing, histogram, percentile, dither shaping state) is
vectorized numpy.  There is no Python fallback: the native runtime raises
when it cannot be built.

The filter coefficient tables are the published ReplayGain-specification
constants (replaygain_analysis.c:156-258) — spec-mandated values, like
CRC polynomials.
"""

from __future__ import annotations

import numpy as np

YULE_ORDER = 10
BUTTER_ORDER = 2
RMS_PERCENTILE = 0.95
RMS_WINDOW_TIME_MS = 50
STEPS_PER_DB = 100.0
MAX_DB = 120.0
PINK_REF = 64.82
REFERENCE_LOUDNESS = 89.0

TAG_REFERENCE_LOUDNESS = "REPLAYGAIN_REFERENCE_LOUDNESS"
TAG_TRACK_GAIN = "REPLAYGAIN_TRACK_GAIN"
TAG_TRACK_PEAK = "REPLAYGAIN_TRACK_PEAK"
TAG_ALBUM_GAIN = "REPLAYGAIN_ALBUM_GAIN"
TAG_ALBUM_PEAK = "REPLAYGAIN_ALBUM_PEAK"

# (rate, BYule, AYule, BButter, AButter) — replaygain_analysis.c:156-258
_FILTERS = {
    48000: (
        [0.03857599435200, -0.02160367184185, -0.00123395316851,
         -0.00009291677959, -0.01655260341619, 0.02161526843274,
         -0.02074045215285, 0.00594298065125, 0.00306428023191,
         0.00012025322027, 0.00288463683916],
        [1.0, -3.84664617118067, 7.81501653005538, -11.34170355132042,
         13.05504219327545, -12.28759895145294, 9.48293806319790,
         -5.87257861775999, 2.75465861874613, -0.86984376593551,
         0.13919314567432],
        [0.98621192462708, -1.97242384925416, 0.98621192462708],
        [1.0, -1.97223372919527, 0.97261396931306]),
    44100: (
        [0.05418656406430, -0.02911007808948, -0.00848709379851,
         -0.00851165645469, -0.00834990904936, 0.02245293253339,
         -0.02596338512915, 0.01624864962975, -0.00240879051584,
         0.00674613682247, -0.00187763777362],
        [1.0, -3.47845948550071, 6.36317777566148, -8.54751527471874,
         9.47693607801280, -8.81498681370155, 6.85401540936998,
         -4.39470996079559, 2.19611684890774, -0.75104302451432,
         0.13149317958808],
        [0.98500175787242, -1.97000351574484, 0.98500175787242],
        [1.0, -1.96977855582618, 0.97022847566350]),
    37800: (
        [0.10296717174470, -0.04877975583256, -0.02878009075237,
         -0.03519509188311, 0.02888717172493, -0.00609872684844,
         0.00209851217112, 0.00911704668543, 0.01154404718589,
         -0.00630293688700, 0.00107527155228],
        [1.0, -2.64848054923531, 3.58406058405771, -3.83794914179161,
         3.90142345804575, -3.50179818637243, 2.67085284083076,
         -1.82581142372418, 1.09530368139801, -0.47689017820395,
         0.11171431535905],
        [0.98252400815195, -1.96504801630391, 0.98252400815195],
        [1.0, -1.96474258269041, 0.96535344991740]),
    36000: (
        [0.11572297028613, -0.04120916051252, -0.04977731768022,
         -0.01047308680426, 0.00750863219157, 0.00055507694408,
         0.00140344192886, 0.01286095246036, 0.00998223033885,
         -0.00725013810661, 0.00326503346879],
        [1.0, -2.43606802820871, 3.01907406973844, -2.90372016038192,
         2.67947188094303, -2.17606479220391, 1.44912956803015,
         -0.87785765549050, 0.53592202672557, -0.26469344817509,
         0.07495878059717],
        [0.98165826840326, -1.96331653680652, 0.98165826840326],
        [1.0, -1.96298008938934, 0.96365298422371]),
    32000: (
        [0.15457299681924, -0.09331049056315, -0.06247880153653,
         0.02163541888798, -0.05588393329856, 0.04781476674921,
         0.00222312597743, 0.03174092540049, -0.01390589421898,
         0.00651420667831, -0.00881362733839],
        [1.0, -2.37898834973084, 2.84868151156327, -2.64577170229825,
         2.23697657451713, -1.67148153367602, 1.00595954808547,
         -0.45953458054983, 0.16378164858596, -0.05032077717131,
         0.02347897407020],
        [0.97938932735214, -1.95877865470428, 0.97938932735214],
        [1.0, -1.95835380975398, 0.95920349965459]),
    28000: (
        [0.23882392323383, -0.22007791534089, -0.06014581950332,
         0.05004458058021, -0.03293111254977, 0.02348678189717,
         0.04290549799671, -0.00938141862174, 0.00015095146303,
         -0.00712601540885, -0.00626520210162],
        [1.0, -2.06894080899139, 1.76944699577212, -0.81404732584187,
         0.25418286850232, -0.30340791669762, 0.35616884070937,
         -0.14967310591258, -0.07024154183279, 0.11078404345174,
         -0.03551838002425],
        [0.97647981663949, -1.95295963327897, 0.97647981663949],
        [1.0, -1.95240635772520, 0.95351290883275]),
    24000: (
        [0.30296907319327, -0.22613988682123, -0.08587323730772,
         0.03282930172664, -0.00915702933434, -0.02364141202522,
         -0.00584456039913, 0.06276101321749, -0.00000828086748,
         0.00205861885564, -0.02950134983287],
        [1.0, -1.61273165137247, 1.07977492259970, -0.25656257754070,
         -0.16276719120440, -0.22638893773906, 0.39120800788284,
         -0.22138138954925, 0.04500235387352, 0.02005851806501,
         0.00302439095741],
        [0.97531843204928, -1.95063686409857, 0.97531843204928],
        [1.0, -1.95002759149878, 0.95124613669835]),
    22050: (
        [0.33642304856132, -0.25572241425570, -0.11828570177555,
         0.11921148675203, -0.07834489609479, -0.00469977914380,
         -0.00589500224440, 0.05724228140351, 0.00832043980773,
         -0.01635381384540, -0.01760176568150],
        [1.0, -1.49858979367799, 0.87350271418188, 0.12205022308084,
         -0.80774944671438, 0.47854794562326, -0.12453458140019,
         -0.04067510197014, 0.08333755284107, -0.04237348025746,
         0.02977207319925],
        [0.97316523498161, -1.94633046996323, 0.97316523498161],
        [1.0, -1.94561023566527, 0.94705070426118]),
    18900: (
        [0.38412657295385, -0.44533729608120, 0.20426638066221,
         -0.28031676047946, 0.31484202614802, -0.26078311203207,
         0.12925201224848, -0.01141164696062, 0.03036522115769,
         -0.03776339305406, 0.00692036603586],
        [1.0, -1.74403915585708, 1.96686095832499, -2.10081452941881,
         1.90753918182846, -1.83814263754422, 1.36971352214969,
         -0.77883609116398, 0.39266422457649, -0.12529383592986,
         0.05424760697665],
        [0.96535326815829, -1.93070653631658, 0.96535326815829],
        [1.0, -1.92950577983524, 0.93190729279793]),
    16000: (
        [0.44915256608450, -0.14351757464547, -0.22784394429749,
         -0.01419140100551, 0.04078262797139, -0.12398163381748,
         0.04097565135648, 0.10478503600251, -0.01863887810927,
         -0.03193428438915, 0.00541907748707],
        [1.0, -0.62820619233671, 0.29661783706366, -0.37256372942400,
         0.00213767857124, -0.42029820170918, 0.22199650564824,
         0.00613424350682, 0.06747620744683, 0.05784820375801,
         0.03222754072173],
        [0.96454515552826, -1.92909031105652, 0.96454515552826],
        [1.0, -1.92783286977036, 0.93034775234268]),
    12000: (
        [0.56619470757641, -0.75464456939302, 0.16242137742230,
         0.16744243493672, -0.18901604199609, 0.30931782841830,
         -0.27562961986224, 0.00647310677246, 0.08647503780351,
         -0.03788984554840, -0.00588215443421],
        [1.0, -1.04800335126349, 0.29156311971249, -0.26806001042947,
         0.00819999645858, 0.45054734505008, -0.33032403314006,
         0.06739368333110, -0.04784254229033, 0.01639907836189,
         0.01807364323573],
        [0.96009142950541, -1.92018285901082, 0.96009142950541],
        [1.0, -1.91858953033784, 0.92177618768381]),
    11025: (
        [0.58100494960553, -0.53174909058578, -0.14289799034253,
         0.17520704835522, 0.02377945217615, 0.15558449135573,
         -0.25344790059353, 0.01628462406333, 0.06920467763959,
         -0.03721611395801, -0.00749618797172],
        [1.0, -0.51035327095184, -0.31863563325245, -0.20256413484477,
         0.14728154134330, 0.38952639978999, -0.23313271880868,
         -0.05246019024463, -0.02505961724053, 0.02442357316099,
         0.01818801111503],
        [0.95856916599601, -1.91713833199203, 0.95856916599601],
        [1.0, -1.91542108074780, 0.91885558323625]),
    8000: (
        [0.53648789255105, -0.42163034350696, -0.00275953611929,
         0.04267842219415, -0.10214864179676, 0.14590772289388,
         -0.02459864859345, -0.11202315195388, -0.04060034127000,
         0.04788665548180, -0.02217936801134],
        [1.0, -0.25049871956020, -0.43193942311114, -0.03424681017675,
         -0.04678328784242, 0.26408300200955, 0.15113130533216,
         -0.17556493366449, -0.18823009262115, 0.05477720428674,
         0.04704409688120],
        [0.94597685600279, -1.89195371200558, 0.94597685600279],
        [1.0, -1.88903307939452, 0.89487434461664]),
}


def _resolve_rate(sample_rate: int):
    """(table_rate, downsample) per CreateGainFilter
    (replaygain_analysis.c:302-337): exact table match, else halve until a
    table rate is hit."""
    if sample_rate in _FILTERS:
        return sample_rate, 1
    maxrate = max(_FILTERS)
    rate, down = sample_rate, 1
    while rate > maxrate:
        rate //= 2
        down *= 2
    if rate in _FILTERS:
        return rate, down
    return None, 0


def valid_sample_rate(sample_rate: int) -> bool:
    return _resolve_rate(sample_rate)[0] is not None


def _iir(x, b, a, x_hist, y_hist):
    """Sequential IIR in the native runtime."""
    from . import native
    return native.iir_filter(x, np.asarray(b, np.float64),
                             np.asarray(a, np.float64), x_hist, y_hist)


class _ChannelFilter:
    """Yule→Butterworth cascade state for one channel."""

    def __init__(self, byule, ayule, bbutter, abutter):
        self.byule, self.ayule = byule, ayule
        self.bbutter, self.abutter = bbutter, abutter
        self.xh = np.zeros(YULE_ORDER)
        self.sh_x = np.zeros(YULE_ORDER)   # yule output = butter input
        self.sh_y = np.zeros(BUTTER_ORDER)
        self.oh = np.zeros(BUTTER_ORDER)

    def process(self, x: np.ndarray) -> np.ndarray:
        step, self.xh, self.sh_x = _iir(x, self.byule, self.ayule,
                                        self.xh, self.sh_x)
        out, self.sh_y, self.oh = _iir(step, self.bbutter, self.abutter,
                                       self.sh_y, self.oh)
        return out


class GainAnalyzer:
    """Streaming ReplayGain analyzer (InitGainAnalysis / AnalyzeSamples /
    GetTitleGain / GetAlbumGain, replaygain_analysis.c:299-560).

    Feed float samples in 16-bit full scale (±32768) via analyze();
    feed integer PCM of any bps via analyze_pcm() (grabbag scaling,
    grabbag/replaygain.c:135-235).
    """

    HIST_LEN = int(STEPS_PER_DB * MAX_DB)

    def __init__(self, sample_rate: int):
        rate, down = _resolve_rate(sample_rate)
        if rate is None:
            raise ValueError(f"unsupported sample rate {sample_rate}")
        self.rate, self.downsample = rate, down
        self.window = (rate * RMS_WINDOW_TIME_MS + 999) // 1000
        coeffs = _FILTERS[rate]
        self._filters = [_ChannelFilter(*coeffs), _ChannelFilter(*coeffs)]
        self._accum = 0.0           # running l²+r² sum inside the window
        self._totsamp = 0
        self._hist_track = np.zeros(self.HIST_LEN, np.int64)
        self._hist_album = np.zeros(self.HIST_LEN, np.int64)
        self.track_peak = 0.0
        self.album_peak = 0.0

    # -- core sample path ---------------------------------------------------

    def analyze(self, left: np.ndarray, right: np.ndarray | None = None):
        """left/right: float64 samples at 16-bit full scale."""
        if right is None:
            right = left
        left = np.asarray(left, np.float64)[::self.downsample]
        right = np.asarray(right, np.float64)[::self.downsample]
        if left.size == 0:
            return
        lsq = self._filters[0].process(left) ** 2
        rsq = self._filters[1].process(right) ** 2
        power = lsq + rsq
        # split into RMS windows, continuing the partially-filled one
        pos = 0
        n = len(power)
        csum = np.concatenate([[0.0], np.cumsum(power)])
        while pos < n:
            take = min(self.window - self._totsamp, n - pos)
            self._accum += csum[pos + take] - csum[pos]
            self._totsamp += take
            pos += take
            if self._totsamp == self.window:
                val = STEPS_PER_DB * 10.0 * np.log10(
                    self._accum / self._totsamp * 0.5 + 1e-37)
                ival = min(max(int(val), 0), self.HIST_LEN - 1)
                self._hist_track[ival] += 1
                self._accum = 0.0
                self._totsamp = 0

    def analyze_pcm(self, pcm: np.ndarray, bps: int):
        """pcm: [C, n] integer samples (1 or 2 channels)."""
        pcm = np.asarray(pcm)
        if pcm.ndim == 1:
            pcm = pcm[None]
        scale = 2.0 ** (16 - bps)       # grabbag/replaygain.c:183-187
        peak = float(np.max(np.abs(pcm.astype(np.float64))) /
                     (1 << (bps - 1))) if pcm.size else 0.0
        self.track_peak = max(self.track_peak, peak)
        self.album_peak = max(self.album_peak, peak)
        left = pcm[0].astype(np.float64) * scale
        right = pcm[1].astype(np.float64) * scale if pcm.shape[0] > 1 \
            else None
        self.analyze(left, right)

    # -- results ------------------------------------------------------------

    @staticmethod
    def _analyze_result(hist: np.ndarray) -> float | None:
        elems = int(hist.sum())
        if elems == 0:
            return None
        upper = elems // 20 + (1 if elems % 20 else 0)
        # index of the loudness at the 95th percentile, scanning from top
        csum_top = np.cumsum(hist[::-1])
        i = len(hist) - 1 - int(np.searchsorted(csum_top, upper))
        return float(PINK_REF - i / STEPS_PER_DB)

    def title_gain(self) -> float | None:
        """Gain for samples since the last title_gain() call; folds the
        track histogram into the album one (GetTitleGain)."""
        g = self._analyze_result(self._hist_track)
        self._hist_album += self._hist_track
        self._hist_track[:] = 0
        return g

    def album_gain(self) -> float | None:
        return self._analyze_result(self._hist_album)

    def next_track(self):
        """Reset per-track peak (grabbag get_title semantics)."""
        self.track_peak = 0.0


# ---------------------------------------------------------------------------
# Vorbis-comment tag formatting (grabbag/replaygain.c:56-58, 353-430)
# ---------------------------------------------------------------------------

def format_tags(track_gain: float, track_peak: float,
                album_gain: float | None = None,
                album_peak: float | None = None) -> list[tuple[str, str]]:
    tags = [(TAG_REFERENCE_LOUDNESS, f"{REFERENCE_LOUDNESS:2.1f} dB"),
            (TAG_TRACK_GAIN, f"{track_gain:+2.2f} dB"),
            (TAG_TRACK_PEAK, f"{track_peak:1.8f}")]
    if album_gain is not None:
        tags.append((TAG_ALBUM_GAIN, f"{album_gain:+2.2f} dB"))
        tags.append((TAG_ALBUM_PEAK, f"{album_peak or 0.0:1.8f}"))
    return tags


def strip_tags(comments: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Remove all REPLAYGAIN_* entries (case-insensitive field match)."""
    return [(k, v) for (k, v) in comments
            if not k.upper().startswith("REPLAYGAIN_")]


def parse_gain_tag(value: str) -> float | None:
    """'-6.54 dB' -> -6.54 (tolerant, like grabbag's parse_double_)."""
    try:
        return float(value.strip().split()[0])
    except (ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Synthesis (replaygain_synthesis.c)
# ---------------------------------------------------------------------------

class _DitherRNG:
    """The dual-polycounter audio RNG (replaygain_synthesis.c:83-110).
    Both 32-bit states evolve by GF(2)-linear maps; batches are produced
    with a vectorized table-parity step."""

    _PARITY = np.array([bin(i).count("1") & 1 for i in range(256)],
                       np.uint32)

    def __init__(self):
        self.r1 = np.uint32(1)
        self.r2 = np.uint32(1)

    def batch(self, n: int) -> np.ndarray:
        """n raw uint32 draws."""
        out = np.empty(n, np.uint32)
        r1, r2 = int(self.r1), int(self.r2)
        par = self._PARITY
        for i in range(n):
            t1 = par[r1 & 0xF5] << 31
            t2 = par[(r2 >> 25) & 0x63]
            r1 = (r1 >> 1) | int(t1)
            r2 = ((r2 + r2) & 0xFFFFFFFF) | int(t2)
            out[i] = r1 ^ r2
        self.r1, self.r2 = np.uint32(r1), np.uint32(r2)
        return out


# 16-tap noise-shaping FIR banks for 44.1 kHz-family output
# (replaygain_synthesis.c:127-190; shaping 0 = none)
_SHAPE_F44_1 = np.array([
    0.85018292704024355931, 0.29089597350995344721, -0.05021866022121039450,
    -0.23545456294599161833, -0.58362726442227032096, -0.67038978965193036429,
    -0.38566861572833459221, -0.15218663390367969967, -0.02577543084864530676,
    0.14119295297688728127, 0.22398848581628781612, 0.15401727203382084116,
    0.05216161232906000929, -0.00282237820999675451, -0.03042794608323867363,
    -0.03109780942998826024])
_SHAPE_F44_2 = np.array([
    1.78827593892108555290, 0.95508210637394326553, -0.18447626783899924429,
    -0.44198126506275016437, -0.88404052492547413497, -1.42218907262407452967,
    -1.02037566838362314995, -0.34861755756425577264, -0.11490230170431934434,
    0.12498899339968611803, 0.38065885268563131927, 0.31883491321310506562,
    0.10486838686563442765, -0.03105361685110374845, -0.06450524884075370758,
    -0.02939198261121969816])
_SHAPE_F44_3 = np.array([
    2.89072132015058161445, 2.68932810943698754106, 0.21083359339410251227,
    -0.98385073324997617515, -1.11047823227097316719, -2.18954076314139673147,
    -2.36498032881953056225, -0.95484132880101140785, -0.23924057925542965158,
    -0.13865235703915925642, 0.43587843191057992846, 0.65903257226026665927,
    0.24361815372443152787, -0.00235974960154720097, 0.01844166574603346289,
    0.01722945988740875099])
_SHAPE_FILTERS = (None, _SHAPE_F44_1, _SHAPE_F44_2, _SHAPE_F44_3)
_DEFAULT_DITHER = np.array([92, 92, 88, 84, 81, 78, 74, 67, 0, 0])


class DitherContext:
    """init_dither_context (replaygain_synthesis.c:203-225)."""

    def __init__(self, bits: int, shapingtype: int = 1):
        shapingtype = min(max(shapingtype, 0), 3)
        self.shaping = shapingtype
        idx = min(max(bits - 11 - shapingtype, 0), 9)
        self.coeff = _SHAPE_FILTERS[shapingtype]
        self.mask = np.int64(-1) << (32 - bits)
        self.add = 0.5 * ((1 << (32 - bits)) - 1)
        self.dither = 0.01 * _DEFAULT_DITHER[idx] / float(1 << bits)
        self.rng = _DitherRNG()
        self.error_hist = np.zeros((2, 16))
        self.dither_hist = np.zeros((2, 16))
        self.last_rand = np.zeros(2)
        self.last_index = 0


def apply_gain(pcm: np.ndarray, source_bps: int, target_bps: int,
               scale: float, hard_limit: bool = False,
               dither: DitherContext | None = None) -> np.ndarray:
    """Scale [C, n] integer PCM into target_bps integers
    (FLAC__replaygain_synthesis__apply_gain, replaygain_synthesis.c:301-
    429): normalize to ±1, optional tanh 6 dB limiter above ±0.5, scale to
    32-bit, optional noise-shaped dither, shift to target width, clip.
    """
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[None]
    C, n = pcm.shape
    sample = pcm.astype(np.float64) * (scale / float(1 << (source_bps - 1)))
    if hard_limit:
        hi = sample > 0.5
        lo = sample < -0.5
        sample = np.where(hi, np.tanh((sample - 0.5) / 0.5) * 0.5 + 0.5,
                          sample)
        sample = np.where(lo, np.tanh((sample + 0.5) / 0.5) * 0.5 - 0.5,
                          sample)
    sample *= 2147483647.0
    conv_shift = 32 - target_bps
    lim_hi = (1 << (target_bps - 1)) - 1
    lim_lo = -(1 << (target_bps - 1))

    if dither is None:
        val = np.floor(sample / (1 << conv_shift) + 0.5).astype(np.int64)
        return np.clip(val, lim_lo, lim_hi).astype(np.int32)

    d = dither
    out = np.empty((C, n), np.int64)
    for ch in range(C):
        if d.shaping == 0:
            draws = d.rng.batch(n).astype(np.int64).astype(np.float64)
            draws = np.where(draws >= 2 ** 31, draws - 2 ** 32, draws) \
                * d.dither
            prev = np.concatenate([[d.last_rand[ch]], draws[:-1]])
            total = sample[ch] + draws - prev
            d.last_rand[ch] = draws[-1] if n else d.last_rand[ch]
            v = np.floor(total + d.add + 0.5).astype(np.int64) & int(d.mask)
        else:
            # error-feedback shaping is sequential per sample
            # (dither_output_, replaygain_synthesis.c:262-272): the C
            # tables F44_* hold the 16 taps tiled 3x, so FilterCoeff+i
            # with i in [0,32) reads taps[(i+j) % 16]
            draws = d.rng.batch(2 * n).astype(np.int64).astype(np.float64)
            draws = np.where(draws >= 2 ** 31, draws - 2 ** 32, draws)
            tri = (draws[0::2] + draws[1::2]) * d.dither
            taps = d.coeff
            tap_rot = np.stack([taps[(i + np.arange(16)) % 16]
                                for i in range(32)])   # taps[(i+j)%16]
            eh = d.error_hist[ch]
            dh = d.dither_hist[ch]
            v = np.empty(n, np.int64)
            li = d.last_index
            for i in range(n):
                ii = (i + li) % 32
                row = tap_rot[ii]
                s2 = tri[i] - float(np.dot(dh, row))
                dh[(-1 - ii) & 15] = s2
                total = sample[ch, i] + s2
                vi = np.int64(np.round(
                    total + float(np.dot(eh, row)) + d.add)) \
                    & np.int64(d.mask)
                eh[(-1 - ii) & 15] = total - float(vi)
                v[i] = vi
        out[ch] = v >> conv_shift
    d.last_index = (d.last_index + n) % 32
    return np.clip(out, lim_lo, lim_hi).astype(np.int32)
