"""Native PESQ: a from-scratch ITU-T P.862-family implementation in NumPy
(a copy of azoom.eval.pesq_native, the same code giving the same bits).

The processing chain: level alignment -> input filter (IRS receive for NB /
100 Hz high-pass biquad for WB per P.862.2) -> envelope-based time
alignment -> framed Bark-band "pitch power densities" -> frequency- and
gain-compensation -> Zwicker loudness -> masked disturbance + asymmetry
factor -> (L_p-over-bands, L6-over-split-seconds, L2-over-time) cognitive
aggregation -> raw score 4.5 - 0.1 D - 0.0309 DA -> MOS-LQO mapping
(P.862.1 for NB, P.862.2 for WB). The band tables are the published P.862
ones (pesqpar.h: 49 bands at 16 kHz, 42 at 8 kHz); the time alignment is
the three-stage P.862 chain (global crude and fine alignment, per-utterance
delays from an energy VAD, bad-interval realignment). The ITU conformance
vectors have not been run against it (see azoom.eval.pesq_native).

Why NumPy and not torch, on the host: the time alignment, the VAD's
utterance splitting and the bad-interval realignment are data-dependent
control flow over a few hundred frames (loops whose trip counts and branches
depend on the signal), which a device would run as many tiny launches with a
host round trip at each branch; PESQ is an offline evaluation step, as the
reference keeps it ("device pipelines never depend on this module",
azoom_torch.eval.pesq_bridge). Keeping the reference's NumPy code keeps its
scores bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pesq_native", "raw_pesq", "mos_lqo_nb", "mos_lqo_wb"]

# Cognitive-model constants (ITU-T P.862 / pesqpar.h).
TARGET_AVG_POWER = 1e7
D_POW_F, D_POW_S, D_POW_T = 2.0, 6.0, 2.0  # symmetric: bands, split-sec, time
A_POW_F, A_POW_S, A_POW_T = 1.0, 6.0, 2.0  # asymmetric
FRAMES_PER_SYLLABLE = 20  # "split second" = 20 half-overlapped frames
SL = 1.866055e-1  # loudness scale
SP_16K = 6.910853e-6  # power scale, 16 kHz (Nf=512)
SP_8K = 2.764344e-5  # power scale, 8 kHz (Nf=256)


# ---------------------------------------------------------------------------
# Band structure.
#
# 16 kHz: the EXACT ITU-T P.862 49-band tables (pesqpar.h). Consecutive
# runs of rfft bins (512-point FFT, 31.25 Hz each, starting at DC) are
# grouped per ``_NR_HZ_BANDS_16K``; the grouped power is scaled by
# 100/nr (``pow_dens_correction_factor_16k`` — the published table IS
# 100/nr to float32 noise) and by Sp. Validated by cross-table
# consistency in tests/test_pesq_conformance.py.
#
# 8 kHz: the 42-band ITU tables — the 16 kHz tables' prefix on the
# shared 31.25 Hz bin grid (see the 8 kHz table block below).
# ---------------------------------------------------------------------------

# nr_of_hz_bands_per_bark_band_16k — sums to exactly 256 rfft bins.
_NR_HZ_BANDS_16K = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 2, 1,
    1, 1, 1, 1, 2, 1, 1, 2, 2, 2,
    2, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    3, 4, 5, 4, 5, 6, 6, 7, 8, 9,
    9, 12, 12, 15, 16, 18, 21, 25, 20,
], np.int64)

# centre_of_band_bark_16k
_CENTRE_BARK_16K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450,
    1.624217, 1.962597, 2.305636, 2.653383, 3.005889,
    3.363201, 3.725371, 4.092449, 4.464486, 4.841533,
    5.223642, 5.610866, 6.003256, 6.400869, 6.803755,
    7.211971, 7.625571, 8.044611, 8.469146, 8.899232,
    9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232,
    14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478,
    19.319147, 19.886751, 20.461355, 21.043034,
], np.float64)

# width_of_band_bark_16k
_WIDTH_BARK_16K = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474,
    0.336061, 0.340697, 0.345381, 0.350114, 0.354897,
    0.359729, 0.364611, 0.369544, 0.374529, 0.379565,
    0.384653, 0.389794, 0.394989, 0.400236, 0.405538,
    0.410894, 0.416306, 0.421773, 0.427297, 0.432877,
    0.438514, 0.444209, 0.449962, 0.455774, 0.461645,
    0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745,
    0.530308, 0.536934, 0.543629, 0.550390, 0.557220,
    0.564119, 0.571085, 0.578125, 0.585232,
], np.float64)

# abs_thresh_power_16k (power units, 0 dB SPL == 1.0; the mid-band
# plateau is 10^-0.6 = 0.251189)
_ABS_THRESH_16K = np.array([
    51286152.0, 2454709.5, 70794.59375, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372,
    4.897789, 3.090296, 1.905461, 1.258925, 0.977237,
    0.724436, 0.562341, 0.457088, 0.389045, 0.331131,
    0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.251189,
    0.251189, 0.251189, 0.251189, 0.251189, 0.251189,
    0.251189, 0.316228, 0.398107, 0.501187,
], np.float64)

# 8 kHz (narrowband-rate) 42-band tables. The 8 kHz mode uses a 256-pt
# FFT at fs=8000 — the SAME 31.25 Hz bin grid as the 16 kHz mode's
# 512-pt FFT — so the ITU Bark layout below 4 kHz is shared: the
# published 8 kHz tables (pesqpar.h nr_of_hz_bands_per_bark_band /
# centre_of_band_bark / width_of_band_bark / abs_thresh_power) are the
# 42-band PREFIX of the 16 kHz tables, with only the TOP band's bin
# count truncated at the 4 kHz Nyquist (8 bins instead of the 16 kHz
# table's 12). Validated by the same joint cross-table consistency
# tests as the 16 kHz transcription (tests/test_pesq_conformance.py):
# bin counts, 100/nr correction, Bark centre/width chaining, and a
# cross-rate NB score agreement check.
_NR_HZ_BANDS_8K = np.concatenate(
    [_NR_HZ_BANDS_16K[:41], np.array([8], np.int64)]
)
_CENTRE_BARK_8K = _CENTRE_BARK_16K[:42]
_WIDTH_BARK_8K = _WIDTH_BARK_16K[:42]
_ABS_THRESH_8K = _ABS_THRESH_16K[:42]


class _Bands:
    """Per-sample-rate constants: FFT bin -> Bark band grouping tables."""

    def __init__(self, fs: int):
        if fs == 16_000:
            self.nf, self.nb, self.sp = 512, 49, SP_16K
        elif fs == 8_000:
            self.nf, self.nb, self.sp = 256, 42, SP_8K
        else:
            raise ValueError(f"PESQ supports fs 8000/16000, got {fs}")
        self.fs = fs
        self.hop = self.nf // 2
        freqs = np.fft.rfftfreq(self.nf, 1.0 / fs)
        if fs == 16_000:
            # ITU tables: consecutive-bin grouping with 100/nr correction
            self.centre_bark = _CENTRE_BARK_16K
            self.width_bark = _WIDTH_BARK_16K
            self.abs_thresh = _ABS_THRESH_16K
            self.group = np.zeros((self.nb, freqs.size), np.float64)
            start = 0
            for band, nr in enumerate(_NR_HZ_BANDS_16K):
                self.group[band, start : start + nr] = 100.0 / nr
                start += nr
            self.group[:, 0] = 0.0  # DC excluded
        else:
            # ITU 8 kHz 42-band tables (see the table block above):
            # identical consecutive-bin grouping with 100/nr correction.
            self.centre_bark = _CENTRE_BARK_8K
            self.width_bark = _WIDTH_BARK_8K
            self.abs_thresh = _ABS_THRESH_8K
            self.group = np.zeros((self.nb, freqs.size), np.float64)
            start = 0
            for band, nr in enumerate(_NR_HZ_BANDS_8K):
                self.group[band, start : start + nr] = 100.0 / nr
                start += nr
            self.group[:, 0] = 0.0  # DC excluded
        # ITU modified-Zwicker exponent: low bands (z < 4 Bark) get
        # exponent 0.23 * min(6/(z+2), 2)^0.15 (pesqmain intensity
        # warping); 1.0 factor elsewhere.
        h = np.where(
            self.centre_bark < 4.0, 6.0 / (self.centre_bark + 2.0), 1.0
        )
        self.zwicker_pow = 0.23 * np.minimum(h, 2.0) ** 0.15
        # ITU Hann convention: symmetric, 2*pi*n/(Nf-1)
        self.window = 0.5 * (
            1.0 - np.cos(2.0 * np.pi * np.arange(self.nf) / (self.nf - 1))
        )


_BANDS_CACHE: dict[int, _Bands] = {}


def _bands(fs: int) -> _Bands:
    if fs not in _BANDS_CACHE:
        _BANDS_CACHE[fs] = _Bands(fs)
    return _BANDS_CACHE[fs]


# ---------------------------------------------------------------------------
# Front end: level alignment, input filters, time alignment
# ---------------------------------------------------------------------------

def _band_power(x: np.ndarray, fs: int, lo: float, hi: float) -> float:
    """Average power of x restricted to [lo, hi] Hz (FFT brick-wall)."""
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(x.size, 1.0 / fs)
    sel = (f >= lo) & (f <= hi)
    return float(np.sum(np.abs(X[sel]) ** 2) / (x.size * x.size) * 2.0)


def _fix_level(x: np.ndarray, fs: int) -> np.ndarray:
    """Scale so the 325-3250 Hz band has average power TARGET_AVG_POWER
    (P.862 fixed level alignment)."""
    p = _band_power(x, fs, 325.0, 3_250.0)
    return x * np.sqrt(TARGET_AVG_POWER / (p + 1e-20))

# IRS receive characteristic, piecewise-linear gain in dB over log-f
# (P.862 narrowband input filter, applied in the frequency domain).
_IRS_HZ = np.array([
    0, 50, 100, 125, 160, 200, 250, 300, 350, 400, 500, 600, 700, 800,
    1000, 1300, 1600, 2000, 2500, 3000, 3250, 3500, 4000, 5000, 6300, 8000,
], np.float64)
_IRS_DB = np.array([
    -200.0, -40.0, -20.0, -12.0, -6.0, 0.0, 4.0, 6.0, 8.0, 10.0, 11.0,
    12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 12.0, 4.0,
    -200.0, -200.0, -200.0, -200.0,
], np.float64)


def _irs_filter(x: np.ndarray, fs: int) -> np.ndarray:
    """Apply the IRS receive magnitude response via FFT (NB mode)."""
    n = x.size
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / fs)
    gain_db = np.interp(f, _IRS_HZ, _IRS_DB)
    X *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(X, n=n)


def _wb_input_filter(x: np.ndarray) -> np.ndarray:
    """P.862.2 wideband input high-pass biquad (~100 Hz corner)."""
    from scipy.signal import lfilter

    b = np.array([2.6657628, -5.3315255, 2.6657628])
    a = np.array([1.0, -1.8890331, 0.89487434])
    return lfilter(b, a, x.astype(np.float64))


def _align(ref: np.ndarray, deg: np.ndarray, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Constant-delay time alignment.

    Crude stage: cross-correlate 4 ms log-energy envelopes (P.862
    input_align). Fine stage: sample-level cross-correlation in a
    +/- one-envelope-frame window around the crude estimate. Variable
    per-utterance delay tracking (full P.862 utterance splitting) is not
    implemented; outputs of this framework have constant latency.
    """
    frame = max(int(0.004 * fs), 16)
    T = min(ref.size, deg.size) // frame

    def env(x):
        e = np.sum(x[: T * frame].reshape(T, frame) ** 2, axis=1)
        return np.log10(e + 1e-10)

    er, ed = env(ref), env(deg)
    er -= er.mean()
    ed -= ed.mean()
    xc = np.correlate(ed, er, mode="full")
    crude = (int(np.argmax(xc)) - (T - 1)) * frame  # deg lags ref by `crude`

    span = frame  # +/- one envelope frame of sample-level search
    best_off, best_val = crude, -np.inf
    n = min(ref.size, deg.size)
    seg = slice(n // 4, min(n // 4 + 4 * fs, n - span - abs(crude) - 1))
    r = ref[seg]
    if r.size > frame:
        r = r - r.mean()
        rn = np.sqrt(np.sum(r * r)) + 1e-12
        for off in range(crude - span, crude + span + 1):
            lo = seg.start + off
            if lo < 0 or lo + r.size > deg.size:
                continue
            d = deg[lo : lo + r.size]
            v = float(np.dot(r, d - d.mean())) / rn
            if v > best_val:
                best_val, best_off = v, off
    off = best_off
    if off > 0:
        deg = deg[off:]
    elif off < 0:
        ref = ref[-off:]
    n = min(ref.size, deg.size)
    return ref[:n], deg[:n]


def _vad_utterances(x: np.ndarray, fs: int) -> list[tuple[int, int]]:
    """P.862-style utterance segmentation: 4 ms energy frames against an
    adaptive (-35 dB from peak) threshold, speech runs joined across
    silences shorter than 200 ms, utterances shorter than 50 ms dropped.
    Returns (start, end) SAMPLE ranges."""
    frame = max(int(0.004 * fs), 16)
    T = x.size // frame
    if T == 0:
        return []
    e = np.sum(x[: T * frame].reshape(T, frame) ** 2, axis=1)
    db = 10.0 * np.log10(e + 1e-20)
    speech = db > (db.max() - 35.0)
    gap = max(int(0.2 / 0.004), 1)  # 200 ms of 4 ms frames
    utts: list[tuple[int, int]] = []
    t = 0
    while t < T:
        if not speech[t]:
            t += 1
            continue
        s = t
        last_speech = t
        while t < T:
            if speech[t]:
                last_speech = t
                t += 1
            elif t - last_speech < gap:
                t += 1
            else:
                break
        utts.append((s * frame, min((last_speech + 1) * frame, x.size)))
    min_len = int(0.05 * fs)
    return [(s, e) for s, e in utts if e - s >= min_len]


def _utterance_delays(
    ref: np.ndarray, deg: np.ndarray, fs: int,
    utts: list[tuple[int, int]], span_s: float = 0.030,
) -> list[int]:
    """Per-utterance delay refinement (samples, deg relative to ref)
    around the already-applied global alignment: full cross-correlation
    of each utterance against the degraded signal within +/- span."""
    from scipy.signal import correlate

    span = int(span_s * fs)
    delays = []
    for s, e in utts:
        r = ref[s:e].astype(np.float64)
        lo, hi = max(0, s - span), min(deg.size, e + span)
        d = deg[lo:hi].astype(np.float64)
        if r.size < 64 or d.size <= r.size:
            delays.append(0)
            continue
        xc = correlate(d - d.mean(), r - r.mean(), mode="valid", method="fft")
        delays.append(int(np.argmax(xc)) + lo - s)
    return delays


def _frame_delay_map(
    T: int, hop: int, nf: int,
    utts: list[tuple[int, int]], delays: list[int],
) -> np.ndarray:
    """Per-analysis-frame delay (T,): each frame takes the delay of the
    utterance containing its center; silence frames inherit the nearest
    preceding utterance's delay (leading silence: the first one's)."""
    fd = np.zeros(T, np.int64)
    if not utts:
        return fd
    assigned = np.zeros(T, bool)
    centers = np.arange(T) * hop + nf // 2
    for (s, e), d in zip(utts, delays):
        sel = (centers >= s) & (centers < e)
        fd[sel] = d
        assigned |= sel
    if not assigned.any():
        return fd
    # forward-fill from utterances, then back-fill the leading frames
    last = fd[assigned][0]
    for t in range(T):
        if assigned[t]:
            last = fd[t]
        else:
            fd[t] = last
    first_t = int(np.flatnonzero(assigned)[0])
    fd[:first_t] = fd[first_t]
    return fd


def _pitch_power_densities_delayed(
    x: np.ndarray, bands: "_Bands", T: int, frame_delays: np.ndarray
) -> np.ndarray:
    """(T, Nb) like _pitch_power_densities, but frame t reads x starting
    at t*hop + frame_delays[t] (zero-padded at the edges). Identical to
    the plain framing when all delays are zero."""
    nf, hop = bands.nf, bands.hop
    if T == 0:
        return np.zeros((0, bands.nb))
    pad = np.pad(x, (nf, nf))
    starts = np.arange(T) * hop + np.asarray(frame_delays, np.int64) + nf
    idx = np.clip(starts[:, None] + np.arange(nf)[None, :], 0, pad.size - 1)
    frames = pad[idx] * bands.window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    return (spec @ bands.group.T) * bands.sp


# ---------------------------------------------------------------------------
# Perceptual model
# ---------------------------------------------------------------------------

def _pitch_power_densities(x: np.ndarray, bands: _Bands) -> np.ndarray:
    """(T, Nb) Bark-band power densities of half-overlapped Hann frames."""
    nf, hop = bands.nf, bands.hop
    T = max((x.size - nf) // hop + 1, 0)
    if T == 0:
        return np.zeros((0, bands.nb))
    idx = np.arange(T)[:, None] * hop + np.arange(nf)[None, :]
    frames = x[idx] * bands.window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # unnormalized, as P.862
    return (spec @ bands.group.T) * bands.sp  # (T, Nb)


def _total_audible(ppd: np.ndarray, bands: _Bands, factor: float) -> np.ndarray:
    """(T,) per-frame power summed over bands above factor*threshold.

    ITU convention: the sum starts at band 1 (band 0 is excluded from
    every audible-power and Lp aggregate in pesqmain)."""
    audible = ppd[:, 1:] > factor * bands.abs_thresh[None, 1:]
    return np.sum(np.where(audible, ppd[:, 1:], 0.0), axis=1)


def _loudness(ppd: np.ndarray, bands: _Bands) -> np.ndarray:
    """Zwicker loudness density per band (P.862 intensity warping), with
    the ITU low-band modified exponent (bands.zwicker_pow)."""
    p0 = bands.abs_thresh[None, :]
    zp = bands.zwicker_pow[None, :]
    ratio = np.maximum(ppd, 0.0) / p0
    loud = SL * (p0 / 0.5) ** zp * ((0.5 + 0.5 * ratio) ** zp - 1.0)
    return np.where(ppd > p0, loud, 0.0)


def _weighted_lp(x: np.ndarray, w: np.ndarray, p: float) -> np.ndarray:
    """P.862 pseudo-Lp over bands 1..Nb-1 (band 0 excluded, ITU):
    ((sum (|x| w)^p)/sum w)^(1/p) * sum w."""
    w = w[1:]
    tw = np.sum(w)
    s = np.sum((np.abs(x[:, 1:]) * w[None, :]) ** p, axis=1) / tw
    return s ** (1.0 / p) * tw


def _lpq_time(fd: np.ndarray, p_split: float, p_time: float) -> float:
    """Split-second L_{p_split} then L_{p_time} over time (ITU
    Lpq_weight): windows of 20 frames advancing by 10, anchored at every
    start <= last frame; the split-second mean divides by the FULL
    window length even when the tail window runs past the end."""
    if fd.size == 0:
        return 0.0
    n, hop = FRAMES_PER_SYLLABLE, FRAMES_PER_SYLLABLE // 2
    padded = np.concatenate([fd, np.zeros(n)])
    starts = np.arange(0, fd.size, hop)
    chunks = padded[starts[:, None] + np.arange(n)[None, :]]
    per_split = (np.sum(chunks**p_split, axis=1) / n) ** (1.0 / p_split)
    return float(np.mean(per_split**p_time) ** (1.0 / p_time))


def _disturbances(
    ppd_r: np.ndarray, ppd_d: np.ndarray, bands: "_Bands"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame (fd_symmetric, fd_asymmetric) from raw pitch power
    densities (T, Nb): the P.862 frequency/gain compensation, Zwicker
    loudness, masked disturbance, and asymmetry chain."""
    T = ppd_r.shape[0]
    # Frequency compensation: equalize the *reference* to the degraded's
    # average (speech-active frames) spectrum, bounded [0.01, 100].
    active = _total_audible(ppd_r, bands, 1.0) > 1e7
    if not np.any(active):
        active = np.ones(T, bool)
    avg_r = np.mean(ppd_r[active], axis=0)
    avg_d = np.mean(ppd_d[active], axis=0)
    partial = np.clip((avg_d + 1_000.0) / (avg_r + 1_000.0), 0.01, 100.0)
    ppd_r_c = ppd_r * partial[None, :]

    # Short-term gain compensation: equalize the *degraded* frame power to
    # the compensated reference, smoothed, bounded [3e-4, 5].
    tot_r = _total_audible(ppd_r_c, bands, 1.0)
    tot_d = _total_audible(ppd_d, bands, 1.0)
    ratio = (tot_r + 5e3) / (tot_d + 5e3)
    gain = np.empty(T)
    g = ratio[0]
    gain[0] = np.clip(g, 3e-4, 5.0)
    for t in range(1, T):
        # ITU smoothing order: scale = 0.2 * old + 0.8 * new
        g = 0.2 * g + 0.8 * ratio[t]
        gain[t] = np.clip(g, 3e-4, 5.0)
    ppd_d_c = ppd_d * gain[:, None]

    loud_r = _loudness(ppd_r_c, bands)
    loud_d = _loudness(ppd_d_c, bands)

    # Masked disturbance with a 0.25*min deadzone.
    d = loud_d - loud_r
    m = 0.25 * np.minimum(loud_d, loud_r)
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # Asymmetry factor: additive distortions weigh more than omissions.
    asym = ((ppd_d_c + 50.0) / (ppd_r_c + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    w = bands.width_bark
    fd_s = _weighted_lp(d, w, D_POW_F)
    fd_a = _weighted_lp(d * asym, w, A_POW_F)

    # Emphasis toward loud reference frames; cap at 45.
    h = ((_total_audible(ppd_r_c, bands, 1.0) + 1e5) / 1e7) ** 0.04
    fd_s = np.minimum(fd_s / h, 45.0)
    fd_a = np.minimum(fd_a / h, 45.0)
    return fd_s, fd_a


# Frame disturbance above which an interval is declared "bad" and its
# alignment re-searched (P.862 THRESHOLD_BAD_FRAMES; the 45 used in the
# disturbance chain is the per-frame CAP, a separate constant).
_BAD_FRAME_THRESHOLD = 30.0


def _bad_runs(bad: np.ndarray) -> list[tuple[int, int]]:
    """Consecutive-True runs of a boolean frame vector as (t0, t1)."""
    runs, t = [], 0
    T = bad.size
    while t < T:
        if bad[t]:
            s = t
            while t < T and bad[t]:
                t += 1
            runs.append((s, t))
        else:
            t += 1
    return runs


def raw_pesq(ref: np.ndarray, deg: np.ndarray, fs: int, mode: str = "wb") -> float:
    """Raw P.862 score (~ -0.5 .. 4.5) before MOS-LQO mapping.

    Time alignment (the complete P.862 chain): global
    crude + fine constant-delay alignment, then UTTERANCE SPLITTING —
    energy-VAD utterances each get their own refined delay (so a
    time-warping channel that re-clocks between utterances is scored on
    speech, not on misalignment) — then BAD-INTERVAL REALIGNMENT: frame
    runs whose disturbance saturates the 45 cap get their delay
    re-searched and keep the smaller disturbance
    (Final_pipeline/src/metrics.py:48-66 calls the reference C
    extension's identical three-stage chain)."""
    bands = _bands(fs)
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(ref.size, deg.size)
    ref, deg = ref[:n], deg[:n]
    if n < 2 * bands.nf or np.max(np.abs(ref)) <= 0:
        return 4.5 if np.array_equal(ref, deg) else -0.5

    ref = _fix_level(ref, fs)
    deg = _fix_level(deg, fs)
    if mode == "wb":
        ref, deg = _wb_input_filter(ref), _wb_input_filter(deg)
    else:
        ref, deg = _irs_filter(ref, fs), _irs_filter(deg, fs)
    ref, deg = _align(ref, deg, fs)

    nf, hop = bands.nf, bands.hop
    ppd_r = _pitch_power_densities(ref, bands)  # (T, Nb)
    T = min(ppd_r.shape[0], max((deg.size - nf) // hop + 1, 0))
    if T == 0:
        return -0.5
    ppd_r = ppd_r[:T]

    # Utterance splitting: per-utterance delay refinement on top of the
    # global alignment; the degraded frames are read at their
    # utterance's delay.
    utts = _vad_utterances(ref, fs)
    frame_delays = _frame_delay_map(
        T, hop, nf, utts, _utterance_delays(ref, deg, fs, utts)
    )
    ppd_d = _pitch_power_densities_delayed(deg, bands, T, frame_delays)

    fd_s, fd_a = _disturbances(ppd_r, ppd_d, bands)

    # Bad-interval realignment: disturbance-saturated frame runs get a
    # local delay re-search; realigned frames keep the SMALLER
    # disturbance (a misalignment artifact scores better realigned; a
    # genuine distortion does not).
    runs = _bad_runs(fd_s >= _BAD_FRAME_THRESHOLD)
    if runs:
        from scipy.signal import correlate

        new_delays = frame_delays.copy()
        changed = False
        span = nf  # one frame length of re-search each way
        for t0, t1 in runs:
            s0, s1 = t0 * hop, min(t1 * hop + nf, ref.size)
            r = ref[s0:s1]
            base = int(frame_delays[t0])
            lo = max(0, s0 + base - span)
            hi = min(deg.size, s1 + base + span)
            d = deg[lo:hi]
            if r.size < 64 or d.size <= r.size:
                continue
            xc = correlate(
                d - d.mean(), r - r.mean(), mode="valid", method="fft"
            )
            off = int(np.argmax(xc)) + lo - s0
            if off != base:
                new_delays[t0:t1] = off
                changed = True
        if changed:
            ppd_d2 = _pitch_power_densities_delayed(
                deg, bands, T, new_delays)
            fd_s2, fd_a2 = _disturbances(ppd_r, ppd_d2, bands)
            in_bad = np.zeros(T, bool)
            for t0, t1 in runs:
                in_bad[t0:t1] = True
            better = in_bad & (fd_s2 < fd_s)
            fd_s = np.where(better, fd_s2, fd_s)
            fd_a = np.where(better, fd_a2, fd_a)

    d_symm = _lpq_time(fd_s, D_POW_S, D_POW_T)
    d_asym = _lpq_time(fd_a, A_POW_S, A_POW_T)
    return float(np.clip(4.5 - 0.1 * d_symm - 0.0309 * d_asym, -0.5, 4.5))


def mos_lqo_nb(raw: float) -> float:
    """ITU-T P.862.1 raw -> MOS-LQO mapping (narrowband)."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def mos_lqo_wb(raw: float) -> float:
    """ITU-T P.862.2 raw -> MOS-LQO mapping (wideband)."""
    return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))


def pesq_native(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """MOS-LQO score; same call signature as ``pesq.pesq``.

    mode "nb" (fs 8000/16000) or "wb" (fs 16000 only), as the reference
    uses them (Final_pipeline/src/metrics.py:48-66).
    """
    if mode == "wb" and fs != 16_000:
        raise ValueError("wideband PESQ requires fs=16000")
    raw = raw_pesq(ref, deg, fs, mode)
    return float(mos_lqo_wb(raw) if mode == "wb" else mos_lqo_nb(raw))
