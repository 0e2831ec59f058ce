"""Host-side float64 reference DSP chain (pure NumPy).

Semantics follow the upstream reference (cited per class); state handling is
streaming-exact so chunked == whole, which is the invariant the torch step is
tested against.  Copy of the JAX package's twin, kept here so the port and
its chip smoke test carry their own float64 golden reference.  The
first-order recurrences (de-emphasis, DC blocker, AGC)
are evaluated with the blockwise cumprod identity in ``_varying_first_order``
— ``tests/test_filters.py`` cross-checks them against ``scipy.signal.lfilter``
when SciPy happens to be importable, so the twin carries no SciPy dependency.
"""

from __future__ import annotations

import math

import numpy as np

#: DC-blocker pole (the SSB/AM decoders' constant)
DC_RADIUS = 0.995


def _const_first_order(a1: float, b: np.ndarray, y0: float):
    """y[n] = a1*y[n-1] + b[n] for constant ``a1`` — the lfilter([b0],
    [1, -a1], x, zi=[a1*y0]) recurrence with b folded into ``b``."""
    return _varying_first_order(
        np.full(b.shape, float(a1), dtype=np.float64), b, y0
    )


class RefOscillator:
    """Float64 phase-continuous NCO (reference ``processing.py:282-297``)."""

    def __init__(self, freq_offset_hz: float, sample_rate: float):
        self.phase = 0.0
        self.increment = -2.0 * np.pi * freq_offset_hz / sample_rate

    def mix(self, samples: np.ndarray, sign: int) -> np.ndarray:
        if samples.size == 0:
            return samples.astype(np.complex128)
        n = np.arange(samples.size, dtype=np.float64)
        phases = self.phase + sign * self.increment * n
        osc = np.exp(1j * phases)
        self.phase = (self.phase + sign * self.increment * samples.size) % (2.0 * np.pi)
        return samples.astype(np.complex128) * osc


class RefOverlapSaveFIR:
    """Float64 streaming overlap-save FIR (reference ``processing.py:300-346``)."""

    def __init__(self, taps: np.ndarray, block_size: int):
        if block_size <= 0:
            raise ValueError("block_size must be positive")
        self.taps = np.asarray(taps, dtype=np.complex128)
        self.filter_len = len(taps)
        self.overlap = self.filter_len - 1
        self.block_size = block_size
        self.fft_size = 1 << math.ceil(math.log2(block_size + self.filter_len - 1))
        padded = np.zeros(self.fft_size, dtype=np.complex128)
        padded[: self.filter_len] = self.taps
        self.taps_fft = np.fft.fft(padded)
        self.state = np.zeros(self.overlap, dtype=np.complex128)

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size == 0:
            return samples.astype(np.complex128)
        outputs = []
        cursor = 0
        arr = np.asarray(samples, dtype=np.complex128)
        while cursor < arr.size:
            seg = arr[cursor : cursor + self.block_size]
            cursor += seg.size
            block = np.concatenate([self.state, seg])
            if block.size < self.fft_size:
                block = np.pad(block, (0, self.fft_size - block.size))
            filtered = np.fft.ifft(np.fft.fft(block) * self.taps_fft)
            outputs.append(filtered[self.overlap : self.overlap + seg.size])
            if self.overlap:
                if seg.size >= self.overlap:
                    self.state = seg[-self.overlap :].copy()
                else:
                    self.state = np.concatenate([self.state[seg.size :], seg])
        return np.concatenate(outputs)


class RefDecimator:
    """Phase-preserving stride pick with carried offset (reference
    ``processing.py:349-360``)."""

    def __init__(self, factor: int):
        self.factor = max(1, factor)
        self.offset = 0

    def process(self, samples: np.ndarray) -> np.ndarray:
        if self.factor == 1 or samples.size == 0:
            return samples
        start = (-self.offset) % self.factor
        out = samples[start :: self.factor]
        self.offset = (self.offset + samples.size) % self.factor
        return out


class RefQuadratureDemod:
    """Polar discriminator with previous-sample carry (reference
    ``decoders/nfm.py:11-24``)."""

    def __init__(self):
        self.prev = np.complex128(1 + 0j)

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size == 0:
            return np.empty(0, dtype=np.float64)
        prevs = np.concatenate(([self.prev], samples[:-1]))
        demod = np.angle(np.asarray(samples, np.complex128) * np.conj(prevs))
        self.prev = samples[-1]
        return demod


class RefDeemphasis:
    """Single-pole de-emphasis IIR with zi carry (reference
    ``decoders/nfm.py:27-62``)."""

    def __init__(self, tau_us: float, sample_rate: float):
        tau_sec = max(tau_us * 1e-6, 1e-6)
        self.alpha = math.exp(-1.0 / (sample_rate * tau_sec))
        self.beta = 1.0 - self.alpha
        self.y_prev = 0.0  # carried output (lfilter-zi-equivalent: zi = alpha*y)

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size == 0:
            return samples
        x = np.asarray(samples, np.float64)
        out, self.y_prev = _const_first_order(self.alpha, self.beta * x, self.y_prev)
        return out


class RefDCBlocker:
    """One-pole DC blocker y[n] = x[n] - x[n-1] + r*y[n-1] (reference
    ``decoders/common.py:6-30``), vectorised with lfilter + carried state."""

    def __init__(self, radius: float | None = None):
        if radius is None:
            radius = DC_RADIUS
        self.radius = radius
        self.x_prev = 0.0
        self.y_prev = 0.0

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size == 0:
            return samples
        x = np.asarray(samples, dtype=np.float64)
        u = x - np.concatenate(([self.x_prev], x[:-1]))
        out, self.y_prev = _const_first_order(self.radius, u, self.y_prev)
        self.x_prev = float(x[-1])
        return out


class RefAGC:
    """Feedback AGC (reference ``decoders/ssb.py:67-80``) with carried gain.

    Note: the reference resets gain to 1.0 on every chunk; we carry it so
    chunked == whole holds (the device op does the same).
    """

    def __init__(self, target_dbfs: float = -12.0, decay: float = 0.001):
        self.target = 10.0 ** (target_dbfs / 20.0)
        self.decay = decay
        self.gain = 1.0

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size == 0:
            return samples
        x = np.asarray(samples, dtype=np.float64)
        mag = np.abs(x)
        valid = mag > 1e-6
        a = np.where(valid, 1.0 - self.decay, 1.0)
        b = np.where(valid, self.decay * self.target / np.maximum(mag, 1e-6), 0.0)
        out, zf = _varying_first_order(a, b, self.gain)
        self.gain = float(zf)
        return x * out


def _varying_first_order(a: np.ndarray, b: np.ndarray, y0: float):
    """g[n] = a[n]*g[n-1] + b[n] vectorised blockwise in float64.

    Uses g[n] = A[n]*(y0 + sum_{k<=n} b[k]/A[k]) with A = cumprod(a).  The
    block length is sized from the smallest coefficient so cumprod stays
    far above the float64 denormal floor (a_min**block >= ~1e-250) — a
    fixed 4096 block silently zeroed the tail for fast decays (a < ~0.87).
    """
    g = np.empty_like(b)
    prev = float(y0)
    n = b.size
    if n == 0:
        return g, prev
    amin = float(a.min())
    if amin <= 0.0:
        # a zero coefficient hard-resets the chain; the cumprod identity
        # divides by it, so fall back to the exact scalar recurrence
        for i in range(n):
            prev = a[i] * prev + b[i]
            g[i] = prev
        return g, prev
    block = 4096
    if amin < 1.0:
        # floor 1, not 8: an extreme coefficient (a_min < ~3e-32) needs a
        # block shorter than 8 to keep a_min**block above the denormal range
        block = max(1, min(4096, int(-575.0 / np.log(amin))))
    for start in range(0, n, block):
        stop = min(start + block, n)
        A = np.cumprod(a[start:stop])
        # belt-and-braces: block sizing keeps A >= ~1e-250, but degenerate
        # parameters (sub-denormal coefficients) must degrade to finite
        # output, not divide-by-zero inf
        B = A * np.cumsum(b[start:stop] / np.where(A == 0.0, 1.0, A))
        g[start:stop] = A * prev + B
        prev = float(g[stop - 1])
    return g, g[-1]


class RefResampler:
    """Float64 whole-signal twin of the exact-polyphase resampler
    (:func:`iq_to_audio_torch.ops.resample.polyphase_resample`).

    ``y[n] = sum_j proto[j*up + (n*down) % up] * x[(n*down)//up - j]`` with
    zero history before the stream.
    """

    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        from ..ops.resample import design_resampler_prototype

        self.up = up
        self.down = down
        self.k = taps_per_phase
        self.proto = design_resampler_prototype(up, down, taps_per_phase)

    def resample_all(self, x: np.ndarray) -> np.ndarray:
        """All outputs whose base input index falls inside ``x``."""
        if self.up == self.down:
            return np.asarray(x, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        total = (x.size * self.up + self.down - 1) // self.down
        out = np.empty(total, dtype=np.float64)
        jj = np.arange(self.k)
        for n in range(total):
            ip, phi = divmod(n * self.down, self.up)
            src = ip - jj
            taps = self.proto[jj * self.up + phi]
            valid = (src >= 0) & (src < x.size)
            out[n] = float(np.dot(taps[valid], x[src[valid]]))
        return out


def ref_demod_chain(
    iq: np.ndarray,
    *,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
    mode: str = "nfm",
    deemph_us: float = 300.0,
    agc_enabled: bool = True,
    mix_sign: int = 1,
    filter_block: int = 65_536,
) -> tuple[np.ndarray, float]:
    """Whole-signal reference chain: mix -> filter -> decimate -> demod.

    Returns (audio at channel rate, fs_channel).  Resampling to 48 kHz is a
    separate stage (see :class:`RefResampler`).
    """
    osc = RefOscillator(freq_offset, sample_rate)
    fir = RefOverlapSaveFIR(taps, filter_block)
    dec = RefDecimator(decimation)
    mixed = osc.mix(iq, mix_sign)
    decimated = dec.process(fir.process(mixed))
    fs_channel = sample_rate / max(decimation, 1)
    mode = mode.lower()
    if mode in {"nfm", "fm"}:
        demod = RefQuadratureDemod().process(decimated)
        audio = RefDeemphasis(deemph_us, fs_channel).process(demod)
    elif mode == "am":
        audio = RefDCBlocker().process(np.abs(decimated))
    elif mode in {"usb", "ssb", "lsb"}:
        analytic = np.conj(decimated) if mode == "lsb" else decimated
        audio = RefDCBlocker().process(analytic.real)
        if agc_enabled:
            audio = RefAGC().process(audio)
    else:
        raise ValueError(f"Unsupported demod mode '{mode}'.")
    return np.asarray(audio, dtype=np.float64), fs_channel


def mix_probe_len(n_warm: int, sample_rate: float, n_taps: int) -> int:
    """Samples of the warm-up block the mixer-sign probe reads."""
    max_len = max(int(sample_rate * 0.05), n_taps * 4, 131_072)
    snippet_len = min(n_warm, max_len)
    if snippet_len < n_taps:
        snippet_len = min(n_warm, n_taps * 2)
    return snippet_len


def mix_sign_powers(
    warmup: np.ndarray,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
) -> tuple[float, float]:
    """Mean power of the filtered, decimated warm-up snippet mixed by
    ``exp(-j*s*2*pi*f*n/fs)`` for ``s = +1`` and ``s = -1`` (reference
    ``processing.py:623-663``); ``-inf`` for an empty warm-up."""
    if warmup.size == 0:
        return -np.inf, -np.inf
    snippet_len = mix_probe_len(warmup.size, sample_rate, len(taps))
    snippet = np.asarray(warmup[:snippet_len], dtype=np.complex128)
    n = np.arange(snippet.size, dtype=np.float64)
    decim = max(decimation, 1)
    block_size = min(snippet.size, max(len(taps), 16_384))

    powers = []
    for sign in (1, -1):
        osc = np.exp(-1j * sign * 2.0 * np.pi * freq_offset * n / sample_rate)
        fir = RefOverlapSaveFIR(taps, block_size)
        decimated = fir.process(snippet * osc)[::decim]
        if decimated.size == 0:
            power = -np.inf
        else:
            discard = min(len(taps), decimated.size // 4)
            useful = decimated[discard:]
            if useful.size == 0:
                useful = decimated
            power = float(np.mean(np.abs(useful) ** 2))
        powers.append(power)
    return powers[0], powers[1]


def pick_mix_sign(powers: tuple[float, float]) -> int:
    """The sign of the larger of the powers at ``+1`` and ``-1``: a strict
    ``>``, so ``+1`` wins a tie."""
    best_sign, best_power = 1, -np.inf
    for sign, power in zip((1, -1), powers):
        if power > best_power:
            best_power, best_sign = power, sign
    return best_sign


def choose_mix_sign(
    warmup: np.ndarray,
    sample_rate: float,
    freq_offset: float,
    taps: np.ndarray,
    decimation: int,
) -> int:
    """Warm-up mixer-sign probe (reference ``processing.py:623-663``).

    The host path of the probe: the run's sign on a CPU device, and the
    float64 reference that ``ops/mix_probe.py``'s kernel, which decides the
    sign on a CUDA device, is held to.
    """
    return pick_mix_sign(mix_sign_powers(warmup, sample_rate, freq_offset, taps, decimation))
