"""ShortTimeFFT: scipy.signal.ShortTimeFFT-parity sliding-window STFT.

The modern scipy STFT API (scipy >= 1.9): an object holding (window, hop,
fs) with invertibility via the canonical dual window, four FFT modes,
magnitude/psd scalings, and the full index algebra (p_min/p_max/k_min/
k_max/borders) for non-centered windows.  Semantics verified against
scipy.signal.ShortTimeFFT in tests/test_short_time_fft.py.

Design differences from scipy's per-slice Python loops:
  * `stft` frames the (statically) padded signal with the scatter-free
    gather framing of ops/stft.py and runs ALL slices as one batched
    R2C/C2C transform — one jitted program per
    (shape, slice-range, padding) configuration.
  * `istft` reconstructs with a scatter-free overlap-add: frames are
    split into ceil(m_num/hop) hop-sized slices and summed as shifted
    whole-array adds (no flat-index scatter, see ops/stft.py).
  * Windows and dual windows are f64 host arrays cast once (CLAUDE.md).

Real-valued windows only (complex windows are rejected; scipy allows
them but none of the scipy.signal.windows set is complex).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.complex_utils import merge, promote_to_split

__all__ = ["ShortTimeFFT"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_MODES = ("zeros", "edge", "even", "odd")


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Minimal-L2-norm dual window (scipy algorithm); raises ValueError
    if the (win, hop) pair is not invertible."""
    if hop > len(win):
        raise ValueError(f"hop={hop} larger than window length {len(win)}"
                         " => STFT not invertible!")
    w2 = win * win
    DD = w2.copy()
    for k_ in range(hop, len(win), hop):
        DD[k_:] += w2[:-k_]
        DD[:-k_] += w2[k_:]
    relative_resolution = np.finfo(win.dtype).resolution * DD.max()
    if not np.all(DD >= relative_resolution):
        raise ValueError("Short-time Fourier Transform not invertible!")
    return win / DD


class ShortTimeFFT:
    """Sliding-window STFT/ISTFT with scipy.signal.ShortTimeFFT semantics.

    The zeroth slice is centered at t = 0 (sample index 0); slice p is
    centered at t = p * hop / fs, covering signal samples
    [p*hop - m_num_mid, p*hop - m_num_mid + m_num).
    """

    def __init__(self, win, hop: int, fs: float, *,
                 fft_mode: str = "onesided", mfft: int | None = None,
                 dual_win=None, scale_to: str | None = None,
                 phase_shift: int | None = 0):
        if np.iscomplexobj(win):
            raise ValueError("complex windows are not supported")
        win = np.asarray(win, np.float64)
        if win.ndim != 1 or win.size == 0:
            raise ValueError("win must be a non-empty 1-D array")
        if not np.all(np.isfinite(win)):
            raise ValueError("win must be finite")
        if not (isinstance(hop, (int, np.integer)) and hop >= 1):
            raise ValueError(f"hop={hop} must be a positive integer")
        if fft_mode not in _FFT_MODES:
            raise ValueError(f"fft_mode={fft_mode!r} not in {_FFT_MODES}")
        self._win = win
        self._hop = int(hop)
        self._fs = float(fs)
        self.fft_mode = fft_mode
        self._mfft = int(mfft) if mfft is not None else len(win)
        if self._mfft < len(win):
            raise ValueError("mfft must be >= window length")
        if phase_shift is not None and not (
                -self.mfft < phase_shift < self.mfft):
            raise ValueError(f"phase_shift={phase_shift} out of range")
        self.phase_shift = phase_shift
        self._dual_win = (None if dual_win is None
                          else np.asarray(dual_win, np.float64))
        if self._dual_win is not None and self._dual_win.shape != win.shape:
            raise ValueError("dual_win must have the same shape as win")
        self._scaling = None
        self._impl_cache: dict = {}
        if scale_to is not None:
            self.scale_to(scale_to)
        if fft_mode == "onesided2X" and self._scaling is None:
            raise ValueError(
                "fft_mode='onesided2X' requires scale_to 'magnitude' or "
                "'psd' (scipy parity)")

    # ---- window / scaling ----
    @property
    def win(self):
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @property
    def mfft(self) -> int:
        return self._mfft

    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def scaling(self):
        return self._scaling

    @property
    def fac_magnitude(self) -> float:
        if self._scaling == "magnitude":
            return 1.0
        return 1.0 / abs(self._win.sum())

    @property
    def fac_psd(self) -> float:
        if self._scaling == "psd":
            return 1.0
        return 1.0 / np.sqrt((self._win ** 2).sum() / self.T)

    def scale_to(self, scaling: str):
        """Scale the window (and dual) for 'magnitude' or 'psd' STFT."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError(f"scaling={scaling!r} not in ('magnitude','psd')")
        if self._scaling == scaling:
            return
        s_fac = self.fac_psd if scaling == "psd" else self.fac_magnitude
        self._win = self._win * s_fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / s_fac
        self._scaling = scaling
        self._impl_cache.clear()

    @property
    def dual_win(self):
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self._win, self._hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            return len(self.dual_win) > 0
        except ValueError:
            return False

    # ---- frequency axis ----
    @property
    def onesided_fft(self) -> bool:
        return self.fft_mode in ("onesided", "onesided2X")

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.onesided_fft else self.mfft

    @property
    def delta_f(self) -> float:
        return 1.0 / (self.mfft * self.T)

    @property
    def f(self):
        if self.onesided_fft:
            return np.fft.rfftfreq(self.mfft, self.T)
        if self.fft_mode == "centered":
            return np.fft.fftshift(np.fft.fftfreq(self.mfft, self.T))
        return np.fft.fftfreq(self.mfft, self.T)

    # ---- time/slice index algebra (scipy semantics) ----
    @property
    def delta_t(self) -> float:
        return self.T * self._hop

    @functools.cached_property
    def _pre_padding(self) -> tuple[int, int]:
        w2 = self._win ** 2
        n0 = -self.m_num_mid
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self._hop)):
            n_next = n_ - self._hop
            if n_next + self.m_num <= 0 or np.all(w2[n_next:] == 0):
                return n_, -p_
        raise RuntimeError("unreachable")

    @property
    def p_min(self) -> int:
        return self._pre_padding[1]

    @property
    def k_min(self) -> int:
        return self._pre_padding[0]

    @functools.lru_cache(maxsize=8)
    def _post_padding(self, n: int) -> tuple[int, int]:
        if n < self.m_num - self.m_num_mid:
            raise ValueError("n must be >= ceil(m_num/2)")
        w2 = self._win ** 2
        q1 = n // self._hop
        k1 = q1 * self._hop - self.m_num_mid
        for q_, k_ in enumerate(range(k1, n + self.m_num, self._hop),
                                start=q1):
            n_next = k_ + self._hop
            if n_next >= n or np.all(w2[:n - n_next] == 0):
                return k_ + self.m_num, q_ + 1
        raise RuntimeError("unreachable")

    def p_max(self, n: int) -> int:
        return self._post_padding(n)[1]

    def k_max(self, n: int) -> int:
        return self._post_padding(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @functools.cached_property
    def lower_border_end(self) -> tuple[int, int]:
        m0 = int(np.flatnonzero(self._win ** 2)[0])
        k0 = -self.m_num_mid + m0
        for q_, k_ in enumerate(range(k0, self._hop + 1, self._hop)):
            if k_ + self._hop >= 0:
                return k_ + self.m_num, q_ + 1
        return 0, max(self.p_min, 0)

    @functools.lru_cache(maxsize=8)
    def upper_border_begin(self, n: int) -> tuple[int, int]:
        w2 = self._win ** 2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + (self.m_num - self.m_num_mid)
            if k_ <= n or np.all(w2[n - k_:] == 0):
                return (q_ + 1) * self._hop - self.m_num_mid, q_ + 1
        return 0, 0

    def p_range(self, n: int, p0: int | None = None,
                p1: int | None = None) -> tuple[int, int]:
        p_max = self.p_max(n)
        p0_ = self.p_min if p0 is None else p0
        p1_ = p_max if p1 is None else p1
        if not (self.p_min <= p0_ < p1_ <= p_max):
            raise ValueError(
                f"invalid p0={p0}, p1={p1}: need {self.p_min} <= p0 < p1 "
                f"<= {p_max} for n={n}")
        return p0_, p1_

    def t(self, n: int, p0: int | None = None, p1: int | None = None,
          k_offset: int = 0):
        p0, p1 = self.p_range(n, p0, p1)
        return np.arange(p0, p1) * self.delta_t + k_offset * self.T

    def nearest_k_p(self, k: int, left: bool = True) -> int:
        p_q, remainder = divmod(k, self._hop)
        if remainder == 0:
            return k
        return p_q * self._hop if left else (p_q + 1) * self._hop

    # ---- the transforms ----
    def _pad_coeffs(self, n: int, k_start: int, k_end: int, padding: str):
        """Static gather plan realizing scipy's border padding as
        v[k] = c1 * x[i1] + c2 * x[i2] (numpy, trace-time constants)."""
        k = np.arange(k_start, k_end)
        i1 = np.clip(k, 0, n - 1)
        inside = (k >= 0) & (k < n)
        if padding == "zeros":
            c1 = inside.astype(np.float32)
            return i1, c1, i1, np.zeros_like(c1)
        if padding == "edge":
            return i1, np.ones(len(k), np.float32), i1, np.zeros(len(k),
                                                                 np.float32)
        # reflection index (period 2n-2), numpy 'reflect' convention
        if n == 1:
            refl = np.zeros_like(k)
        else:
            m = np.mod(k, 2 * n - 2)
            refl = np.where(m < n, m, 2 * n - 2 - m)
        if padding == "even":
            return refl, np.ones(len(k), np.float32), refl, np.zeros(
                len(k), np.float32)
        if padding == "odd":
            c1 = np.where(inside, 0.0, 2.0).astype(np.float32)
            c2 = np.where(inside, 1.0, -1.0).astype(np.float32)
            return i1, c1, refl, c2
        raise ValueError(f"padding={padding!r} not in {_PAD_MODES}")

    def _fft_frames(self, fr, fi):
        """FFT of windowed frames [..., P, m_num] (split; fi None for
        real) -> split [..., P, f_pts] per fft_mode/phase_shift."""
        from ..core.twiddle import FORWARD
        from ..ops.nd import fftn_split
        from ..ops.rfft import rfft_last_split

        mfft, m_num = self.mfft, self.m_num
        pad = [(0, 0)] * (fr.ndim - 1) + [(0, mfft - m_num)]
        fr = jnp.pad(fr, pad)
        if fi is not None:
            fi = jnp.pad(fi, pad)
        if self.phase_shift is not None:
            p_s = (self.phase_shift + self.m_num_mid) % m_num
            fr = jnp.roll(fr, -p_s, axis=-1)
            if fi is not None:
                fi = jnp.roll(fi, -p_s, axis=-1)
        if self.onesided_fft:
            if fi is not None:
                raise ValueError(
                    "complex input requires fft_mode 'twosided'/'centered'")
            if mfft % 2 == 0:
                Xr, Xi = rfft_last_split(fr, None)
            else:
                Xr, Xi = fftn_split(fr, jnp.zeros_like(fr),
                                    (fr.ndim - 1,), FORWARD, None)
                Xr, Xi = Xr[..., :mfft // 2 + 1], Xi[..., :mfft // 2 + 1]
            if self.fft_mode == "onesided2X":
                fac = np.sqrt(2.0) if self._scaling == "psd" else 2.0
                mult = np.full(mfft // 2 + 1, fac, np.float32)
                mult[0] = 1.0
                if mfft % 2 == 0:
                    mult[-1] = 1.0
                Xr, Xi = Xr * mult, Xi * mult
            return Xr, Xi
        Xr, Xi = fftn_split(fr, jnp.zeros_like(fr) if fi is None else fi,
                            (fr.ndim - 1,), FORWARD, None)
        if self.fft_mode == "centered":
            Xr = jnp.roll(Xr, mfft // 2, axis=-1)
            Xi = jnp.roll(Xi, mfft // 2, axis=-1)
        return Xr, Xi

    def stft(self, x, p0: int | None = None, p1: int | None = None, *,
             k_offset: int = 0, padding: str = "zeros", axis: int = -1):
        """STFT of `x` along `axis`: complex output with the frequency
        axis at `axis`'s position and the time slices appended last."""
        from .spectral_est import _is_complex

        xr, xi = promote_to_split(x)
        is_c = _is_complex(x)
        if not is_c:
            xi = None
        if is_c and self.onesided_fft:
            raise ValueError(
                "complex input requires fft_mode 'twosided' or 'centered'")
        n = xr.shape[axis]
        p0, p1 = self.p_range(n, p0, p1)
        key = ("stft", xr.shape, axis, p0, p1, k_offset, padding, is_c,
               self.fft_mode, self.phase_shift, self._scaling)
        impl = self._impl_cache.get(key)
        if impl is None:
            mid = self.m_num_mid
            k_start = p0 * self._hop - mid + k_offset
            k_end = (p1 - 1) * self._hop - mid + self.m_num + k_offset
            i1, c1, i2, c2 = self._pad_coeffs(n, k_start, k_end, padding)
            win32 = self._win.astype(np.float32)
            num = p1 - p0

            from .stft import _frame

            @jax.jit
            def impl(vr, vi):
                def blend(v):
                    v = jnp.moveaxis(v, axis, -1)
                    return v[..., i1] * c1 + v[..., i2] * c2

                def prep(v):
                    return _frame(blend(v), self.m_num,
                                  self._hop)[..., :num, :] * win32

                Xr, Xi = self._fft_frames(
                    prep(vr), prep(vi) if vi is not None else None)
                # [..., P, f] -> [..., f, P], f to `axis`'s position
                Xr = jnp.swapaxes(Xr, -1, -2)
                Xi = jnp.swapaxes(Xi, -1, -2)
                ax = axis if axis >= 0 else Xr.ndim - 1 + axis
                return (jnp.moveaxis(Xr, -2, ax), jnp.moveaxis(Xi, -2, ax))

            self._impl_cache[key] = impl
        Xr, Xi = impl(xr, xi)
        return merge(Xr, Xi)

    def spectrogram(self, x, y=None, **kwargs):
        """abs(S)**2 of the STFT (or Sx * conj(Sy) when `y` is given)."""
        Sx = self.stft(x, **kwargs)
        if y is None:
            return jnp.real(Sx) ** 2 + jnp.imag(Sx) ** 2
        Sy = self.stft(y, **kwargs)
        return Sx * jnp.conj(Sy)

    def _ifft_frames(self, Xr, Xi):
        """Inverse of _fft_frames on [..., P, f_pts] -> [..., P, m_num]
        split (imag part is None for onesided)."""
        from ..core.twiddle import INVERSE
        from ..ops.nd import fftn_split
        from ..ops.rfft import irfft_last_split

        mfft, m_num = self.mfft, self.m_num
        if self.onesided_fft:
            if self.fft_mode == "onesided2X":
                fac = np.sqrt(2.0) if self._scaling == "psd" else 2.0
                mult = np.full(mfft // 2 + 1, 1.0 / fac, np.float32)
                mult[0] = 1.0
                if mfft % 2 == 0:
                    mult[-1] = 1.0
                Xr, Xi = Xr * mult, Xi * mult
            if mfft % 2 == 0:
                xr = irfft_last_split(Xr, Xi, mfft, 1.0 / mfft)
            else:
                # odd mfft: Hermitian-extend the half spectrum and run the
                # C2C inverse (the packed C2R kernel is even-length only)
                Fr = jnp.concatenate([Xr, Xr[..., 1:][..., ::-1]], axis=-1)
                Fi = jnp.concatenate([Xi, -Xi[..., 1:][..., ::-1]], axis=-1)
                xr, _ = fftn_split(Fr, Fi, (Fr.ndim - 1,), INVERSE,
                                   1.0 / mfft)
            xi = None
        else:
            if self.fft_mode == "centered":
                Xr = jnp.roll(Xr, -(mfft // 2), axis=-1)
                Xi = jnp.roll(Xi, -(mfft // 2), axis=-1)
            xr, xi = fftn_split(Xr, Xi, (Xr.ndim - 1,), INVERSE, 1.0 / mfft)
        if self.phase_shift is not None:
            p_s = (self.phase_shift + self.m_num_mid) % m_num
            xr = jnp.roll(xr, p_s, axis=-1)
            if xi is not None:
                xi = jnp.roll(xi, p_s, axis=-1)
        return (xr[..., :m_num], xi[..., :m_num] if xi is not None else None)

    @staticmethod
    def _ola(frames, hop: int):
        """Scatter-free overlap-add of [..., Q, m] frames at stride hop:
        returns [..., (Q-1)*hop + m]."""
        m = frames.shape[-1]
        c = -(-m // hop)  # ceil
        q = frames.shape[-2]
        pad = [(0, 0)] * (frames.ndim - 1) + [(0, c * hop - m)]
        z = jnp.pad(frames, pad).reshape(*frames.shape[:-1], c, hop)
        out = jnp.zeros((*frames.shape[:-2], q + c - 1, hop),
                        frames.dtype)
        for j in range(c):
            out = out.at[..., j:j + q, :].add(z[..., :, j, :])
        flat = out.reshape(*frames.shape[:-2], (q + c - 1) * hop)
        return flat[..., :(q - 1) * hop + m]

    def istft(self, S, k0: int = 0, k1: int | None = None, *,
              f_axis: int = -2, t_axis: int = -1):
        """Inverse STFT: reconstructs x[k0:k1] from slices assumed to
        start at p_min (scipy semantics).  Returns real output for
        onesided modes, complex otherwise."""
        Sr, Si = promote_to_split(S)
        if f_axis == t_axis:
            raise ValueError("f_axis may not equal t_axis")
        if Sr.shape[f_axis] != self.f_pts:
            raise ValueError(f"S.shape[f_axis]={Sr.shape[f_axis]} must equal "
                             f"f_pts={self.f_pts}")
        n_min = self.m_num - self.m_num_mid
        if Sr.shape[t_axis] < self.p_num(n_min):
            raise ValueError("not enough time slices to invert")
        Sr = jnp.moveaxis(Sr, (f_axis, t_axis), (-2, -1))
        Si = jnp.moveaxis(Si, (f_axis, t_axis), (-2, -1))
        q_max = Sr.shape[-1] + self.p_min
        k_max = (q_max - 1) * self._hop + self.m_num - self.m_num_mid
        k1 = k_max if k1 is None else k1
        if not (self.k_min <= k0 < k1 <= k_max):
            raise ValueError(f"need k_min={self.k_min} <= k0={k0} < k1={k1}"
                             f" <= k_max={k_max}")
        if k1 - k0 < n_min:
            raise ValueError("k1 - k0 must be at least ceil(m_num/2)")
        key = ("istft", Sr.shape, k0, k1,
               self.fft_mode, self.phase_shift, self._scaling)
        impl = self._impl_cache.get(key)
        if impl is None:
            dual32 = np.asarray(self.dual_win, np.float32)
            base = self.p_min * self._hop - self.m_num_mid
            lo, hi = k0 - base, k1 - base

            @jax.jit
            def impl(Sr, Si):
                fr, fi = self._ifft_frames(jnp.swapaxes(Sr, -1, -2),
                                           jnp.swapaxes(Si, -1, -2))
                xr = self._ola(fr * dual32, self._hop)[..., lo:hi]
                if fi is None:
                    return xr, None
                return xr, self._ola(fi * dual32, self._hop)[..., lo:hi]

            self._impl_cache[key] = impl
        xr, xi = impl(Sr, Si)
        return xr if xi is None else merge(xr, xi)
