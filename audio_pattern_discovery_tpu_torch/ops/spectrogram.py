"""Windowed-DFT spectrogram extraction in PyTorch.

Port of ``audio_pattern_discovery_tpu/ops/spectrogram.py``.  The chain
frame -> window -> real DFT -> |.|^p -> log10 (and the optional mel / MFCC
heads) runs on the device over a group of padded clips at a time.  The real
DFT is one fp32 ``torch.matmul`` against the packed ``[cos | sin]`` matrix
(``fft_impl="matmul"``, the default; ``"rfft"`` uses ``torch.fft.rfft``);
TF32 is off, so every ``fft_precision`` runs in full fp32.  The mel
filterbank and DCT matrices are built on the host with NumPy, as in the
reference.

Tiling is simpler than the reference's: clips go in groups of
``clip_batch``, each group padded to its longest clip, and the frames of a
group in chunks of ``chunk_frames``.  Frames do not straddle chunks (framing
is a view of the whole clip), so the result equals a single-shot call.
Samples reach the device as float32, as int16 PCM, or as 8-bit mu-law
codes of the peak-normalized signal (``upload_codec="mulaw8"``), each
decoded on the device (``decode_signals``).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.config import SpectrogramConfig
from audio_pattern_discovery_tpu_torch.utils.device import (
    on_device,
    resolve_device,
    resolve_devices,
)


def window_array(name: str, win_length: int) -> np.ndarray:
    """Periodic windows matching oracle/stft.py (reference-style)."""
    n = np.arange(win_length, dtype=np.float32)
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if name == "hamming":
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if name == "rect":
        return np.ones(win_length, dtype=np.float32)
    raise ValueError(f"unknown window {name!r}")


def num_frames(n_samples: int, win_length: int, hop_length: int) -> int:
    if n_samples < win_length:
        return 0
    return 1 + (n_samples - win_length) // hop_length


def hz_to_mel(f):
    """HTK mel scale: m = 2595 * log10(1 + f / 700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_bins: int,
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """[n_bins, n_mels] triangular HTK-mel filterbank (peak height 1); a
    host NumPy copy of the reference's function.  Raises if any filter has
    empty support."""
    bin_hz = np.arange(n_bins, dtype=np.float64) * (sample_rate / n_fft)
    top_hz = float(bin_hz[-1])
    fmax = min(top_hz, float(fmax) if fmax is not None else sample_rate / 2.0)
    if not 0.0 <= fmin < fmax:
        raise ValueError(f"mel range [{fmin}, {fmax}] Hz is empty")
    edges_hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    lo, ctr, hi = edges_hz[:-2], edges_hz[1:-1], edges_hz[2:]
    up = (bin_hz[:, None] - lo[None, :]) / np.maximum(ctr - lo, 1e-12)[None, :]
    down = (hi[None, :] - bin_hz[:, None]) / np.maximum(hi - ctr, 1e-12)[None, :]
    fb = np.maximum(0.0, np.minimum(up, down))              # [n_bins, n_mels]
    empty = np.where(fb.sum(axis=0) <= 0.0)[0]
    if empty.size:
        raise ValueError(
            f"mel filter(s) {empty.tolist()} have no FFT-bin support: "
            f"n_mels={n_mels} exceeds the resolution of {n_bins} bins over "
            f"[{fmin:.0f}, {fmax:.0f}] Hz — reduce n_mels or raise "
            "max_bins/n_fft"
        )
    return fb.astype(np.float32)


def dct_ortho(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II matrix (scipy.fft.dct norm='ortho'
    convention): out[j] = sum_i x[i] * c_j * cos(pi*(2i+1)*j / (2*n_in))."""
    i = np.arange(n_in, dtype=np.float64)[:, None]
    j = np.arange(n_out, dtype=np.float64)[None, :]
    m = np.cos(np.pi * (2.0 * i + 1.0) * j / (2.0 * n_in)) * np.sqrt(2.0 / n_in)
    m[:, 0] *= np.sqrt(0.5)
    return m.astype(np.float32)


# 8-bit mu-law companding (mu=255) over peak-normalized samples: the
# optional half-of-int16 upload codec (SpectrogramConfig.upload_codec=
# "mulaw8"), as in the reference.
_MULAW_MU = 255.0


def mulaw_encode_host(x: np.ndarray) -> np.ndarray:
    """float in [-1, 1] -> int8 codes in [-127, 127] (host side; the
    reference's NumPy function)."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MULAW_MU * np.abs(x)) / np.log1p(_MULAW_MU)
    return np.round(y * 127.0).astype(np.int8)


def mulaw_decode_device(q: torch.Tensor) -> torch.Tensor:
    """int8 codes -> float32 samples on the device of ``q``."""
    y = q.float() / 127.0
    return torch.sign(y) * (torch.pow(1.0 + _MULAW_MU, torch.abs(y)) - 1.0) / _MULAW_MU


def _dft_matrix(win_length: int, n_fft: int, device) -> torch.Tensor:
    """[rows, 2*bins] packed [cos | sin] real-DFT matrix (rfft semantics:
    zero-padding past win contributes nothing, truncation drops the tail)."""
    bins = n_fft // 2 + 1
    rows = min(win_length, n_fft)
    k = 2.0 * np.pi / n_fft * np.outer(np.arange(rows, dtype=np.float64), np.arange(bins))
    cs = np.concatenate([np.cos(k), np.sin(k)], axis=1).astype(np.float32)
    return torch.from_numpy(cs).to(device)


def frame_energy(
    spectrograms: torch.Tensor, log_scale: bool = True, power: float = 2.0
) -> torch.Tensor:
    """Per-frame energy [B, F]: log10 of *mean power* across bins (the
    segmentation gate's input; see the reference for why mean power)."""
    lin = torch.pow(10.0, spectrograms) if log_scale else spectrograms
    if power != 2.0:
        lin = torch.clamp(lin, min=0.0) ** (2.0 / power)
    return torch.log10(torch.clamp(torch.mean(lin, dim=-1), min=1e-10))


def batched_spectrogram(
    signals: torch.Tensor,             # [B, N] padded float32
    lengths: torch.Tensor,             # [B] int true sample counts
    *,
    win_length: int = 1024,
    hop_length: int = 256,
    window: str = "hann",
    n_fft: int | None = None,
    power: float = 2.0,
    log_scale: bool = True,
    log_floor: float = 1e-10,
    max_bins: int | None = None,
    fft_impl: str = "matmul",
    fft_precision: str = "high",
    feature: str = "bins",
    n_mels: int = 64,
    n_mfcc: int = 20,
    sample_rate: int = 44_100,
    fmin: float = 0.0,
    fmax: float | None = None,
    return_energy: bool = False,
    frame_range: tuple[int, int] | None = None,
):
    """[B, N] padded signals -> ([B, F, feat] features, [B] frame counts[,
    [B, F] energy]).

    Frames past a clip's true frame count hold the pad fill
    (``feature_pad_fill``).  ``frame_range=(f0, f1)`` computes only frames
    f0..f1-1 (frame counts stay whole-clip).  ``fft_precision`` is accepted
    for config compatibility: every setting runs in fp32."""
    if signals.dim() != 2 or lengths.shape != (signals.shape[0],):
        raise ValueError("signals must be [B, N] and lengths [B]")
    del fft_precision
    B, N = signals.shape
    n_fft = n_fft or win_length
    F = num_frames(N, win_length, hop_length)
    if F == 0:
        raise ValueError(f"padded length {N} shorter than win_length {win_length}")
    f0, f1 = frame_range or (0, F)
    dev = signals.device
    frames = signals.unfold(1, win_length, hop_length)[:, f0:f1]   # [B, F', win] view
    frames = frames * torch.from_numpy(window_array(window, win_length)).to(dev)

    if fft_impl == "matmul":
        bins = n_fft // 2 + 1
        rows = min(win_length, n_fft)
        reim = torch.matmul(frames[..., :rows], _dft_matrix(win_length, n_fft, dev))
        re, im = reim[..., :bins], reim[..., bins:]
        p2 = torch.clamp(re * re + im * im, min=0.0)
    elif fft_impl == "rfft":
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
        p2 = spec.real ** 2 + spec.imag ** 2
    else:
        raise ValueError(f"unknown fft_impl {fft_impl!r}")
    if power == 2.0:
        out = p2
    elif power == 1.0:
        out = torch.sqrt(p2)
    else:
        out = p2 ** (power / 2.0)
    if max_bins is not None:
        out = out[..., :max_bins]

    lengths = lengths.to(dev).long()
    frame_counts = torch.where(
        lengths >= win_length, 1 + (lengths - win_length) // hop_length, 0
    ).to(torch.int32)
    frame_ids = torch.arange(f0, f1, device=dev)[None, :, None]
    valid = frame_ids < frame_counts[:, None, None]
    floor_log = float(np.log10(np.float32(log_floor)))

    def _bins_output(lin):
        if log_scale:
            o = torch.log10(torch.clamp(lin, min=log_floor))
            return torch.where(valid, o, floor_log)
        return torch.where(valid, lin, 0.0)

    energy = None
    if return_energy:
        energy = frame_energy(_bins_output(out), log_scale=log_scale, power=power)

    if feature == "bins":
        feats = _bins_output(out)
    elif feature in ("mel", "mfcc"):
        fb = torch.from_numpy(
            mel_filterbank(out.shape[-1], sample_rate, n_fft, n_mels, fmin, fmax)
        ).to(dev)
        melp = torch.matmul(torch.where(valid, out, 0.0), fb)
        if feature == "mel":
            if log_scale:
                feats = torch.where(
                    valid, torch.log10(torch.clamp(melp, min=log_floor)), floor_log
                )
            else:
                feats = torch.where(valid, melp, 0.0)
        else:  # mfcc: log compression of the mel bands is definitional
            logmel = torch.log10(torch.clamp(melp, min=log_floor))
            mf = torch.matmul(logmel, torch.from_numpy(dct_ortho(n_mels, n_mfcc)).to(dev))
            feats = torch.where(valid, mf, 0.0)
    else:
        raise ValueError(f"unknown feature {feature!r}")

    feats = feats.float()
    if return_energy:
        return feats, frame_counts, energy
    return feats, frame_counts


def feature_pad_fill(cfg: SpectrogramConfig) -> float:
    """The constant that pad frames (and rows past a clip's frame count)
    hold in assembled feature arrays — matches batched_spectrogram's mask."""
    if cfg.feature == "mfcc" or not cfg.log_scale:
        return 0.0
    return float(np.log10(np.float32(cfg.log_floor)))


def _cfg_kwargs(cfg: SpectrogramConfig) -> dict:
    return dict(
        win_length=cfg.win_length,
        hop_length=cfg.hop_length,
        window=cfg.window,
        n_fft=cfg.n_fft,
        power=cfg.power,
        log_scale=cfg.log_scale,
        log_floor=cfg.log_floor,
        max_bins=cfg.max_bins,
        fft_impl=cfg.fft_impl,
        fft_precision=cfg.fft_precision,
        feature=cfg.feature,
        n_mels=cfg.n_mels,
        n_mfcc=cfg.n_mfcc,
        sample_rate=cfg.sample_rate,
        fmin=cfg.fmin,
        fmax=cfg.fmax,
    )


def decode_signals(sig: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    """Device-side sample decode: int16 PCM -> x/32768 (then / per-clip
    scale when normalizing, bit-identical to the host's x/peak); int8 mu-law
    codes of the peak-normalized signal -> samples (then * per-clip scale,
    which restores the amplitude when not normalizing); float32 passes
    through."""
    if sig.dtype == torch.int16:
        sig = sig.float() / 32768.0
        if scales is not None:
            sig = sig / scales[:, None]
        return sig
    if sig.dtype == torch.int8:
        sig = mulaw_decode_device(sig)
        if scales is not None:
            sig = sig * scales[:, None]
        return sig
    if sig.dtype != torch.float32:
        raise ValueError(f"unsupported sample dtype {sig.dtype}")
    return sig


def spectrogram_corpus(
    sigs,
    cfg: SpectrogramConfig,
    *,
    device: torch.device | str = "cuda",
    clip_batch: int = 16,
    chunk_frames: int = 1024,
    return_device: bool = False,
    scales=None,
    sig_lengths: np.ndarray | None = None,
    devices: list | None = None,
) -> tuple[np.ndarray | torch.Tensor, np.ndarray, np.ndarray]:
    """Ragged clips -> ([B, F_max, feat] features, [B] frame counts,
    [B, F_max] frame energies).

    ``sigs`` is a sequence of 1-D int16, int8 (mu-law) or float32 arrays
    (uniform dtype); ``scales`` (optional [B]) divides int16 clips and
    multiplies mu-law clips after decode (``decode_signals``).  Features
    come back as a tensor on ``device`` with ``return_device``, else as a
    host array; energies always on the host (segmentation is host code).
    ``device`` is the card unless the caller asks for the CPU; no card
    raises.  ``devices``: a list of devices (it may repeat one) that the
    clip groups round-robin over, group gi on ``devices[gi % n]``, in place
    of ``device``; the groups' features are collected on ``devices[0]``
    (where ``return_device`` leaves them), bit for bit what one device
    gives.  The energies come to the host once every group is queued, so
    no group's launch waits for another group's download."""
    if not len(sigs):
        raise ValueError("empty corpus")
    devs = resolve_devices(devices) if devices is not None else [resolve_device(device)]
    device = devs[0]
    win, hop = cfg.win_length, cfg.hop_length
    B = len(sigs)
    if sig_lengths is None:
        if any(s.dtype != sigs[0].dtype for s in sigs):
            raise ValueError(
                "all clips must share a dtype; mixing int16 and float32 "
                "would silently truncate the float clips in the int16 tile "
                "buffer"
            )
        sig_lengths = np.array([len(s) for s in sigs], dtype=np.int64)
    frames_per_clip = np.array(
        [num_frames(int(n), win, hop) for n in sig_lengths], dtype=np.int32
    )
    F_max = int(frames_per_clip.max())
    if F_max == 0:
        raise ValueError(f"no clip reaches win_length={win} samples")
    CF = int(chunk_frames)
    clip_batch = min(clip_batch, B)
    fill = feature_pad_fill(cfg)
    specs = torch.full((B, F_max, cfg.feature_dim), fill, dtype=torch.float32, device=device)
    energies = np.full((B, F_max), np.log10(np.float32(1e-10)), dtype=np.float32)
    kw = _cfg_kwargs(cfg)
    tile_energies = []
    for gi, g0 in enumerate(range(0, B, clip_batch)):
        dev = devs[gi % len(devs)]
        group = sigs[g0 : g0 + clip_batch]
        g = len(group)
        n_max = max(int(n) for n in sig_lengths[g0 : g0 + g])
        n_pad = max(n_max, win)
        dtype = group[0].dtype if group[0].dtype in (np.int16, np.int8) else np.float32
        buf = np.zeros((g, n_pad), dtype=dtype)
        for k, s in enumerate(group):
            buf[k, : len(s)] = s
        sig = torch.from_numpy(buf).to(dev)
        g_scales = None
        if scales is not None:
            g_scales = torch.from_numpy(
                np.asarray(scales[g0 : g0 + g], np.float32).copy()
            ).to(dev)
        sig = decode_signals(sig, g_scales)
        lens = torch.from_numpy(np.asarray(sig_lengths[g0 : g0 + g], np.int64)).to(dev)
        g_frames = int(frames_per_clip[g0 : g0 + g].max())
        for f0 in range(0, g_frames, CF):
            f1 = min(f0 + CF, g_frames)
            with on_device(dev):
                out, _, en = batched_spectrogram(
                    sig, lens, return_energy=True, frame_range=(f0, f1), **kw
                )
            specs[g0 : g0 + g, f0:f1] = out.to(device)
            tile_energies.append((g0, g, f0, f1, en))
    for g0, g, f0, f1, en in tile_energies:
        energies[g0 : g0 + g, f0:f1] = en.cpu().numpy()
    # Energies of frames past each clip's end keep the floor value.
    fi = np.arange(F_max)[None, :]
    energies[fi >= frames_per_clip[:, None]] = np.log10(np.float32(1e-10))
    if return_device:
        return specs, frames_per_clip.copy(), energies
    return specs.cpu().numpy(), frames_per_clip.copy(), energies
