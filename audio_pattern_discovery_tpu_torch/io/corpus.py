"""Corpus loading + padded batching of ragged clips (SURVEY.md SS3 row 1).

The host reads a directory of WAVs, optionally via the native C++ demuxer,
and packs them into a padded [n_clips, max_len] float32 array with a length
vector — the shape contract the jitted spectrogram op expects (static
shapes; masking handles raggedness, SURVEY.md SS8 P1).

Copy of ``audio_pattern_discovery_tpu/io/corpus.py``; only the import paths differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from audio_pattern_discovery_tpu_torch.io.wavio import read_wav, read_wav_info


@dataclass
class Clip:
    path: str
    samples: np.ndarray  # float32 [n]
    sample_rate: int

    def __len__(self) -> int:
        return len(self.samples)


class StreamingCorpus:
    """Forward-windowed lazy corpus: headers up front, samples on demand.

    Why: at hours scale, fully reading every WAV before the first
    spectrogram tile dispatches serializes ~20 s of file IO in front of the
    (upload-bound) spectrogram stage (VERDICT r2 missing #3).  Header
    probing (read_wav_info) yields every clip's length/rate/format in
    milliseconds, which is all the spectrogram scheduler needs to plan its
    fixed tiles — sample data then loads chunk-by-chunk (native OpenMP
    demuxer per chunk) exactly when the next tile group needs it, hiding
    ingest behind the device pipeline.

    Loaded clips are RETAINED (the extraction stage writes snippets from
    them later), so peak host memory matches the eager loader; only the
    serialization is removed.  Indexing is list-like ([] with int or slice)
    and loading is strictly forward: accessing clip i loads everything up
    to i's chunk.
    """

    def __init__(
        self,
        wav_dir: str | Path,
        pattern: str = "*.wav",
        expected_rate: int | None = None,
        use_native: bool = True,
        chunk: int = 16,
        paths: list[Path] | None = None,
        resample_to: int | None = None,
    ):
        # An explicit `paths` list overrides the sorted glob: incremental
        # update needs prior clips at their original indices (stored order)
        # with new clips appended, which a re-sorted merged listing would
        # interleave.
        self.paths = (
            [Path(p) for p in paths]
            if paths is not None
            else sorted(Path(wav_dir).glob(pattern))
        )
        if not self.paths:
            raise FileNotFoundError(f"no {pattern} files under {wav_dir}")
        self.chunk = max(1, chunk)
        self.use_native = use_native
        info = [read_wav_info(p) for p in self.paths]
        self.sample_lengths = np.array([i[0] for i in info], dtype=np.int64)
        self.sample_rates = np.array([i[1] for i in info], dtype=np.int32)
        self.format_tags = np.array([i[2] for i in info], dtype=np.int32)
        self.bits = np.array([i[3] for i in info], dtype=np.int32)
        self.channels = np.array([i[4] for i in info], dtype=np.int32)
        # Rate unification (spectrogram.resample="auto"): clips at other
        # rates are polyphase-resampled as they load, and the header-probe
        # metadata is rewritten UP FRONT so tile planning (which only sees
        # lengths/rates) already reflects the resampled signal.
        self.original_rates = self.sample_rates.copy()
        self._resample_to = resample_to
        self._resample_mask = (
            self.sample_rates != resample_to
            if resample_to is not None
            else np.zeros(len(self.paths), dtype=bool)
        )
        if self._resample_mask.any():
            from audio_pattern_discovery_tpu_torch.io.resample import resampled_length

            for i in np.where(self._resample_mask)[0]:
                self.sample_lengths[i] = resampled_length(
                    int(self.sample_lengths[i]),
                    int(self.sample_rates[i]),
                    resample_to,
                )
                self.sample_rates[i] = resample_to
        if expected_rate is not None:
            for p, r in zip(self.paths, self.sample_rates):
                if int(r) != expected_rate:
                    raise ValueError(
                        f"{p}: sample rate {int(r)} != expected {expected_rate}"
                    )
        self._clips: list[Clip | None] = [None] * len(self.paths)
        self._loaded = 0

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def all_pcm16(self) -> bool:
        """True when every clip is plain MONO 16-bit PCM (the int16-upload
        path is then exact by construction — read_wav is raw/32768 for mono
        PCM16).  Multichannel PCM16 is excluded: the mono downmix averages
        channels into half-LSB values that int16 re-quantization would
        round, silently breaking the bit-exactness contract."""
        if self._resample_mask.any():
            # Resampled samples are filtered floats; re-quantizing them to
            # int16 would break the exactness contract this property gates.
            return False
        return bool((
            (self.format_tags == 1) & (self.bits == 16) & (self.channels == 1)
        ).all())

    def _load_upto(self, end: int) -> None:
        end = min(len(self.paths), end)
        while self._loaded < end:
            s = self._loaded
            e = min(len(self.paths), s + self.chunk)
            chunk_paths = self.paths[s:e]
            loaded: list[Clip] | None = None
            if self.use_native:
                from audio_pattern_discovery_tpu_torch import native

                res = native.load_wavs_batch(chunk_paths)
                if res is not None:
                    padded, lengths, rates = res
                    loaded = [
                        Clip(str(p), padded[i, : lengths[i]].copy(), int(rates[i]))
                        for i, p in enumerate(chunk_paths)
                    ]
            if loaded is None:
                loaded = []
                for p in chunk_paths:
                    samples, rate = read_wav(p)
                    loaded.append(Clip(str(p), samples, rate))
            if self._resample_mask[s:e].any():
                from audio_pattern_discovery_tpu_torch.io.resample import resample

                for k, c in enumerate(loaded):
                    if self._resample_mask[s + k]:
                        loaded[k] = Clip(
                            c.path,
                            resample(
                                c.samples, c.sample_rate, self._resample_to
                            ),
                            self._resample_to,
                        )
            self._clips[s:e] = loaded
            self._loaded = e

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self.paths))
            self._load_upto(stop)
            return [self._clips[i] for i in range(start, stop, step)]
        if idx < 0:
            idx += len(self.paths)
        self._load_upto(idx + 1)
        return self._clips[idx]

    def materialize(self) -> list[Clip]:
        """Load everything still pending and return the full clip list."""
        self._load_upto(len(self.paths))
        return list(self._clips)

    def view(self, lo: int, hi: int) -> "CorpusView":
        """Contiguous [lo, hi) window sharing this loader (clips load once)."""
        return CorpusView(self, lo, hi)


class CorpusView:
    """A contiguous window over a StreamingCorpus with the same metadata
    surface the pipeline's corpus preparation consumes.  Exists for the
    config-5 upload/training overlap (pipeline.discover two-phase corpus):
    each phase runs the ONE shared derivation over its window, against the
    SAME underlying lazy loader, so clip bytes still load exactly once and
    forward-only."""

    def __init__(self, base: StreamingCorpus, lo: int, hi: int):
        if not 0 <= lo <= hi <= len(base):
            raise ValueError(f"view [{lo}, {hi}) out of range 0..{len(base)}")
        self._base = base
        self._lo, self._hi = lo, hi
        self.paths = base.paths[lo:hi]
        self.sample_lengths = base.sample_lengths[lo:hi]
        self.sample_rates = base.sample_rates[lo:hi]
        self.original_rates = base.original_rates[lo:hi]
        self._resample_mask = base._resample_mask[lo:hi]

    def __len__(self) -> int:
        return self._hi - self._lo

    @property
    def all_pcm16(self) -> bool:
        # The whole-corpus property of the base: a view never claims a
        # stronger exactness contract than the corpus it came from (both
        # phases then pick the SAME codec, keeping the per-clip device
        # decode identical to the single-phase run).
        return self._base.all_pcm16

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            return self._base[self._lo + start : self._lo + stop : step]
        if idx < 0:
            idx += len(self)
        return self._base[self._lo + idx]

    def materialize(self) -> list[Clip]:
        self._base._load_upto(self._hi)
        return list(self._base._clips[self._lo : self._hi])


def load_corpus(
    wav_dir: str | Path,
    pattern: str = "*.wav",
    expected_rate: int | None = None,
    use_native: bool = True,
) -> list[Clip]:
    """Read every WAV under `wav_dir` (sorted for determinism).

    Fast path: the native C++ parallel demuxer (native.load_wavs_batch,
    OpenMP thread pool) ingests plain-PCM16 corpora in bulk; anything it
    can't parse falls back to the per-file Python reader, which handles
    8/24/32-bit and IEEE-float WAVs and is the correctness oracle
    (tested equal in tests/test_native.py).
    """
    paths = sorted(Path(wav_dir).glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no {pattern} files under {wav_dir}")

    clips: list[Clip] | None = None
    if use_native:
        from audio_pattern_discovery_tpu_torch import native

        res = native.load_wavs_batch(paths)
        if res is not None:
            padded, lengths, rates = res
            clips = [
                Clip(
                    path=str(p),
                    # Copy out of the padded batch: a view would pin the
                    # whole [n_clips, max_len] allocation (mostly padding
                    # for ragged corpora) for the lifetime of the clips.
                    samples=padded[i, : lengths[i]].copy(),
                    sample_rate=int(rates[i]),
                )
                for i, p in enumerate(paths)
            ]
    if clips is None:
        clips = []
        for p in paths:
            samples, rate = read_wav(p)
            clips.append(Clip(path=str(p), samples=samples, sample_rate=rate))
    if expected_rate is not None:
        for c in clips:
            if c.sample_rate != expected_rate:
                raise ValueError(
                    f"{c.path}: sample rate {c.sample_rate} != expected {expected_rate}"
                )
    return clips


def pad_and_stack(
    arrays: list[np.ndarray],
    pad_to: int | None = None,
    multiple_of: int = 1,
    pad_value: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged list of [n_i, ...] arrays -> ([B, N, ...] padded, [B] lengths).

    N = max length, rounded up to `multiple_of` (TPU lane alignment).
    """
    lengths = np.array([len(a) for a in arrays], dtype=np.int32)
    n = pad_to if pad_to is not None else int(lengths.max())
    n = -(-n // multiple_of) * multiple_of
    trailing = arrays[0].shape[1:]
    out = np.full((len(arrays), n, *trailing), pad_value, dtype=np.float32)
    for i, a in enumerate(arrays):
        if len(a) > n:
            raise ValueError(f"clip {i} length {len(a)} exceeds pad_to {n}")
        out[i, : len(a)] = a
    return out, lengths
