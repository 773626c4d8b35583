"""Copy of ``audio_pattern_discovery_tpu/io/__init__.py``; only the import paths differ."""

from audio_pattern_discovery_tpu_torch.io.wavio import read_wav, write_wav  # noqa: F401
from audio_pattern_discovery_tpu_torch.io.corpus import (  # noqa: F401
    Clip,
    load_corpus,
    pad_and_stack,
)
