"""Pure-NumPy oracles: copies of ``audio_pattern_discovery_tpu/oracle/``
(``dtw.py``, ``stft.py`` and ``cluster.py``; NumPy and SciPy only)."""

from audio_pattern_discovery_tpu_torch.oracle.cluster import linkage_oracle  # noqa: F401
from audio_pattern_discovery_tpu_torch.oracle.dtw import (  # noqa: F401
    dtw_oracle,
    dtw_path_oracle,
)
from audio_pattern_discovery_tpu_torch.oracle.stft import stft_oracle  # noqa: F401
