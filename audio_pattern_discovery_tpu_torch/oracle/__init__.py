"""Pure-NumPy DTW oracle (copy of ``audio_pattern_discovery_tpu/oracle/dtw.py``)."""

from audio_pattern_discovery_tpu_torch.oracle.dtw import (  # noqa: F401
    dtw_oracle,
    dtw_path_oracle,
)
