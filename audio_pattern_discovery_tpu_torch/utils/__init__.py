"""Logging, stage counters and device timing."""

from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger  # noqa: F401
from audio_pattern_discovery_tpu_torch.utils.timer import DeviceTimer  # noqa: F401
