"""Logging and stage counters."""

from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger  # noqa: F401
