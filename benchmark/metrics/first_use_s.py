"""first_use_s: seconds the run's process paid once (kernel builds and
loads, the native library, the optimizer's first construction): the sum
of the outermost keys (those without a dot; a dotted key is timed inside
its prefix) of the port's process-wide registry
``utils/logging.FIRST_USE``, read in the run's own process after the
window.  None where the program keeps no such registry."""

import importlib


def read(run):
    mod = importlib.import_module("audio_pattern_discovery_tpu_torch.utils.logging")
    reg = getattr(mod, "FIRST_USE", None)
    if reg is None:
        return None
    return sum(s for k, s in reg.timings_s.items() if "." not in k)
