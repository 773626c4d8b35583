"""audio_pattern_discovery_tpu_torch: the PyTorch/CUDA port of
``audio_pattern_discovery_tpu``.

Same public surface as the JAX package (a directory of WAV files in,
pattern clusters + DTW alignments out; the same ``PipelineConfig`` schema
and ``-s section.key=value`` overrides), written in PyTorch for an NVIDIA
Hopper card.  The JAX package stays the reference this port is tested
against; nothing here imports JAX.

Ported so far: ``discover()`` and the CLI at the default config: the
trained autoencoder (or the PCA embedder) with its checkpoint, and the
all-pairs DTW unbanded, diag-banded or widen-banded, which runs through
seven CUDA C++ kernels (``csrc/*.cu``, K1-K7) on a CUDA device and through
their plain PyTorch twins on CPU tensors.  The entry points run on the card
unless the caller asks for the CPU.  Paths not ported yet raise
``NotImplementedError`` naming the ROADMAP.md item that will port them.
"""

__version__ = "0.1.0"

import torch as _torch

# TF32 keeps ~3 decimal digits: it would corrupt the PCA covariance, the
# DFT matmul and the DTW frame costs near zero (docs/DESIGN.md section 3).
# Both flags are set explicitly rather than trusting the defaults.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from audio_pattern_discovery_tpu_torch.config import PipelineConfig  # noqa: E402,F401
