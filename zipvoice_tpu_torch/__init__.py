"""PyTorch/CUDA port of zipvoice_tpu: zero-shot ZipVoice inference and base
ZipVoice training on Hopper.

The package mirrors the module layout of ``zipvoice_tpu`` and holds its own
copies of everything it needs; it never imports JAX or ``zipvoice_tpu``.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.

The kernels live in ``ops/attention.py`` (attention probabilities, probs @
V, their backwards) and ``ops/melspec.py`` (log-mel), with CUDA C++ sources
under ``csrc/`` built with nvcc at first use; every other op is plain
PyTorch.
"""

import torch

# Full-f32 numerics on the card.  Matmuls already default to strict f32,
# but cuDNN convolutions default to TF32 (about three decimal digits): the
# Zipformer conv modules and the Vocos convs would silently lose precision
# against the CPU path and the JAX reference.  Both flags are set explicitly
# so neither default can drift under a library upgrade.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
