"""ZipVoice-Dialog-Stereo fine-tuning CLI on PyTorch (CUDA by default).

Fine-tunes a mono ZipVoice-Dialog checkpoint (--checkpoint) into the
two-channel model: the fm_decoder's in/out projections become two-stream
lists by the channel-averaging surgery (``models/dialog.
duplicate_projections_stereo``), and the batches alternate the 2-channel
objective (flow matching plus the both-speaking energy penalty) with the
mixed-mono one.  The manifests must point at stereo wavs; the features of a
batch are [channel 0, channel 1, the mix].  Flags as
``bin/train_zipvoice_dialog.py``.
"""

from __future__ import annotations

from zipvoice_tpu_torch.bin.train_zipvoice_dialog import get_parser  # noqa: F401
from zipvoice_tpu_torch.bin.train_zipvoice_dialog import main as _dialog_main


def main(argv=None, backend=None):
    return _dialog_main(argv, stereo=True, backend=backend)


if __name__ == "__main__":
    main()
