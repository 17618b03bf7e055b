"""Naturalness (MOS) evaluation with UTMOS22-strong.

The scorer is ``eval/models/utmos.py``.  Weights load from a local
state-dict file (``--checkpoint``) or from the SpeechMOS release URL
(network needed).  Each wav of ``--wav-dir`` is downmixed, resampled to
16 kHz on the host and scored on ``--device``; ``--out`` gets the mean and
one line a wav.

Usage:
  python -m zipvoice_tpu_torch.eval.mos --wav-dir results --checkpoint utmos.pt
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def load_utmos(checkpoint: str = None):
    """The UTMOS22-strong MOS predictor, on the CPU."""
    from zipvoice_tpu_torch.eval.models.utmos import load_utmos22_strong

    try:
        return load_utmos22_strong(checkpoint)
    except Exception as ex:  # noqa: BLE001
        raise RuntimeError(
            f"UTMOS predictor unavailable ({ex}); pass --checkpoint with a "
            "local utmos22_strong state dict or run with network access"
        ) from ex


def main(argv=None) -> dict:
    """Score; returns {"UTMOS": mean, "rows": [(name, score), ...]}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="local utmos22_strong.pt state dict")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from zipvoice_tpu_torch.audio.wav import read_wav, resample
    from zipvoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    predictor = load_utmos(args.checkpoint).to(device)
    scores = []
    rows = []
    for wav_path in sorted(Path(args.wav_dir).glob("*.wav")):
        wav, sr = read_wav(wav_path)
        wav16 = resample(wav.mean(axis=0, keepdims=True), sr, 16000)
        with torch.no_grad():
            score = float(predictor(torch.from_numpy(wav16).to(device), 16000).squeeze().item())
        scores.append(score)
        rows.append((wav_path.stem, score))

    overall = float(np.mean(scores)) if scores else float("nan")
    logging.info("UTMOS over %d utts: %.3f", len(scores), overall)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(f"UTMOS\t{overall:.4f}\n")
            for name, s in rows:
                f.write(f"{name}\t{s:.3f}\n")
    return {"UTMOS": overall, "rows": rows}


if __name__ == "__main__":
    main()
