"""Offline fbank extraction into sharded float16 ``.npz`` files.

Training computes the fbank on the device and needs no precompute; an
offline store serves repeated epochs over slow storage.  Each shard,
``<prefix>_<subset>_feats_<n>.npz``, maps an utterance id to its float16
(frames, n_mels) features; the index ``<prefix>_<subset>_feats.tsv`` holds
``id\\ttext\\twav_path\\tshard\\tframes`` rows, which
``data/dataset.PrecomputedFeatureCollator`` reads.  A 5-column manifest's
row is featurized over its segment only.  The fbank (``audio/mel.
extract_features``) runs on ``--device``; the wavs are read and resampled
on the host.

Example:
  python -m zipvoice_tpu_torch.bin.compute_fbank --manifest custom_train.tsv \\
      --output-dir data/fbank --prefix custom --subset train
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--prefix", type=str, default="custom")
    p.add_argument("--subset", type=str, default="train")
    p.add_argument("--type", type=str, default="vocos", choices=["vocos", "bigvgan"])
    p.add_argument("--num-channels", type=int, default=1, choices=[1, 2])
    p.add_argument("--shard-size", type=int, default=1000,
                   help="utterances per .npz shard")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the fbank runs")
    return p


def main(argv=None) -> str:
    """Extract; returns the index TSV's path."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    from zipvoice_tpu_torch.audio.mel import extract_features
    from zipvoice_tpu_torch.audio.wav import read_wav, resample
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.data.dataset import read_tsv_manifest
    from zipvoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    feat_cfg = FeatureConfig(type=args.type)
    utts = read_tsv_manifest(args.manifest)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    index_rows = []
    shard: dict = {}
    shard_idx = 0

    def shard_name(i: int) -> str:
        return f"{args.prefix}_{args.subset}_feats_{i:05d}.npz"

    def flush():
        nonlocal shard, shard_idx
        if not shard:
            return
        path = out_dir / shard_name(shard_idx)
        np.savez_compressed(path, **shard)
        logging.info("wrote %s (%d utts)", path, len(shard))
        shard = {}
        shard_idx += 1

    for u in utts:
        wav, sr = read_wav(u.wav_path)
        # a segment row is featurized over [start, start + duration)
        if u.duration is not None and (u.start or u.duration):
            a = int(u.start * sr)
            wav = wav[:, a: a + int(u.duration * sr)]
        if sr != feat_cfg.sampling_rate:
            wav = resample(wav, sr, feat_cfg.sampling_rate)
        with torch.no_grad():
            mel = extract_features(torch.from_numpy(np.ascontiguousarray(wav)).to(device),
                                   feat_cfg, num_channels=args.num_channels)
        feats = mel.cpu().numpy().astype(np.float16)
        shard[u.uid] = feats
        index_rows.append(f"{u.uid}\t{u.text}\t{u.wav_path}\t{shard_name(shard_idx)}\t"
                          f"{feats.shape[0]}")
        if len(shard) >= args.shard_size:
            flush()
    flush()

    index = out_dir / f"{args.prefix}_{args.subset}_feats.tsv"
    index.write_text("\n".join(index_rows) + "\n", encoding="utf-8")
    logging.info("wrote %s (%d utterances)", index, len(index_rows))
    return str(index)


if __name__ == "__main__":
    main()
