"""Dataset preparation: validated TSV manifests.

Manifests stay TSV (the training collators read them directly and compute
the fbank on the device), so preparing one means validating each row,
probing its duration and, if asked, resampling its wav to the target rate.
The output is a normalized 5-column TSV, ``id\\ttext\\twav_path\\tstart\\tend``
(seconds), at ``<output-dir>/<prefix>_<subset>.tsv``.  A row whose wav
cannot be read, whose rate differs without ``--resample-dir``, or whose
segment ends past the end of its file is dropped with a warning.

Example (stage 0 of ``egs/zipvoice/run.sh``):
  python -m zipvoice_tpu_torch.bin.prepare_dataset --tsv-path data/raw/custom_train.tsv \\
      --prefix custom --subset train --output-dir data/manifests
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tsv-path", type=str, required=True,
                   help="input TSV: id\\ttext\\twav[\\tstart\\tend]")
    p.add_argument("--prefix", type=str, default="custom")
    p.add_argument("--subset", type=str, default="train")
    p.add_argument("--sampling-rate", type=int, default=24000,
                   help="resample wavs that differ (writes to --resample-dir)")
    p.add_argument("--resample-dir", type=str, default=None,
                   help="if set, resampled copies are written here")
    p.add_argument("--output-dir", type=str, required=True)
    return p


def main(argv=None) -> dict:
    """Prepare; returns {"manifest": output path, "kept": n, "dropped": n}."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.audio.wav import read_wav, resample, write_wav
    from zipvoice_tpu_torch.data.dataset import read_tsv_manifest

    utts = read_tsv_manifest(args.tsv_path)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    resample_dir = Path(args.resample_dir) if args.resample_dir else None
    if resample_dir:
        resample_dir.mkdir(parents=True, exist_ok=True)

    kept, dropped = [], 0
    for u in utts:
        try:
            wav, sr = read_wav(u.wav_path)
        except Exception as ex:  # noqa: BLE001 - an unreadable row is dropped
            logging.warning("drop %s: %s", u.uid, ex)
            dropped += 1
            continue
        if sr != args.sampling_rate:
            if resample_dir is None:
                logging.warning("drop %s: rate %d != %d (set --resample-dir to convert)",
                                u.uid, sr, args.sampling_rate)
                dropped += 1
                continue
            wav = resample(wav, sr, args.sampling_rate)
            new_path = resample_dir / f"{u.uid}.wav"
            write_wav(new_path, wav, args.sampling_rate)
            u.wav_path = str(new_path)
            sr = args.sampling_rate
        file_secs = wav.shape[-1] / sr
        if u.duration is None:
            # a 3-column row: the text covers the whole file
            u.duration = file_secs
        elif u.start + u.duration > file_secs + 1e-3:
            # a 5-column segment keeps its bounds if they lie within the file
            logging.warning("drop %s: segment [%0.2f, %0.2f) beyond file end %0.2f",
                            u.uid, u.start, u.start + u.duration, file_secs)
            dropped += 1
            continue
        kept.append(u)

    out = out_dir / f"{args.prefix}_{args.subset}.tsv"
    with open(out, "w", encoding="utf-8") as f:
        for u in kept:
            f.write(f"{u.uid}\t{u.text}\t{u.wav_path}\t{u.start}\t{u.start + u.duration}\n")
    logging.info("wrote %s: %d utterances (%d dropped)", out, len(kept), dropped)
    return {"manifest": str(out), "kept": len(kept), "dropped": dropped}


if __name__ == "__main__":
    main()
