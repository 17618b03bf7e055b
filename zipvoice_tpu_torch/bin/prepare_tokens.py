"""Offline tokenization of a manifest.

Tokenizes every text ahead of training (the collator otherwise tokenizes
each batch) and writes a 6-column TSV, ``id\\ttext\\twav_path\\tstart\\tend
\\ttokens``, the tokens space-separated token strings.  It reads back
through ``data/dataset.read_tsv_manifest``, where the training collator
looks each string up in tokens.txt: the G2P ran here.  Durations a 3-column
manifest lacks are probed from the wav headers.

Example (stage 1 of ``egs/zipvoice/run.sh``):
  python -m zipvoice_tpu_torch.bin.prepare_tokens \\
      --manifest data/manifests/custom_train.tsv \\
      --output data/manifests/custom_train_tokens.tsv --tokenizer emilia
"""

from __future__ import annotations

import argparse
import logging


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--tokenizer", type=str, default="emilia",
                   choices=["emilia", "espeak", "dialog", "libritts", "simple"])
    p.add_argument("--lang", type=str, default="en-us")
    return p


def main(argv=None) -> str:
    """Tokenize; returns the output path."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.data.dataset import probe_duration, read_tsv_manifest
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(args.tokenizer, token_file=None, lang=args.lang)
    utts = read_tsv_manifest(args.manifest)
    tokens = tokenizer.texts_to_tokens([u.text for u in utts])
    with open(args.output, "w", encoding="utf-8") as f:
        for u, toks in zip(utts, tokens):
            if u.duration is None:
                probe_duration(u)
            f.write(f"{u.uid}\t{u.text}\t{u.wav_path}\t{u.start}\t"
                    f"{u.start + u.duration}\t{' '.join(toks)}\n")
    logging.info("wrote %s (%d utterances)", args.output, len(utts))
    return args.output


if __name__ == "__main__":
    main()
