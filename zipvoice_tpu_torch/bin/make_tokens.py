"""Build a tokens.txt vocabulary.

A tokens.txt holds ``{token}\\t{id}`` lines with the pad token ``_`` at id
0.  Two modes:

* corpus mode (``--manifest``, repeatable): tokenize every manifest text
  with the chosen tokenizer and number the tokens seen at least
  ``--min-count`` times, sorted, after the pad (the dialog tokenizer
  reserves ``[S1]`` and ``[S2]`` at ids 1 and 2);
* emilia mode (``--emilia-pinyin``, a list of valid pinyin syllables): the
  released models' layout, the espeak phoneme-id block verbatim
  (``text/espeak_map.py``), then the sorted pinyin initials (``+0``
  suffixed) and tone-3 finals of the list.

Examples:
  python -m zipvoice_tpu_torch.bin.make_tokens --manifest train.tsv \\
      --tokenizer simple --output tokens.txt
  python -m zipvoice_tpu_torch.bin.make_tokens --emilia-pinyin pinyin.txt \\
      --output tokens_emilia.txt
"""

from __future__ import annotations

import argparse
import logging
from collections import Counter
from typing import Dict


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", type=str, default=None, action="append",
                   help="TSV manifest(s); repeatable")
    p.add_argument("--emilia-pinyin", type=str, default=None,
                   help="valid-pinyin list (one syllable a line): the released "
                        "emilia tokens.txt layout")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--tokenizer", type=str, default="simple",
                   choices=["emilia", "espeak", "dialog", "libritts", "simple"])
    p.add_argument("--lang", type=str, default="en-us")
    p.add_argument("--min-count", type=int, default=1,
                   help="drop tokens rarer than this")
    return p


def build_emilia_tokens(pinyin_path: str) -> Dict[str, int]:
    """The espeak-map block, then the sorted pinyin initials and finals."""
    from zipvoice_tpu_torch.text.espeak_map import get_espeak_map
    from zipvoice_tpu_torch.text.tokenizer import split_pinyin

    token2id = dict(get_espeak_map())
    phones = set()
    with open(pinyin_path, encoding="utf-8") as f:
        for line in f:
            syl = line.strip()
            if not syl:
                continue
            # a bare syllable is the neutral tone, written 5
            if syl[-1] not in "12345":
                syl = syl + "5"
            phones.update(split_pinyin(syl))
    base = len(token2id)
    for i, ph in enumerate(sorted(phones)):
        if ph in token2id:
            raise ValueError(f"pinyin token {ph!r} collides with the espeak map")
        token2id[ph] = base + i
    return token2id


def main(argv=None) -> str:
    """Write the vocabulary; returns the output path."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.data.dataset import read_tsv_manifest
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer, write_token_file

    if args.emilia_pinyin:
        token2id = build_emilia_tokens(args.emilia_pinyin)
        write_token_file(token2id, args.output)
        logging.info("wrote %s (%d tokens, emilia layout)", args.output, len(token2id))
        return args.output
    if not args.manifest:
        raise SystemExit("pass --manifest or --emilia-pinyin")

    tokenizer = get_tokenizer(args.tokenizer, token_file=None, lang=args.lang)
    counts: Counter = Counter()
    for manifest in args.manifest:
        utts = read_tsv_manifest(manifest)
        for toks in tokenizer.texts_to_tokens([u.text for u in utts]):
            counts.update(toks)

    vocab = ["_"]  # pad at id 0
    if args.tokenizer == "dialog":
        vocab += ["[S1]", "[S2]"]
    for tok, c in sorted(counts.items()):
        if c >= args.min_count and tok not in vocab:
            vocab.append(tok)

    write_token_file({t: i for i, t in enumerate(vocab)}, args.output)
    logging.info("wrote %s (%d tokens)", args.output, len(vocab))
    return args.output


if __name__ == "__main__":
    main()
