"""Offline checkpoint averaging on PyTorch.

The average over a window of training, from two checkpoints' float64
running averages: ``--epoch N --avg K`` averages epochs (N - K, N] from
epoch-{N-K}.pt and epoch-N.pt; ``--iter N --avg K`` takes the newest
checkpoint-*.pt at or below N and the K-th older one.  The output is
{"model": state_dict} (f32), which loads as a model dir's model.pt, a
--checkpoint or a --teacher-checkpoint.  Checkpoints written without a
running average give the plain mean of their two weight sets, with a
warning.

Example (``egs/zipvoice/run_distill.sh``):
  python -m zipvoice_tpu_torch.bin.generate_averaged_model \\
      --exp-dir exp/distill_s1 --iter 60000 --avg 7 --out exp/distill_s1/model.pt
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--exp-dir", type=str, required=True)
    p.add_argument("--epoch", type=int, default=None,
                   help="end epoch (uses epoch-N.pt files)")
    p.add_argument("--iter", type=int, default=None,
                   help="end iteration (uses checkpoint-N.pt files)")
    p.add_argument("--avg", type=int, required=True,
                   help="number of checkpoints in the average window")
    p.add_argument("--out", type=str, default=None,
                   help="output path (default exp-dir/{epoch|iter}-N-avg-K.pt)")
    return p


def main(argv=None) -> str:
    """Average; returns the output path."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.train.checkpoint import (
        average_checkpoints_with_averaged_model,
        find_checkpoints,
        save_checkpoint,
    )

    exp = Path(args.exp_dir)
    if args.iter is not None:
        ckpts = find_checkpoints(str(exp), iteration=-args.iter)
        if len(ckpts) <= args.avg:
            raise SystemExit(f"--avg {args.avg} needs more than {args.avg} checkpoints "
                             f"at or below iteration {args.iter}; found {len(ckpts)}")
        end, start = ckpts[0], ckpts[args.avg]
        tag = f"iter-{args.iter}-avg-{args.avg}"
    elif args.epoch is not None:
        end = str(exp / f"epoch-{args.epoch}.pt")
        start = str(exp / f"epoch-{args.epoch - args.avg}.pt")
        tag = f"epoch-{args.epoch}-avg-{args.avg}"
    else:
        raise SystemExit("pass --epoch or --iter")

    logging.info("averaging (%s, %s]", start, end)
    out = args.out or str(exp / f"{tag}.pt")
    save_checkpoint(out, average_checkpoints_with_averaged_model(start, end))
    logging.info("saved %s", out)
    return out


if __name__ == "__main__":
    main()
