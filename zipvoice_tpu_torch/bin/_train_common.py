"""Shared pieces of the training CLIs: common arguments, the flags whose
paths are not ported yet, and the data wiring."""

from __future__ import annotations

import argparse
from pathlib import Path

NOT_PORTED = "is not yet ported to zipvoice_tpu_torch"


def add_common_args(p: argparse.ArgumentParser, base_lr: float = 0.02,
                    tokenizer: str = "emilia", variant: bool = False):
    """The flags every training CLI takes.  ``variant``: the distill and
    dialog CLIs' set, where --exp-dir is required and --num-iters exists."""
    p.add_argument("--train-manifest", type=str, required=True)
    p.add_argument("--dev-manifest", type=str, default=None)
    p.add_argument("--token-file", type=str, required=True)
    p.add_argument("--tokenizer", type=str, default=tokenizer,
                   choices=["emilia", "espeak", "dialog", "libritts", "simple"])
    p.add_argument("--lang", type=str, default="en-us")
    p.add_argument("--max-duration", type=float, default=200.0,
                   help="max batch size in seconds of audio")
    p.add_argument("--max-len", type=float, default=30.0,
                   help="drop utterances longer than this (seconds)")
    p.add_argument("--min-len", type=float, default=1.0)
    p.add_argument("--model-config", type=str, required=True,
                   help="model.json (architecture + feature sections)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="initial checkpoint (e.g. for finetuning)")
    if variant:
        p.add_argument("--exp-dir", type=str, required=True)
    else:
        p.add_argument("--exp-dir", type=str, default="exp/zipvoice")
    p.add_argument("--num-epochs", type=int, default=11)
    if variant:
        p.add_argument("--num-iters", type=int, default=0,
                       help="stop after this many steps (0 = epoch-driven)")
    p.add_argument("--start-epoch", type=int, default=1,
                   help="resume from exp-dir/epoch-{start_epoch-1}.pt if > 1")
    p.add_argument("--base-lr", type=float, default=base_lr)
    p.add_argument("--lr-batches", type=float, default=7500)
    p.add_argument("--lr-epochs", type=float, default=10)
    p.add_argument("--lr-hours", type=float, default=0,
                   help="if > 0, key the Eden epoch term to hours of speech")
    p.add_argument("--condition-drop-ratio", type=float, default=0.2)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--save-every-n", type=int, default=5000)
    p.add_argument("--keep-last-k", type=int, default=30)
    p.add_argument("--average-period", type=int, default=200)
    p.add_argument("--valid-interval", type=int, default=10000)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-regularizers", action="store_true",
                   help="disable training-time stochastic regularizers")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="device to train on")
    # flags of the JAX CLIs whose paths are not ported: they raise
    p.add_argument("--distributed", action="store_true", help=f"multi-process ({NOT_PORTED})")
    p.add_argument("--unroll-layers", action="store_true", help=f"({NOT_PORTED})")
    p.add_argument("--remat-policy", type=str, default=None,
                   choices=["full", "all", "dots", "xprobs", "xprobs_ff"],
                   help="activation rematerialization; only 'full' (the default: "
                        "each layer recomputed in the backward) is ported")
    return p


def refuse_unported(args, *extra):
    """Raise for any flag whose path the port does not have."""
    flags = [("--distributed", args.distributed), ("--unroll-layers", args.unroll_layers),
             (f"--remat-policy {args.remat_policy}",
              args.remat_policy not in (None, "full")), *extra]
    for flag, on in flags:
        if on:
            raise SystemExit(f"{flag} {NOT_PORTED}")


def build_data(args, tokenizer, feat_cfg, pad_id, device, skip_dev: bool = False):
    """(sampler, collate, dev batches or None); ``skip_dev`` leaves the dev
    manifest unread."""
    from zipvoice_tpu_torch.data.dataset import (
        DurationBucketSampler,
        OnDeviceFbankCollator,
        read_tsv_manifest,
    )

    sampler = DurationBucketSampler(read_tsv_manifest(args.train_manifest),
                                    max_duration=args.max_duration, max_len=args.max_len,
                                    min_len=args.min_len, seed=args.seed)
    collate = OnDeviceFbankCollator(tokenizer, feat_cfg, device=device, pad_id=pad_id)
    dev_batches = None
    if args.dev_manifest and not skip_dev:
        dev_sampler = DurationBucketSampler(read_tsv_manifest(args.dev_manifest),
                                            max_duration=args.max_duration, shuffle=False,
                                            max_len=args.max_len, min_len=args.min_len)
        dev_batches = [collate(b) for b in dev_sampler]
    return sampler, collate, dev_batches


def copy_model_dir_contract(args, exp_dir):
    """model.json and tokens.txt go into the exp dir, so that the exp dir
    plus a checkpoint renamed model.pt is a model dir."""
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    (exp / "model.json").write_text(Path(args.model_config).read_text())
    (exp / "tokens.txt").write_text(Path(args.token_file).read_text())
