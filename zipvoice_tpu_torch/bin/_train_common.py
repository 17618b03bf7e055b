"""Shared pieces of the training CLIs: common arguments, the process group
and the device, the remat policy, and the data wiring."""

from __future__ import annotations

import argparse
from pathlib import Path

UNROLL_LAYERS_HELP = (
    "accepted for the JAX CLIs' flag set; the port's layers always run as a "
    "Python loop, which is what this flag selects there, so it changes "
    "nothing here (the layers keep --remat-policy)")

REMAT_POLICY_HELP = (
    "what the backward of each layer keeps from its forward "
    "(nn.zipformer.set_remat_policy): 'full' recomputes the whole layer (the "
    "default, least memory), 'all' recomputes nothing, 'dots' saves the "
    "matmul outputs, 'xprobs' saves everything but the attention "
    "probabilities, 'xprobs_ff' also recomputes the feedforward, conv and "
    "nonlin-attention hidden stages")


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
                   help="max batch size in seconds of audio (a rank's batch)")
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
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the processes torchrun starts (one a card, "
                        "NCCL; the device is cuda:LOCAL_RANK); --max-duration is a rank's "
                        "batch")
    p.add_argument("--unroll-layers", action="store_true", help=UNROLL_LAYERS_HELP)
    p.add_argument("--remat-policy", type=str, default=None,
                   choices=["full", "all", "dots", "xprobs", "xprobs_ff"],
                   help=REMAT_POLICY_HELP)
    return p


def setup(args, backend=None):
    """The remat policy, then with --distributed the process group from the
    launcher's environment (NCCL unless ``backend`` names another); returns
    the device to train on."""
    from zipvoice_tpu_torch.nn.zipformer import set_remat_policy
    from zipvoice_tpu_torch.parallel.mesh import init_from_env
    from zipvoice_tpu_torch.utils.device import resolve_device

    set_remat_policy(args.remat_policy)
    device = resolve_device(args.device)
    if args.distributed:
        device = init_from_env(device.type, backend)
    return device


def build_data(args, tokenizer, feat_cfg, pad_id, device, skip_dev: bool = False):
    """(sampler, collate, dev batches or None), each manifest sharded over
    the ranks; ``skip_dev`` leaves the dev manifest unread."""
    from zipvoice_tpu_torch.data.dataset import (
        DurationBucketSampler,
        OnDeviceFbankCollator,
        read_tsv_manifest,
    )
    from zipvoice_tpu_torch.parallel.mesh import rank, world_size

    shard = dict(process_index=rank(), process_count=world_size())
    sampler = DurationBucketSampler(read_tsv_manifest(args.train_manifest),
                                    max_duration=args.max_duration, max_len=args.max_len,
                                    min_len=args.min_len, seed=args.seed, **shard)
    collate = OnDeviceFbankCollator(tokenizer, feat_cfg, device=device, pad_id=pad_id)
    dev_batches = None
    if args.dev_manifest and not skip_dev:
        dev_sampler = DurationBucketSampler(read_tsv_manifest(args.dev_manifest),
                                            max_duration=args.max_duration, shuffle=False,
                                            max_len=args.max_len, min_len=args.min_len,
                                            **shard)
        dev_batches = [collate(b) for b in dev_sampler]
    return sampler, collate, dev_batches


def copy_model_dir_contract(args, exp_dir):
    """model.json and tokens.txt go into the exp dir (rank 0), so that the
    exp dir plus a checkpoint renamed model.pt is a model dir."""
    from zipvoice_tpu_torch.parallel.mesh import rank

    if rank() != 0:
        return
    exp = Path(exp_dir)
    exp.mkdir(parents=True, exist_ok=True)
    (exp / "model.json").write_text(Path(args.model_config).read_text())
    (exp / "tokens.txt").write_text(Path(args.token_file).read_text())
