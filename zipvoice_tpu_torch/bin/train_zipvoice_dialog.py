"""ZipVoice-Dialog fine-tuning CLI on PyTorch (CUDA by default).

Fine-tunes a trained base ZipVoice checkpoint (--checkpoint) into
ZipVoice-Dialog: the vocabulary is extended for the dialog tokens (the
dialog tokens.txt has 28 more rows than the base one, [S1]/[S2] among
them), a fresh speaker embedding is added, the learning rate is fixed and
the loss masks a suffix of the features (``models/dialog.py``).  The
regularizer schedules start --finetune-batch-count-offset batches in, past
their ramps.  ``--start-epoch N`` resumes from exp-dir/epoch-{N-1}.pt.

Example (``egs/zipvoice_dialog/run.sh``):
  python -m zipvoice_tpu_torch.bin.train_zipvoice_dialog \\
      --train-manifest data/dialog_train.tsv --token-file data/tokens_dialog.txt \\
      --model-config conf/zipvoice_base.json --exp-dir exp/zipvoice_dialog \\
      --checkpoint exp/zipvoice/model.pt --base-lr 1e-4 --max-duration 250

``bin/train_zipvoice_dialog_stereo.py`` runs this CLI in its stereo mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    from zipvoice_tpu_torch.bin._train_common import add_common_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p, base_lr=0.0001, tokenizer="dialog", variant=True)
    p.add_argument("--finetune-batch-count-offset", type=float, default=100000,
                   help="regularizer schedule offset, so that they start relaxed")
    return p


def main(argv=None, stereo: bool = False, backend=None):
    """Fine-tune; returns {"trainer": Trainer, "steps": [(monotonic end
    time, loss or None), ...]}.  ``stereo``: the stereo model from a mono
    dialog checkpoint, its objective alternating a batch.  ``backend``:
    the process group's backend under --distributed (NCCL when None)."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.bin._train_common import (
        build_data,
        copy_model_dir_contract,
        setup,
    )

    device = setup(args, backend)
    import torch

    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.data.dataset import OnDeviceFbankCollator
    from zipvoice_tpu_torch.data.prefetch import PrefetchBatches
    from zipvoice_tpu_torch.models.dialog import (
        duplicate_projections_stereo,
        extend_vocab_params,
        init_zipvoice_dialog,
    )
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer
    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step
    from zipvoice_tpu_torch.train.trainer import Trainer, TrainerOptions

    tokenizer = get_tokenizer(args.tokenizer, args.token_file, lang=args.lang)
    model_cfg, feat_cfg = load_model_json(args.model_config, vocab_size=tokenizer.vocab_size,
                                          pad_id=tokenizer.pad_id)
    model = init_zipvoice_dialog(model_cfg, stereo=stereo, device=device,
                                 generator=torch.Generator(device=device).manual_seed(args.seed))
    if args.checkpoint:
        # a base checkpoint (mono), or a mono dialog one with the projection
        # surgery (stereo); the vocabulary extended either way
        loaded = load_checkpoint(args.checkpoint)["model"]
        if stereo:
            loaded = duplicate_projections_stereo(loaded, model_cfg.feat_dim)
        sd = extend_vocab_params(model.state_dict(), loaded)
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(sd[k])
    mesh.broadcast_module(model)

    sampler, collate, dev_batches = build_data(args, tokenizer, feat_cfg, model_cfg.pad_id,
                                               device, skip_dev=stereo)
    if stereo:
        collate = OnDeviceFbankCollator(tokenizer, feat_cfg, device=device,
                                        pad_id=model_cfg.pad_id, three_channel=True)
    train_cfg = TrainConfig(
        base_lr=args.base_lr,
        condition_drop_ratio=args.condition_drop_ratio,
        compute_dtype=args.dtype,
        schedule="fixed",
        use_regularizers=not args.no_regularizers,
        loss="dialog",
    )
    trainer = Trainer(
        model_cfg=model_cfg, model=model, opt=ScaledAdam(model.named_parameters()),
        train_cfg=train_cfg,
        options=TrainerOptions(
            exp_dir=args.exp_dir, num_epochs=args.num_epochs, start_epoch=args.start_epoch,
            save_every_n=args.save_every_n, keep_last_k=args.keep_last_k,
            average_period=args.average_period, valid_interval=args.valid_interval,
            log_interval=args.log_interval, seed=args.seed, lr_hours=args.lr_hours,
            frame_rate=feat_cfg.frame_rate, max_duration=args.max_duration,
            batch_count_offset=args.finetune_batch_count_offset,
        ),
    )
    if stereo:
        # the two objectives alternate a batch: the 2-channel loss with the
        # energy penalty (se_weight 1) and the mixed-mono loss
        two_channel_fn = make_train_step(
            model, trainer.opt, dataclasses.replace(train_cfg, stereo=True, se_weight=1.0))
        mixed_fn = trainer.step_fn

    copy_model_dir_contract(args, args.exp_dir)
    exp = Path(args.exp_dir)
    sampler_state = None
    if args.start_epoch > 1:
        resume_path = exp / f"epoch-{args.start_epoch - 1}.pt"
        if resume_path.exists():
            sampler_state = trainer.resume(str(resume_path))
            logging.info("resumed from %s", resume_path)
    if sampler_state:
        sampler.load_state_dict(sampler_state)

    def done():
        return bool(args.num_iters) and trainer.batch_idx_train >= args.num_iters

    f = model_cfg.feat_dim
    steps = []
    for epoch in range(args.start_epoch, args.num_epochs + 1):
        trainer.epoch = epoch
        if not (sampler_state and epoch == args.start_epoch):
            sampler.set_epoch(epoch)
        # with --num-iters, collate no batch past the last step
        left = args.num_iters - trainer.batch_idx_train if args.num_iters else 0
        batches = PrefetchBatches(sampler, collate, depth=2, limit=left)
        try:
            for i, batch in enumerate(batches):
                if stereo:
                    two = i % 2 == 1
                    feats = batch["features"]
                    batch = dict(batch, features=feats[:, :, :2 * f] if two
                                 else feats[:, :, 2 * f:])
                    trainer.active_step_fn = two_channel_fn if two else mixed_fn
                m = trainer.step_and_log(batch, dev_batches,
                                         sampler_state_fn=batches.state_dict)
                logged = trainer.batch_idx_train % args.log_interval == 0
                steps.append((time.monotonic(), float(m["loss"]) if logged else None))
                if done():
                    break
        finally:
            batches.close()
        trainer.save(str(exp / f"epoch-{epoch}.pt"), batches.state_dict())
        logging.info("saved epoch-%d.pt", epoch)
        if done():
            break
    mesh.shutdown()
    return {"trainer": trainer, "steps": steps}


if __name__ == "__main__":
    main()
