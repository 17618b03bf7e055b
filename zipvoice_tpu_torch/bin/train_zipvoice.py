"""Flow-matching TTS training CLI on PyTorch (CUDA by default).

Data comes from TSV manifests (id\\ttext\\twav_path[\\tstart\\tend]); the
fbank is computed on the device.  ``--device cpu`` trains on the CPU.
``--distributed`` trains data-parallel over the processes torchrun starts,
one a card (``torchrun --nproc-per-node N -m
zipvoice_tpu_torch.bin.train_zipvoice --distributed ...``).

Example:
  python -m zipvoice_tpu_torch.bin.train_zipvoice \\
      --train-manifest data/train.tsv --dev-manifest data/dev.tsv \\
      --token-file data/tokens.txt --tokenizer simple \\
      --model-config conf/zipvoice_base.json --exp-dir exp/zipvoice \\
      --num-epochs 11 --max-duration 250 --base-lr 0.02 --lr-hours 30000
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    from zipvoice_tpu_torch.bin._train_common import add_common_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--finetune", action="store_true",
                   help="fine-tuning mode: fixed LR and regularizer schedules "
                        "pinned past their ramps")
    p.add_argument("--num-steps-per-epoch", type=int, default=0,
                   help="cap steps per epoch (0 = full manifest)")
    p.add_argument("--inf-check", action="store_true",
                   help="detect non-finite losses/params during training")
    p.add_argument("--print-diagnostics", action="store_true",
                   help="print parameter and per-module activation statistics on the "
                        "first batch, then exit")
    p.add_argument("--scan-oom", action="store_true",
                   help="run one step on the epoch's largest batch first (a rank's "
                        "own), then restore the state before it")
    return p


def main(argv=None, backend=None):
    """Train; returns {"trainer": Trainer, "steps": [(monotonic end time,
    loss or None), ...]} (the loss is read only at the log interval), or
    None after --print-diagnostics.  ``backend``: the process group's
    backend under --distributed (NCCL when None)."""
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
    from zipvoice_tpu_torch.data.prefetch import PrefetchBatches
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer
    from zipvoice_tpu_torch.train.checkpoint import load_checkpoint
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig
    from zipvoice_tpu_torch.train.trainer import Trainer, TrainerOptions

    tokenizer = get_tokenizer(args.tokenizer, args.token_file, lang=args.lang)
    model_cfg, feat_cfg = load_model_json(args.model_config, vocab_size=tokenizer.vocab_size,
                                          pad_id=tokenizer.pad_id)
    sampler, collate, dev_batches = build_data(args, tokenizer, feat_cfg,
                                               pad_id=model_cfg.pad_id, device=device)

    model = init_zipvoice(model_cfg, torch.Generator(device=device).manual_seed(args.seed),
                          device=device)
    if args.checkpoint:
        sd = load_checkpoint(args.checkpoint)["model"]
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(sd[k])
    mesh.broadcast_module(model)

    if args.print_diagnostics:
        print_diagnostics(model, collate(next(iter(sampler))))
        mesh.shutdown()
        return None

    trainer = Trainer(
        model_cfg=model_cfg,
        model=model,
        opt=ScaledAdam(model.named_parameters()),
        train_cfg=TrainConfig(
            base_lr=args.base_lr,
            lr_batches=args.lr_batches,
            lr_epochs=args.lr_epochs,
            condition_drop_ratio=args.condition_drop_ratio,
            compute_dtype=args.dtype,
            schedule="fixed" if args.finetune else "eden",
            use_regularizers=not args.no_regularizers,
        ),
        options=TrainerOptions(
            exp_dir=args.exp_dir,
            num_epochs=args.num_epochs,
            start_epoch=args.start_epoch,
            save_every_n=args.save_every_n,
            keep_last_k=args.keep_last_k,
            average_period=args.average_period,
            valid_interval=args.valid_interval,
            log_interval=args.log_interval,
            seed=args.seed,
            lr_hours=args.lr_hours,
            frame_rate=feat_cfg.frame_rate,
            max_duration=args.max_duration,
            inf_check=args.inf_check,
            batch_count_offset=100000.0 if args.finetune else 0.0,
        ),
    )

    if args.scan_oom:
        largest = sampler.pessimistic_batches(1)
        if largest:
            logging.info("scan-oom: one step on the largest batch")
            trainer.scan_oom(collate(largest[0]))
            logging.info("scan-oom: ok (state restored)")

    exp = Path(args.exp_dir)
    if args.start_epoch > 1:
        resume_path = exp / f"epoch-{args.start_epoch - 1}.pt"
        if resume_path.exists():
            sampler_state = trainer.resume(str(resume_path))
            if sampler_state:
                sampler.load_state_dict(sampler_state)
            logging.info("resumed from %s", resume_path)
    copy_model_dir_contract(args, exp)

    steps = []
    for epoch in range(args.start_epoch, args.num_epochs + 1):
        trainer.epoch = epoch
        sampler.set_epoch(epoch)
        logging.info("epoch %d: %d batches", epoch, len(sampler))
        # wav decoding and the fbank launch overlap the step
        batches = PrefetchBatches(sampler, collate, depth=2, limit=args.num_steps_per_epoch)
        try:
            for batch in batches:
                m = trainer.step_and_log(batch, dev_batches,
                                         sampler_state_fn=batches.state_dict)
                logged = trainer.batch_idx_train % args.log_interval == 0
                steps.append((time.monotonic(), float(m["loss"]) if logged else None))
        finally:
            batches.close()
        trainer.save(str(exp / f"epoch-{epoch}.pt"), batches.state_dict())
        logging.info("saved epoch-%d.pt", epoch)
    mesh.shutdown()
    return {"trainer": trainer, "steps": steps}


def print_diagnostics(model, batch) -> None:
    """Parameter statistics, then the fm_decoder's per-module activation
    statistics on ``batch`` (its features three times over as the input, t
    = 0.5), on rank 0."""
    import torch

    from zipvoice_tpu_torch.parallel.mesh import rank
    from zipvoice_tpu_torch.utils.diagnostics import (
        activation_diagnostics,
        format_diagnostics,
        param_diagnostics,
    )

    if rank() != 0:
        return
    print(format_diagnostics(param_diagnostics(model)))
    feats = torch.as_tensor(batch["features"])
    b = feats.shape[0]
    print(format_diagnostics(activation_diagnostics(
        model.fm_decoder, torch.cat([feats] * 3, dim=-1),
        t=torch.full((b,), 0.5, device=feats.device))))



def cli(argv=None) -> int:
    """The console script's entry point: ``main``, then exit code 0.
    ``main`` returns the trainer and its steps, which ``sys.exit`` would
    print and turn into exit code 1; a failure raises."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
