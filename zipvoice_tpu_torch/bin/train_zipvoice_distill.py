"""ZipVoice-Distill training CLI on PyTorch (CUDA by default).

Two stages:

* ``--distill-stage first``: the teacher is a trained base ZipVoice
  checkpoint on its CFG path; the student is a copy of it with the
  guidance-scale embedding added (60k iterations at lr 5e-4 by default
  when --num-iters is 0).
* ``--distill-stage second``: the teacher is the EMA of the student (decay
  0.9999), both starting from the averaged stage-1 student (2k iterations
  at lr 1e-4).

Only the student's fm_decoder trains, without the regularizers.
Checkpoints hold the student under "model", its float64 running average
under "model_avg" and, in stage two, the teacher under "model_ema".

Example (``egs/zipvoice/run_distill.sh``):
  python -m zipvoice_tpu_torch.bin.train_zipvoice_distill \\
      --distill-stage first --teacher-checkpoint exp/zipvoice/model.pt \\
      --train-manifest data/train.tsv --token-file data/tokens.txt \\
      --model-config conf/zipvoice_base.json --exp-dir exp/distill_s1 \\
      --base-lr 5e-4 --num-iters 60000 --max-duration 250
"""

from __future__ import annotations

import argparse
import copy
import logging
import time
from pathlib import Path


def get_parser() -> argparse.ArgumentParser:
    from zipvoice_tpu_torch.bin._train_common import add_common_args

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p, base_lr=0.0005, variant=True)
    p.add_argument("--distill-stage", type=str, default="first",
                   choices=["first", "second"])
    p.add_argument("--teacher-checkpoint", type=str, required=True,
                   help="stage first: a trained base ZipVoice checkpoint; "
                        "stage second: the averaged stage-1 student")
    return p


def _merge_into_fresh(model, loaded) -> None:
    """Copy every loaded tensor whose name and shape match into ``model``
    (the student's guidance_scale_embed stays fresh)."""
    import torch

    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in loaded and loaded[k].shape == v.shape:
                v.copy_(loaded[k])


def main(argv=None, backend=None):
    """Train; returns {"student", "teacher", "steps": [(monotonic end time,
    loss or None), ...], "step_idx"}.  ``backend``: the process group's
    backend under --distributed (NCCL when None); the average and every
    checkpoint are rank 0's."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.bin._train_common import (
        build_data,
        copy_model_dir_contract,
        setup,
    )

    device = setup(args, backend)
    import numpy as np
    import torch

    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.data.prefetch import PrefetchBatches
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models.distill import init_zipvoice_distill
    from zipvoice_tpu_torch.models.zipvoice import ZipVoiceModel
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer
    from zipvoice_tpu_torch.train import checkpoint as ckpt
    from zipvoice_tpu_torch.train.distill_step import draw_t_schedule, make_distill_train_step
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig
    from zipvoice_tpu_torch.train.trainer import step_seed

    tokenizer = get_tokenizer(args.tokenizer, args.token_file, lang=args.lang)
    base_cfg, feat_cfg = load_model_json(args.model_config, vocab_size=tokenizer.vocab_size,
                                         pad_id=tokenizer.pad_id)
    loaded = ckpt.load_checkpoint(args.teacher_checkpoint)["model"]
    student = init_zipvoice_distill(
        base_cfg, torch.Generator(device=device).manual_seed(args.seed), device=device)
    _merge_into_fresh(student, loaded)
    mesh.broadcast_module(student)
    if args.distill_stage == "first":
        # the fixed base-model teacher (CFG path)
        with torch.device("meta"):
            teacher = ZipVoiceModel(base_cfg)
        teacher = load_into(teacher, loaded).to(device)
    else:
        teacher = copy.deepcopy(student)  # the EMA starts at the student
    teacher.requires_grad_(False)

    sampler, collate, _ = build_data(args, tokenizer, feat_cfg, base_cfg.pad_id, device,
                                     skip_dev=True)
    opt = ScaledAdam(student.named_parameters())
    step_fn = make_distill_train_step(
        student, teacher, opt,
        TrainConfig(base_lr=args.base_lr, compute_dtype=args.dtype, use_regularizers=False),
        stage=args.distill_stage)
    lead = mesh.rank() == 0
    model_avg = ckpt.init_averaged_model(student) if lead else None

    copy_model_dir_contract(args, args.exp_dir)
    exp = Path(args.exp_dir)
    host_rng = np.random.default_rng(args.seed)
    max_iters = args.num_iters or (60000 if args.distill_stage == "first" else 2000)
    info = lambda: {"batch_idx_train": step_idx,  # noqa: E731
                    "average_period": args.average_period}
    step_idx = 0
    steps = []
    for epoch in range(args.start_epoch, args.num_epochs + 1):
        sampler.set_epoch(epoch)
        # collate no batch past the last step
        batches = PrefetchBatches(sampler, collate, depth=2, limit=max_iters - step_idx)
        try:
            for batch in batches:
                step_idx += 1
                m = step_fn(batch, step_seed(args.seed, step_idx), draw_t_schedule(host_rng))
                loss = None
                if step_idx % args.log_interval == 0:
                    loss = float(m["loss"])
                    logging.info("step %d loss %.4f ref_loss %.4f", step_idx, loss,
                                 float(m["ref_loss"]))
                steps.append((time.monotonic(), loss))
                if lead and step_idx % args.average_period == 0:
                    ckpt.update_averaged_model(model_avg, student, step_idx,
                                               args.average_period)
                if lead and step_idx % args.save_every_n == 0:
                    ckpt.save_checkpoint(
                        str(exp / f"checkpoint-{step_idx}.pt"), student, model_avg=model_avg,
                        model_ema=(teacher.state_dict() if args.distill_stage == "second"
                                   else None),
                        opt_state=opt.state_dict(), info=info())
                    ckpt.remove_checkpoints(str(exp), args.keep_last_k)
                if step_idx >= max_iters:
                    break
        finally:
            batches.close()
        if step_idx >= max_iters:
            break

    if lead:
        ckpt.save_checkpoint(str(exp / f"iter-{step_idx}.pt"), student, model_avg=model_avg,
                             info=info())
        logging.info("saved iter-%d.pt", step_idx)
    mesh.shutdown()
    return {"student": student, "teacher": teacher, "steps": steps, "step_idx": step_idx}


if __name__ == "__main__":
    main()
