"""Model export for deployment with ``torch.export`` (CUDA by default).

The PyTorch counterpart of the reference package's ``bin/export_model``
(``jax.export`` there).  It writes three programs with static shapes, each
an ``ExportedProgram`` saved by ``torch.export.save``:

* ``text_model.pt2``: token embedding, text encoder and the uniform
  duration expansion, (tokens, tokens_lens, features_lens) -> text
  condition;
* ``fm_decoder_step.pt2``: one CFG-folded flow-matching step with t a
  runtime input (the distilled model: one pass with its scale embedded),
  (t, xt, text_condition, speech_condition, padding_mask) -> velocity;
* ``sampler_fused.pt2``: the text model and the whole N-step Euler ODE in
  one program.  ``torch.export`` has no loop, so the steps unroll: the
  program grows with the step count.

B1 and B2 stay custom ops (``zipvoice::rel_probs``,
``zipvoice::probs_apply``) inside each program: on the card they launch
the kernels, on the CPU they run the plain versions.  The fused eval path
is off while exporting (its kernels are not ops the tracer can see).  An
artifact is bound to the device type it was exported on
(``bin/infer_exported.load_exported`` refuses another).

Usage:
  python -m zipvoice_tpu_torch.bin.export_model --model-dir exp/zipvoice \\
      --out-dir exp/zipvoice/exported [--dtype bfloat16] [--quantize int8]
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch
from torch import nn

# the extra file of every artifact that names the device type it runs on
DEVICE_TAG = "device_type"


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-name", type=str, default="zipvoice",
                   choices=["zipvoice", "zipvoice_distill"])
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--checkpoint-name", type=str, default="model.pt")
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--num-step", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--timesteps", type=str, default=None,
                   help="Explicit comma-separated Euler grid spanning [0,1], "
                        "baked into the fused sampler program instead of "
                        "--num-step/--t-shift")
    p.add_argument("--max-tokens", type=int, default=256,
                   help="static token-axis size of the exported programs")
    p.add_argument("--max-frames", type=int, default=3072,
                   help="static frame-axis size (30s ~ 2812 frames)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8", "int8-dynamic"],
                   help="int8 linear layers: weight-only, or dynamic "
                        "(per-row activation scales, int8 x int8 -> int32)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device the programs run on")
    return p


class _Program(nn.Module):
    """A function over the model as a module, so that ``torch.export``
    lifts the model's weights into the program's state."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def export_programs(model: nn.Module, cfg, dtype: torch.dtype, device: torch.device,
                    max_tokens: int, max_frames: int, num_step: int,
                    guidance_scale: float, t_shift: float, distill: bool,
                    timesteps=None):
    """{name: ExportedProgram} of the three programs over ``model`` (on
    ``device`` in ``dtype``, quantized or not) at batch 1."""
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.models.distill import _cfg_velocity_traced_t
    from zipvoice_tpu_torch.nn import zipformer

    s, t, f = max_tokens, max_frames, cfg.feat_dim

    def text_model(m, tokens, tokens_lens, features_lens):
        embed = zv.forward_text_embed(m, tokens, tokens_lens, dtype)
        return zv.forward_text_condition(embed, tokens_lens, features_lens, t)[0]

    def fm_step(m, t_scalar, xt, text_condition, speech_condition, padding_mask):
        gs = torch.full((), guidance_scale, dtype=torch.float32, device=xt.device)
        if distill:
            return zv.forward_fm_decoder(m, t_scalar, xt, text_condition, speech_condition,
                                         padding_mask, guidance_scale=gs)
        return _cfg_velocity_traced_t(m, t_scalar, xt, text_condition, speech_condition,
                                      padding_mask, gs)

    def sampler(m, tokens, tokens_lens, prompt_features, prompt_features_lens,
                features_lens, noise):
        return zv.sample(m, tokens, tokens_lens, prompt_features, prompt_features_lens,
                         features_lens, noise, num_step=num_step,
                         guidance_scale=guidance_scale, t_shift=t_shift, distill=distill,
                         timesteps=timesteps)

    def ints(*values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    def feats():
        # a new tensor an input: the tracer takes inputs that alias for one
        return torch.zeros((1, t, f), dtype=dtype, device=device)

    tokens = torch.zeros((1, s), dtype=torch.int64, device=device)
    examples = {
        "text_model": (text_model, (tokens, ints(s - 1), ints(t))),
        "fm_decoder_step": (fm_step, (torch.zeros((), dtype=torch.float32, device=device),
                                      feats(), feats(), feats(),
                                      torch.zeros((1, t), dtype=torch.bool, device=device))),
        "sampler_fused": (sampler, (tokens, ints(s - 1), feats(), ints(1), ints(t), feats())),
    }
    flags = zipformer.fused_flags()
    zipformer.set_fused_eval(False)
    zipformer.set_fused_conv(False)
    try:
        with torch.no_grad():
            # one eager call first: the positional tables it caches on the
            # device become constants of the programs (nn/functional)
            for fn, args in examples.values():
                fn(model, *args)
            return {name: torch.export.export(_Program(model, fn), args)
                    for name, (fn, args) in examples.items()}
    finally:
        zipformer.set_fused_eval(flags[0])
        zipformer.set_fused_conv(flags[1])


def save_program(ep, path: Path, device: torch.device):
    """Save with the device type the program runs on as an extra file."""
    torch.export.save(ep, str(path), extra_files={DEVICE_TAG: device.type})


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.ops.quant import cast_quantized, quantize_linear_int8, quantized_bytes
    from zipvoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    assets = load_model_dir(model_dir=args.model_dir, model_name=args.model_name,
                            checkpoint_name=args.checkpoint_name)
    defaults = assets.defaults
    num_step = args.num_step or defaults["num_step"]
    timesteps = (tuple(float(x) for x in args.timesteps.split(","))
                 if args.timesteps else None)
    gs = args.guidance_scale if args.guidance_scale is not None else defaults["guidance_scale"]
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = assets.model
    if args.quantize is not None:
        before = quantized_bytes(model)
        model = cast_quantized(quantize_linear_int8(model, args.quantize), dtype, device)
        logging.info("%s quantization: %.1f MB -> %.1f MB", args.quantize, before / 1e6,
                     quantized_bytes(model) / 1e6)
    else:
        model = model.to(device=device, dtype=dtype)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    programs = export_programs(model.eval(), assets.model_cfg, dtype, device,
                               args.max_tokens, args.max_frames, num_step, gs,
                               args.t_shift, defaults["distill"], timesteps)
    logging.info("traced %s in %.1f s", list(programs), time.monotonic() - t0)
    for name, ep in programs.items():
        path = out_dir / f"{name}.pt2"
        save_program(ep, path, device)
        logging.info("exported %s (%.1f MB)", name, path.stat().st_size / 1e6)
    logging.info("done: %s in %.1f s", out_dir, time.monotonic() - t0)


if __name__ == "__main__":
    main()
