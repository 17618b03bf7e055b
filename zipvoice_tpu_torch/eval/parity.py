"""Mel parity: the port's sampler against the reference torch ZipVoice on
the same checkpoint and the same noise, for all four model variants.

The acceptance instrument of BASELINE.md (mel MSE < 1e-3 in f32, < 1e-2 in
bf16): it loads a model dir into the port and into the reference
``zipvoice`` package (its source at ``reference_path``, put on
``sys.path``), builds one synthetic conditioning from a seeded numpy
generator, injects one noise tensor into both samplers and reports the mel
MSE.  The reference side runs on the CPU in f32 and needs only torch; the
port's side runs on ``device`` (the card by default) in f32 or bf16, through
``models/zipvoice.sample`` or ``models/dialog.sample_dialog``.  The
conditioning is drawn in the JAX package's order, so both packages feed the
reference identical inputs.

Variant coverage (reference classes):
  zipvoice                -> zipvoice.models.zipvoice.ZipVoice
  zipvoice_distill        -> zipvoice.models.zipvoice_distill.ZipVoiceDistill
                             (guidance-scale embedding, no CFG doubling)
  zipvoice_dialog         -> zipvoice.models.zipvoice_dialog.ZipVoiceDialog
                             (speaker-turn embeddings in the text embed)
  zipvoice_dialog_stereo  -> ...ZipVoiceDialogStereo (two-stream backbone,
                             2xF features)

Usage:
  python -m zipvoice_tpu_torch.eval.parity --model-dir exp/zipvoice \\
      --reference-path reference [--model-name zipvoice] [--num-step 16] \\
      [--seconds 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from zipvoice_tpu_torch.io.model_dir import MODEL_REGISTRY

# the reference package's source, where golden acceptance looks for it
DEFAULT_REFERENCE = Path(__file__).resolve().parents[2] / "reference"
BUDGETS = {"float32": 1e-3, "bfloat16": 1e-2}


def _ref_model(model_name: str, raw: dict, vocab_size: int, pad_id: int,
               spk_a_id: Optional[int], spk_b_id: Optional[int]):
    """Instantiate and return the reference torch model class of a variant."""
    if model_name == "zipvoice":
        from zipvoice.models.zipvoice import ZipVoice

        return ZipVoice(**raw, vocab_size=vocab_size, pad_id=pad_id)
    if model_name == "zipvoice_distill":
        from zipvoice.models.zipvoice_distill import ZipVoiceDistill

        return ZipVoiceDistill(**raw, vocab_size=vocab_size, pad_id=pad_id)
    kw = {}
    if spk_a_id is not None:
        kw = dict(spk_a_id=spk_a_id, spk_b_id=spk_b_id)
    if model_name == "zipvoice_dialog":
        from zipvoice.models.zipvoice_dialog import ZipVoiceDialog

        return ZipVoiceDialog(**raw, vocab_size=vocab_size, pad_id=pad_id, **kw)
    if model_name == "zipvoice_dialog_stereo":
        from zipvoice.models.zipvoice_dialog import ZipVoiceDialogStereo

        return ZipVoiceDialogStereo(**raw, vocab_size=vocab_size, pad_id=pad_id, **kw)
    raise ValueError(f"unknown model_name: {model_name}")


def run_parity(
    model_dir: str,
    reference_path: Union[str, Path] = DEFAULT_REFERENCE,
    num_step: int = 16,
    guidance_scale: float = 1.0,
    t_shift: float = 0.5,
    seconds: float = 5.0,
    prompt_seconds: float = 2.0,
    seed: int = 0,
    tokenizer: str = "simple",
    dtype: str = "float32",
    model_name: str = "zipvoice",
    spk_a_id: Optional[int] = None,
    spk_b_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> float:
    """Mel MSE of the port's sampler against the reference's (CPU, f32) on
    the same checkpoint and noise.  ``dtype`` is the port's compute dtype:
    "bfloat16" measures the deployment dtype against the f32 reference
    (budgets ``BUDGETS``)."""
    reference_path = str(reference_path)
    if reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    from zipvoice.utils.common import make_pad_mask as ref_make_pad_mask

    from zipvoice_tpu_torch.eval.metrics import mel_mse
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models import dialog as dlg
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    assets = load_model_dir(model_dir=model_dir, model_name=model_name,
                            tokenizer_name=tokenizer)
    cfg = assets.model_cfg
    reg = MODEL_REGISTRY[model_name]
    dialog = reg["variant"] != "zipvoice"
    stereo = reg["variant"] == "dialog_stereo"
    # stereo generates 2-channel features: x and the speech condition are 2F
    f_x = cfg.feat_dim * (2 if stereo else 1)

    # the reference model with the same weights
    raw = json.loads((Path(model_dir) / "model.json").read_text())["model"]
    ref_model = _ref_model(model_name, raw, cfg.vocab_size, cfg.pad_id, spk_a_id, spk_b_id)
    ckpt = torch.load(Path(model_dir) / "model.pt", map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    ref_model.load_state_dict(sd, strict=True)
    ref_model.eval()

    # synthetic conditioning shared by both sides, drawn in the JAX
    # package's order
    rng = np.random.default_rng(seed)
    frame_rate = assets.feat_cfg.frame_rate
    total = int(seconds * frame_rate)
    if prompt_seconds >= seconds:
        raise ValueError(f"--prompt-seconds ({prompt_seconds}) must be < --seconds "
                         f"({seconds}): the prompt is a prefix of the generated span")
    prompt_len = int(prompt_seconds * frame_rate)
    vocab = cfg.vocab_size
    body: List[int] = [int(t) for t in rng.integers(1, vocab, 24)]
    prompt_tokens: List[int] = [int(t) for t in rng.integers(1, vocab, 10)]
    sa = spk_a_id if spk_a_id is not None else dlg.SPK_A_ID_DEFAULT
    sb = spk_b_id if spk_b_id is not None else dlg.SPK_B_ID_DEFAULT
    if dialog:
        # interleave speaker-turn tokens so the speaker-embedding path is live
        body = [t for t in body if t not in (sa, sb)]
        prompt_tokens = [t for t in prompt_tokens if t not in (sa, sb)]
        body = [sa] + body[:12] + [sb] + body[12:]
        prompt_tokens = [sa] + prompt_tokens[:5] + [sb] + prompt_tokens[5:]
    cat = prompt_tokens + body
    prompt_feats = (rng.standard_normal((prompt_len, f_x)) * 0.1).astype(np.float32)
    noise = rng.standard_normal((1, total, f_x)).astype(np.float32)

    # --- the reference path (ZipVoice.sample's composition with the noise
    # injected); the variants' forward_text_embed add the speaker embeddings
    with torch.no_grad():
        embed, tl = ref_model.forward_text_embed([cat])
        text_cond, pad_mask = ref_model.forward_text_condition(embed, tl, torch.tensor([total]))
        pmask = ref_make_pad_mask(torch.tensor([prompt_len]), total)
        pf = torch.zeros(1, total, f_x)
        pf[0, :prompt_len] = torch.from_numpy(prompt_feats)
        speech_cond = torch.where(pmask.unsqueeze(-1), torch.zeros(1), pf)
        ref_x1 = ref_model.solver.sample(
            x=torch.from_numpy(noise), text_condition=text_cond,
            speech_condition=speech_cond, padding_mask=pad_mask,
            num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift,
        ).numpy()[0]
    del ref_model

    # --- the port's path (the same shapes, no bucketing)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model = assets.model.to(device=dev, dtype=tdtype).eval()

    def ints(values):
        return torch.tensor(values, dtype=torch.int64, device=dev)

    pf_t = torch.zeros((1, total, f_x), dtype=tdtype, device=dev)
    pf_t[0, :prompt_len] = torch.from_numpy(prompt_feats).to(dev, tdtype)
    args = (torch.from_numpy(zv.pad_labels([cat], cfg.pad_id)).to(dev), ints([len(cat)]),
            pf_t, ints([prompt_len]), ints([total]), torch.from_numpy(noise).to(dev, tdtype))
    common = dict(num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift)
    with torch.no_grad():
        if dialog:
            out = dlg.sample_dialog(model, *args, spk_a_id=sa, spk_b_id=sb, **common)
        else:
            out = zv.sample(model, *args, distill=reg["distill"], **common)
    x1 = out.float().cpu().numpy()[0]

    mse = mel_mse(x1, ref_x1)
    logging.info("mel parity [%s] (%s, %s): mse=%.3e max=%.3e (target < %s)",
                 model_name, dtype, dev, mse, float(np.abs(x1 - ref_x1).max()),
                 "1e-2 bf16" if dtype == "bfloat16" else "1e-3 f32")
    return mse


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", type=str, default="zipvoice", choices=list(MODEL_REGISTRY))
    p.add_argument("--reference-path", type=str, default=str(DEFAULT_REFERENCE))
    p.add_argument("--num-step", type=int, default=16)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--prompt-seconds", type=float, default=2.0)
    p.add_argument("--tokenizer", type=str, default="simple")
    p.add_argument("--dtype", type=str, default="both",
                   choices=["float32", "bfloat16", "both"],
                   help="the port's compute dtype (budget: <1e-3 f32, <1e-2 bf16); "
                        "'both' reports and gates on both")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="the port's device (the reference runs on the CPU)")
    return p


def main(argv=None) -> int:
    """Report each dtype's mel MSE; returns 0 when every one is within its
    budget, else 1."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dtypes = ["float32", "bfloat16"] if args.dtype == "both" else [args.dtype]
    ok = True
    for dt in dtypes:
        mse = run_parity(args.model_dir, args.reference_path, args.num_step,
                         args.guidance_scale, args.t_shift, args.seconds,
                         prompt_seconds=args.prompt_seconds, tokenizer=args.tokenizer,
                         dtype=dt, model_name=args.model_name, device=args.device)
        passed = mse < BUDGETS[dt]
        ok = ok and passed
        print(f"mel_mse[{args.model_name}][{dt}]={mse:.3e} {'PASS' if passed else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
