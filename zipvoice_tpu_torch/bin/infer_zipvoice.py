"""Zero-shot TTS inference CLI on PyTorch (CUDA by default).

Usage (single sentence):
  python -m zipvoice_tpu_torch.bin.infer_zipvoice \\
      --model-dir exp/zipvoice --vocoder-path vocos/pytorch_model.bin \\
      --prompt-wav prompt.wav --prompt-text "..." \\
      --text "..." --res-wav-path out.wav

``--model-name zipvoice_distill`` samples with the distilled student (8
steps, guidance 3.0 embedded, no CFG batch, by default).  The tokenizer
defaults to ``emilia`` (espeak IPA for English through piper, the espeak-ng
binary or the offline G2P; pinyin for Chinese).  The model's feature type
picks the vocoder: a ``"type": "bigvgan"`` model dir takes a BigVGAN
generator checkpoint (``bigvgan_generator.pt``) as --vocoder-path.

Batch mode reads a TSV (``name\\tprompt_text\\tprompt_wav\\ttext`` per line)
with --test-list and writes ``<res-dir>/<name>.wav``.  ``--long-form``
splits each text into sentence chunks (``synthesize_long``).  ``--quantize
int8`` serves int8 linear layers (weight-only), ``--quantize int8-dynamic``
quantizes the activations too (``ops/quant.py``).  ``--device cpu`` runs on
the CPU; CUDA is required otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from pathlib import Path

import torch

_NOT_PORTED = "is not yet ported to zipvoice_tpu_torch"


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-name", type=str, default="zipvoice",
                        choices=["zipvoice", "zipvoice_distill"],
                        help="The model used for inference")
    parser.add_argument("--model-dir", type=str, default=None,
                        help="Model dir with checkpoint, model.json, tokens.txt")
    parser.add_argument("--checkpoint-name", type=str, default="model.pt",
                        help="The name of model checkpoint")
    parser.add_argument("--vocoder-path", type=str, default=None,
                        help="Vocoder checkpoint: Vocos (pytorch_model.bin / "
                             ".safetensors) or, for bigvgan features, the BigVGAN "
                             "generator (bigvgan_generator.pt)")
    parser.add_argument("--tokenizer", type=str, default="emilia",
                        help="Tokenizer type")
    parser.add_argument("--lang", type=str, default="en-us",
                        help="Language identifier for the espeak tokenizer")
    parser.add_argument("--test-list", type=str, default=None,
                        help="TSV of name\\tprompt_text\\tprompt_wav\\ttext")
    parser.add_argument("--prompt-wav", type=str, default=None,
                        help="The prompt wav to mimic")
    parser.add_argument("--prompt-text", type=str, default=None,
                        help="The transcription of the prompt wav")
    parser.add_argument("--text", type=str, default=None,
                        help="The text to synthesize")
    parser.add_argument("--res-dir", type=str, default="results",
                        help="Output dir for --test-list mode")
    parser.add_argument("--res-wav-path", type=str, default="result.wav",
                        help="Output wav for single-sentence mode")
    parser.add_argument("--guidance-scale", type=float, default=None,
                        help="Classifier-free guidance scale (default: per-model)")
    parser.add_argument("--num-step", type=int, default=None,
                        help="Number of sampling steps (default: per-model)")
    parser.add_argument("--feat-scale", type=float, default=0.1,
                        help="The scale factor of fbank feature")
    parser.add_argument("--feat-bias", type=float, default=0.0,
                        help="The bias added to fbank feature")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="Speech speed control (>1 speeds up)")
    parser.add_argument("--t-shift", type=float, default=0.5,
                        help="Timestep shift toward low SNR if < 1.0")
    parser.add_argument("--timesteps", type=str, default=None,
                        help="Explicit comma-separated Euler grid in [0,1], "
                             "overriding --num-step/--t-shift")
    parser.add_argument("--target-rms", type=float, default=0.1,
                        help="Prompt RMS normalization target (0 disables)")
    parser.add_argument("--seed", type=int, default=666, help="Random seed")
    parser.add_argument("--long-form", action="store_true",
                        help="chunked synthesis for long texts")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"], help="Compute dtype")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8", "int8-dynamic"],
                        help="int8 linear layers: weight-only, or dynamic "
                             "(per-row activation scales, int8 x int8 -> int32)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"], help="Device to run on")
    return parser


def load_vocoder_params(path: str, kind: str = "vocos"):
    """The vocoder weights at ``path`` in the port's layout: Vocos, or the
    BigVGAN generator (a ``generator.`` key prefix stripped, weight norm
    fused)."""
    from zipvoice_tpu_torch.io.checkpoint import load_torch_state_dict

    sd = load_torch_state_dict(path)
    if kind == "bigvgan":
        from zipvoice_tpu_torch.audio.bigvgan import load_bigvgan_params

        return load_bigvgan_params({k[len("generator."):] if k.startswith("generator.")
                                    else k: v for k, v in sd.items()})
    from zipvoice_tpu_torch.audio.vocos import load_vocos_params

    return load_vocos_params(sd)


def build_pipeline(args):
    """The pipeline of the model the CLI arguments name (the variant from
    its registry entry), and its sampling defaults resolved against
    --num-step / --guidance-scale."""
    from zipvoice_tpu_torch.audio.vocos import VocosConfig, vocos_config_from_params
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline

    if args.vocoder_path is None:
        raise SystemExit(f"downloading the vocoder {_NOT_PORTED}: pass --vocoder-path")
    assets = load_model_dir(model_dir=args.model_dir, model_name=args.model_name,
                            checkpoint_name=args.checkpoint_name,
                            tokenizer_name=args.tokenizer, lang=args.lang)
    feat_cfg = dataclasses.replace(assets.feat_cfg, feat_scale=args.feat_scale,
                                   feat_bias=args.feat_bias)
    # the feature type picks the vocoder family
    vocoder = "bigvgan" if feat_cfg.type == "bigvgan" else "vocos"
    vocoder_params = load_vocoder_params(args.vocoder_path, vocoder)
    pipeline = ZipVoicePipeline(
        model=assets.model,
        model_cfg=assets.model_cfg,
        feat_cfg=feat_cfg,
        vocos_params=vocoder_params,
        vocos_cfg=(vocos_config_from_params(vocoder_params, feat_cfg.hop_length)
                   if vocoder == "vocos" else VocosConfig(hop_length=feat_cfg.hop_length)),
        tokenizer=assets.tokenizer,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=args.device,
        distill=assets.defaults["distill"],
        variant=assets.defaults["variant"],
        vocoder=vocoder,
        quantize=args.quantize,
    )
    d = assets.defaults
    num_step = args.num_step if args.num_step is not None else d["num_step"]
    gs = args.guidance_scale if args.guidance_scale is not None else d["guidance_scale"]
    return pipeline, num_step, gs


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.model_dir is None:
        raise SystemExit(f"downloading a model {_NOT_PORTED}: pass --model-dir")

    from zipvoice_tpu_torch.audio.wav import read_wav, write_wav

    pipeline, num_step, guidance_scale = build_pipeline(args)
    sr = pipeline.feat_cfg.sampling_rate
    timesteps = (tuple(float(x) for x in args.timesteps.split(","))
                 if args.timesteps else None)
    if timesteps is not None and args.long_form:
        raise SystemExit("--timesteps is not supported with --long-form (chunked "
                         "synthesis derives its schedule a chunk); drop one flag")

    def synth_one(prompt_text, prompt_wav_path, text, out_path):
        wav, wav_sr = read_wav(prompt_wav_path)
        extra = {} if args.long_form else {"timesteps": timesteps}
        synth = pipeline.synthesize_long if args.long_form else pipeline.synthesize
        res = synth(
            text=text, prompt_text=prompt_text, prompt_wav=wav, prompt_sr=wav_sr,
            num_step=num_step, guidance_scale=guidance_scale, speed=args.speed,
            t_shift=args.t_shift, target_rms=args.target_rms, seed=args.seed,
            **extra,
        )
        write_wav(out_path, res.wav, sr)
        m = res.metrics
        logging.info("%s: %.2fs audio, rtf %.4f (model %.4f, vocoder %.4f)",
                     out_path, m["wav_seconds"], m["rtf"],
                     m["t_no_vocoder"] / m["wav_seconds"],
                     m["t_vocoder"] / m["wav_seconds"])
        return m

    all_metrics = []
    if args.test_list is not None:
        os.makedirs(args.res_dir, exist_ok=True)
        with open(args.test_list, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                name, prompt_text, prompt_wav_path, text = line.strip().split("\t")[:4]
                out = Path(args.res_dir) / f"{name}.wav"
                all_metrics.append(synth_one(prompt_text, prompt_wav_path, text,
                                             str(out)))
        if all_metrics:
            tot = {k: sum(m[k] for m in all_metrics) for k in all_metrics[0]}
            logging.info(
                "Average RTF: %.4f (model %.4f, vocoder %.4f) over %.2fs audio",
                tot["t"] / tot["wav_seconds"], tot["t_no_vocoder"] / tot["wav_seconds"],
                tot["t_vocoder"] / tot["wav_seconds"], tot["wav_seconds"],
            )
    else:
        if not (args.prompt_wav and args.prompt_text is not None and args.text):
            raise SystemExit("need --prompt-wav, --prompt-text and --text "
                             "(or --test-list)")
        all_metrics.append(synth_one(args.prompt_text, args.prompt_wav, args.text,
                                     args.res_wav_path))
    return all_metrics


if __name__ == "__main__":
    main()
