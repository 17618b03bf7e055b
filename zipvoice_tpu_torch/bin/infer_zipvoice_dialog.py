"""Dialogue TTS inference CLI on PyTorch (CUDA by default).

Two-party dialogue generation with [S1]/[S2] speaker-turn tags.  Prompts are
either merged (one wav whose transcription carries both speakers' tags) or
split (two wavs, one a speaker: concatenated for the mono model; for the
stereo model speaker 1 on channel 0 and speaker 2 on channel 1).  The
stereo model generates 2-channel features, vocoded a channel each into a
2-channel wav.

Example:
  python -m zipvoice_tpu_torch.bin.infer_zipvoice_dialog \\
      --model-name zipvoice_dialog --model-dir exp/dialog \\
      --vocoder-path vocos/pytorch_model.bin \\
      --prompt-text "[S1] hi there [S2] hello" --prompt-wav merged.wav \\
      --text "[S1] how are you? [S2] great!" --res-wav-path out.wav

Batch mode reads a TSV with --test-list: ``name\\tprompt_text\\tprompt_wav\\t
text`` (merged prompt) or ``name\\tprompt_text_1\\tprompt_wav_1\\t
prompt_text_2\\tprompt_wav_2\\ttext`` (split prompts) a line, and writes
``<res-dir>/<name>.wav``.  ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np

from zipvoice_tpu_torch.bin.infer_zipvoice import _NOT_PORTED


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-name", type=str, default="zipvoice_dialog",
                   choices=["zipvoice_dialog", "zipvoice_dialog_stereo"])
    p.add_argument("--model-dir", type=str, default=None,
                   help="Model dir with checkpoint, model.json, tokens.txt")
    p.add_argument("--checkpoint-name", type=str, default="model.pt")
    p.add_argument("--vocoder-path", type=str, default=None,
                   help="Vocos checkpoint (pytorch_model.bin / .safetensors)")
    p.add_argument("--test-list", type=str, default=None,
                   help="TSV: name\\tprompt_text\\tprompt_wav\\ttext "
                        "(or split prompts: name\\tp1_text\\tp1_wav\\t"
                        "p2_text\\tp2_wav\\ttext)")
    p.add_argument("--prompt-text", type=str, default=None)
    p.add_argument("--prompt-wav", type=str, default=None,
                   help="merged prompt wav (both speakers)")
    p.add_argument("--prompt-text-1", type=str, default=None)
    p.add_argument("--prompt-wav-1", type=str, default=None)
    p.add_argument("--prompt-text-2", type=str, default=None)
    p.add_argument("--prompt-wav-2", type=str, default=None)
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--res-dir", type=str, default="results")
    p.add_argument("--res-wav-path", type=str, default="result.wav")
    p.add_argument("--num-step", type=int, default=None,
                   help="Number of sampling steps (default: per-model, 16)")
    p.add_argument("--guidance-scale", type=float, default=None,
                   help="Classifier-free guidance scale (default: per-model, 1.5)")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--target-rms", type=float, default=0.1)
    p.add_argument("--feat-scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on")
    # what infer_zipvoice.build_pipeline reads and this CLI does not offer:
    # the model's own tokenizer (dialog), no feature bias, float weights
    p.set_defaults(tokenizer=None, lang="en-us", feat_bias=0.0, quantize=None)
    return p


def load_merged_prompt(args, sampling_rate: int, stereo: bool):
    """(prompt_text, prompt_wav (C, L)) from a merged prompt or from the two
    split ones: mono concatenates the two wavs; stereo puts speaker 1 on
    channel 0 and speaker 2 on channel 1, silence elsewhere."""
    from zipvoice_tpu_torch.audio.wav import read_wav, resample

    def load(path):
        wav, sr = read_wav(path)
        if sr != sampling_rate:
            wav = resample(wav, sr, sampling_rate)
        return wav

    if args.prompt_wav:
        wav = load(args.prompt_wav)
        if not stereo and wav.shape[0] != 1:
            wav = wav.mean(axis=0, keepdims=True)
        if stereo and wav.shape[0] != 2:
            raise ValueError("a merged stereo prompt must have 2 channels")
        return args.prompt_text, wav

    if not (args.prompt_wav_1 and args.prompt_wav_2):
        raise ValueError("need --prompt-wav or both --prompt-wav-1 and --prompt-wav-2")
    w1, w2 = load(args.prompt_wav_1), load(args.prompt_wav_2)
    text = f"[S1]{args.prompt_text_1}[S2]{args.prompt_text_2}"
    if not stereo:
        w1 = w1.mean(axis=0, keepdims=True)
        w2 = w2.mean(axis=0, keepdims=True)
        return text, np.concatenate([w1, w2], axis=1)
    w1, w2 = w1.mean(axis=0), w2.mean(axis=0)
    wav = np.zeros((2, len(w1) + len(w2)), np.float32)
    wav[0, : len(w1)] = w1
    wav[1, len(w1):] = w2
    return text, wav


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if args.model_dir is None:
        raise SystemExit(f"downloading a model {_NOT_PORTED}: pass --model-dir")

    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline

    stereo = args.model_name == "zipvoice_dialog_stereo"
    pipeline, num_step, guidance_scale = build_pipeline(args)
    sr = pipeline.feat_cfg.sampling_rate

    def synth_one(prompt_text, prompt_wav, text, out_path):
        res = pipeline.synthesize(
            text=text, prompt_text=prompt_text, prompt_wav=prompt_wav, prompt_sr=sr,
            num_step=num_step, guidance_scale=guidance_scale, speed=args.speed,
            t_shift=args.t_shift, target_rms=args.target_rms, seed=args.seed,
        )
        write_wav(out_path, res.wav, sr)
        m = res.metrics
        logging.info("%s: %d channel(s), %.2fs audio, rtf %.4f (model %.4f, vocoder %.4f)",
                     out_path, 2 if stereo else 1, m["wav_seconds"], m["rtf"],
                     m["rtf_no_vocoder"], m["rtf_vocoder"])
        return m

    all_metrics = []
    if args.test_list:
        os.makedirs(args.res_dir, exist_ok=True)
        with open(args.test_list, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                items = line.rstrip("\n").split("\t")
                if len(items) == 4:
                    name, ptext, pwav, text = items
                    row = dict(prompt_text=ptext, prompt_wav=pwav, prompt_wav_1=None,
                               prompt_wav_2=None)
                elif len(items) == 6:
                    name, pt1, pw1, pt2, pw2, text = items
                    row = dict(prompt_wav=None, prompt_text_1=pt1, prompt_wav_1=pw1,
                               prompt_text_2=pt2, prompt_wav_2=pw2)
                else:
                    raise ValueError(f"bad test-list line: {items}")
                prompt_text, prompt_wav = load_merged_prompt(
                    argparse.Namespace(**{**vars(args), **row}), sr, stereo)
                all_metrics.append(synth_one(prompt_text, prompt_wav, text,
                                             str(Path(args.res_dir) / f"{name}.wav")))
    else:
        if not args.text:
            raise SystemExit("need --text (or --test-list)")
        prompt_text, prompt_wav = load_merged_prompt(args, sr, stereo)
        all_metrics.append(synth_one(prompt_text, prompt_wav, args.text,
                                     args.res_wav_path))
    return all_metrics


if __name__ == "__main__":
    main()
