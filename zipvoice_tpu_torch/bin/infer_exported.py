"""Inference from the programs of ``bin/export_model`` (CUDA by default).

The PyTorch counterpart of the reference package's ``bin/infer_exported``.
It loads the exported artifacts and synthesizes either with the fused
sampler program (``--mode fused``) or with the text program and the
one-step program driven by a Euler loop on the host (``--mode
host-loop``).  The static sizes come from the loaded program's inputs.

On the card the fused program runs as a ``utils/graphs.Program``: captured
as a CUDA graph on its first call and replayed after.  The host loop calls
the step program eagerly, once a step.  Each mode loads only its own
programs.  The noise comes from a seeded
``torch.Generator`` on the device.  The prompt fbank and the vocoder are
the pipeline's (f32).

Usage:
  python -m zipvoice_tpu_torch.bin.infer_exported --export-dir EXPORTED \\
      --model-dir exp/zipvoice --vocoder-path vocos.bin \\
      --prompt-wav prompt.wav --prompt-text "..." --text "..."
"""

from __future__ import annotations

import argparse
import logging
import time
import zipfile
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np
import torch

# B1's and B2's custom ops must be registered before a program is loaded
import zipvoice_tpu_torch.ops.attention  # noqa: F401
from zipvoice_tpu_torch.bin.export_model import DEVICE_TAG


def artifact_device_type(path: Union[str, Path]) -> str:
    """The device type an artifact of ``bin/export_model`` was exported on,
    read from its archive without loading it."""
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.endswith(f"/extra/{DEVICE_TAG}"):
                return z.read(name).decode()
    raise ValueError(f"{path} names no device type: not written by export_model")


def load_exported(path: Union[str, Path], device: Union[str, torch.device]):
    """The ExportedProgram at ``path``; an artifact exported for another
    device type than ``device``'s raises ValueError (it does not run
    elsewhere)."""
    want = torch.device(device).type
    have = artifact_device_type(path)
    if have != want:
        raise ValueError(f"{path} was exported for {have!r} and cannot run on {want!r}: "
                         f"export it again with --device {want}")
    return torch.export.load(str(path))


def input_specs(ep) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each user input of an ExportedProgram, in order."""
    names = ep.graph_signature.user_inputs
    vals = {n.name: n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"}
    return [(tuple(vals[n].shape), vals[n].dtype) for n in names]


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--export-dir", type=str, required=True)
    p.add_argument("--model-dir", type=str, required=True,
                   help="for tokens.txt / model.json (tokenizer + dims)")
    p.add_argument("--tokenizer", type=str, default="emilia")
    p.add_argument("--vocoder-path", type=str, default=None,
                   help="Vocos checkpoint; omitted: charactr/vocos-mel-24khz through "
                        "the Hugging Face Hub's cache")
    p.add_argument("--mode", type=str, default="fused", choices=["fused", "host-loop"])
    p.add_argument("--num-step", type=int, default=16,
                   help="host-loop mode only (fused bakes its own)")
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--prompt-wav", type=str, required=True)
    p.add_argument("--prompt-text", type=str, required=True)
    p.add_argument("--text", type=str, required=True)
    p.add_argument("--res-wav-path", type=str, default="result.wav")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--target-rms", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on (the artifacts' own)")
    return p


class ExportedSampler:
    """The exported programs of one export dir on ``device`` for one mode:
    ``fused``, the fused sampler as a captured program; ``host-loop``, the
    text and step programs as modules.  Only that mode's programs load."""

    def __init__(self, export_dir: Union[str, Path], device: Union[str, torch.device],
                 mode: str = "fused"):
        from zipvoice_tpu_torch.utils.device import resolve_device
        from zipvoice_tpu_torch.utils.graphs import GraphSet, Program

        if mode not in ("fused", "host-loop"):
            raise ValueError(f"unknown mode {mode!r}")
        self.export_dir, self.mode = Path(export_dir), mode
        self.device = resolve_device(device)

        def load(name):
            return load_exported(self.export_dir / f"{name}.pt2", self.device)

        if mode == "fused":
            ep = load("sampler_fused")
            specs = input_specs(ep)
            (_, self.s_max), ((_, self.t_max, self.feat_dim), self.dtype) = (specs[0][0],
                                                                             specs[2])
            self.graphs = GraphSet(self.device)
            self.fused = Program(self.graphs, "sampler_fused", (str(self.export_dir),),
                                 ep.module())
        else:
            text, step = load("text_model"), load("fm_decoder_step")
            _, self.s_max = input_specs(text)[0][0]
            (_, self.t_max, self.feat_dim), self.dtype = input_specs(step)[1]
            self.text, self.step = text.module(), step.module()

    def inputs(self, tokens, prompt_tokens, prompt_feats: torch.Tensor, speed: float,
               pad_id: int, seed: int):
        """The fused program's six inputs for one request and its total
        frames: tokens padded to the static size, the prompt fbank zero-
        padded, the lengths (int64) and the seeded noise (drawn and kept in
        f32: the host loop starts from it, the fused program takes it in
        its dtype)."""
        from zipvoice_tpu_torch.models.zipvoice import predict_features_lens

        dev, p_len = self.device, int(prompt_feats.shape[0])
        cat = list(prompt_tokens) + list(tokens)
        total = int(predict_features_lens(np.array([p_len]),
                                          np.array([max(len(prompt_tokens), 1)]),
                                          np.array([len(tokens)]), speed=speed)[0])
        if len(cat) + 1 > self.s_max or total > self.t_max:
            raise ValueError(f"request of {len(cat)} tokens and {total} frames exceeds the "
                             f"export's {self.s_max} tokens and {self.t_max} frames")
        tokens_padded = torch.full((1, self.s_max), pad_id, dtype=torch.int64, device=dev)
        tokens_padded[0, : len(cat)] = torch.tensor(cat, dtype=torch.int64, device=dev)
        pf = torch.zeros((1, self.t_max, self.feat_dim), dtype=self.dtype, device=dev)
        pf[0, :p_len] = prompt_feats.to(dev, self.dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn((1, self.t_max, self.feat_dim), generator=gen, device=dev,
                            dtype=torch.float32)

        def ints(v):
            return torch.tensor([v], dtype=torch.int64, device=dev)

        return (tokens_padded, ints(len(cat)), pf, ints(p_len), ints(total), noise), total

    @torch.no_grad()
    def host_loop(self, args, num_step: int, t_shift: float) -> torch.Tensor:
        """The text program once, then ``num_step`` Euler steps of the step
        program with the state in f32 on the device."""
        from zipvoice_tpu_torch.sampling.euler import get_time_steps

        text, step = self.text, self.step
        tokens_padded, tokens_lens, pf, pf_lens, features_lens, noise = args
        cond = text(tokens_padded, tokens_lens, features_lens)
        frames = torch.arange(self.t_max, device=self.device)[None, :]
        pad_mask = frames >= features_lens[:, None]
        speech_cond = pf.masked_fill((frames >= pf_lens[:, None])[:, :, None], 0.0)
        ts = get_time_steps(0.0, 1.0, num_step, t_shift)
        x = noise.float()
        for i in range(num_step):
            t = torch.tensor(float(ts[i]), dtype=torch.float32, device=self.device)
            v = step(t, x.to(self.dtype), cond, speech_cond, pad_mask).float()
            x = x + v * (float(ts[i + 1]) - float(ts[i]))
        return x


def load(args):
    """(sampler, pipeline) of a parsed command line: the mode's exported
    programs and the pipeline whose prompt fbank, tokenizer and vocoder a
    request uses.  Everything before the first request."""
    from zipvoice_tpu_torch.audio.vocos import vocos_config_from_params
    from zipvoice_tpu_torch.bin.infer_zipvoice import load_vocoder_params
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline

    sampler = ExportedSampler(args.export_dir, args.device, args.mode)
    assets = load_model_dir(model_dir=args.model_dir, tokenizer_name=args.tokenizer)
    vocoder_params = load_vocoder_params(args.vocoder_path)
    pipe = ZipVoicePipeline(
        model=assets.model, model_cfg=assets.model_cfg, feat_cfg=assets.feat_cfg,
        vocos_params=vocoder_params,
        vocos_cfg=vocos_config_from_params(vocoder_params, assets.feat_cfg.hop_length),
        tokenizer=assets.tokenizer, device=sampler.device,
    )
    return sampler, pipe


def run(args, sampler: ExportedSampler, pipe) -> dict:
    """The command line's request through ``load``'s programs, written to
    --res-wav-path; returns ``synthesize``'s result."""
    from zipvoice_tpu_torch.audio.wav import read_wav, write_wav

    res = synthesize(sampler, pipe, args.text, args.prompt_text, *read_wav(args.prompt_wav),
                     num_step=args.num_step, t_shift=args.t_shift,
                     speed=args.speed, target_rms=args.target_rms, seed=args.seed)
    write_wav(args.res_wav_path, res["wav"], pipe.feat_cfg.sampling_rate)
    logging.info("wrote %s (%.2fs, rtf %.4f)", args.res_wav_path, res["wav_seconds"],
                 res["rtf"])
    return res


def main(argv=None):
    """Synthesize one request; returns ``synthesize``'s result with the
    loaded ``sampler`` and the ``pipeline`` (prompt fbank, vocoder)."""
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    sampler, pipe = load(args)
    return {**run(args, sampler, pipe), "sampler": sampler, "pipeline": pipe}


def synthesize(sampler: ExportedSampler, pipe, text: str, prompt_text: str,
               prompt_wav: np.ndarray, prompt_sr: int, num_step: int = 16,
               t_shift: float = 0.5, speed: float = 1.0, target_rms: float = 0.1,
               seed: int = 666) -> dict:
    """One request through the exported programs: {"wav", "x1" (the
    program's (1, T, F) output), "wav_seconds", "t", "rtf"}.  The time
    runs from the text to the PCM on the host."""
    t0 = time.monotonic()
    tok = pipe.tokenizer
    tokens = tok.texts_to_token_ids([text])[0]
    prompt_tokens = tok.texts_to_token_ids([prompt_text])[0]
    pf, prompt_rms = pipe.prompt_features(prompt_wav, prompt_sr, target_rms)
    args, total = sampler.inputs(tokens, prompt_tokens, pf, speed, pipe.model_cfg.pad_id,
                                 seed)
    if sampler.mode == "fused":
        x1 = sampler.fused(*args[:5], args[5].to(sampler.dtype))
    else:
        x1 = sampler.host_loop(args, num_step, t_shift)
    # strip the prompt, undo the feature scaling, vocode with the pipeline's
    # vocoder at the static frame count
    p_len = int(pf.shape[0])
    gen_len = total - p_len
    fcfg = pipe.feat_cfg
    mel = torch.zeros((sampler.t_max, sampler.feat_dim), dtype=torch.float32,
                      device=sampler.device)
    mel[:gen_len] = x1[0, p_len:total].float() / fcfg.feat_scale - fcfg.feat_bias
    wav = pipe.vocode(mel, gen_len)
    if prompt_rms < target_rms:
        wav = wav * (prompt_rms / target_rms)
    seconds = time.monotonic() - t0
    wav_seconds = wav.shape[-1] / fcfg.sampling_rate
    return {"wav": wav, "x1": x1, "wav_seconds": wav_seconds, "t": seconds,
            "rtf": seconds / wav_seconds}


if __name__ == "__main__":
    main()
