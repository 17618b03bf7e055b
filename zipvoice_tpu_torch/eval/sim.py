"""Speaker-similarity evaluation (SIM-o).

Embeds the prompt and the generated wav of each test-list row with a
speaker encoder and reports the mean cosine similarity.  The paper's
backend is the WavLM-large + finetuned ECAPA-TDNN stack
(``eval/models/ecapa_tdnn_wavlm.py``): pass ``--model-dir``, a local clone
of k2-fsa/TTS_eval_models (``speaker_similarity/wavlm_large_finetune.pth``
and ``speaker_similarity/wavlm_large/wavlm_large.pt``).  Without it a HF
WavLM-base-sv encoder is used, whose numbers are not comparable with the
paper's.  The encoders run on ``--device``.

cpSIM (``eval/cpsim.py``) scores per-speaker tracks with the best speaker
permutation; ``cp_sim`` is its scorer.

Usage:
  python -m zipvoice_tpu_torch.eval.sim --wav-dir results --test-list test.tsv \\
      --model-dir /path/to/tts_eval_models
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np


class EcapaWavLMEncoder:
    """Finetuned ECAPA-TDNN on WavLM-large; model_dir is a local clone of
    k2-fsa/TTS_eval_models."""

    MAX_SECONDS = 120  # the published protocol's cap on a wav

    def __init__(self, model_dir: str, device="cpu"):
        import os

        import torch

        from zipvoice_tpu_torch.eval.models.ecapa_tdnn_wavlm import load_sv_model

        self.torch = torch
        self.device = torch.device(device)
        sv = os.path.join(model_dir, "speaker_similarity/wavlm_large_finetune.pth")
        ssl = os.path.join(model_dir, "speaker_similarity/wavlm_large/wavlm_large.pt")
        self.model = load_sv_model(sv, ssl if os.path.exists(ssl) else None).to(self.device)

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        from zipvoice_tpu_torch.audio.wav import resample

        wav = resample(np.asarray(wav, np.float32).reshape(1, -1), sr, 16000)
        wav = wav[:, : self.MAX_SECONDS * 16000]
        with self.torch.no_grad():
            emb = self.model(self.torch.from_numpy(wav).to(self.device))
        return emb[0].cpu().numpy()


class SpeakerEncoder:
    """Mean-pooled WavLM embedding, a lightweight fallback (numbers not
    comparable with the paper's; use EcapaWavLMEncoder through
    --model-dir)."""

    def __init__(self, model_name: str = "microsoft/wavlm-base-plus-sv", device="cpu"):
        import torch
        from transformers import AutoFeatureExtractor, AutoModel

        self.torch = torch
        self.device = torch.device(device)
        self.fe = AutoFeatureExtractor.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name).to(self.device)
        self.model.eval()

    def embed(self, wav: np.ndarray, sr: int) -> np.ndarray:
        from zipvoice_tpu_torch.audio.wav import resample

        wav = resample(np.asarray(wav, np.float32).reshape(1, -1), sr, 16000)[0]
        inputs = self.fe(wav, sampling_rate=16000, return_tensors="pt")
        with self.torch.no_grad():
            out = self.model(**{k: v.to(self.device) for k, v in inputs.items()})
        if hasattr(out, "embeddings"):
            emb = out.embeddings[0]
        else:
            emb = out.last_hidden_state.mean(dim=1)[0]
        return emb.cpu().numpy()


def cp_sim(encoder, gen_tracks, prompt_tracks, sr: int) -> float:
    """Best-permutation per-speaker similarity, all tracks at rate sr."""
    from zipvoice_tpu_torch.eval.cpsim import cp_sim_tracks

    return cp_sim_tracks(encoder, gen_tracks, sr, prompt_tracks, sr)


def main(argv=None) -> dict:
    """Score; returns {"SIM": mean, "rows": [(name, similarity), ...]}."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--wav-dir", type=str, required=True)
    parser.add_argument("--test-list", type=str, required=True,
                        help="TSV: name\\tprompt_text\\tprompt_wav\\ttext")
    parser.add_argument("--model-dir", type=str, default=None,
                        help="local k2-fsa/TTS_eval_models clone: the WavLM-large "
                             "ECAPA backend")
    parser.add_argument("--model", type=str, default="microsoft/wavlm-base-plus-sv",
                        help="HF fallback encoder when no --model-dir")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.eval.metrics import cosine_similarity
    from zipvoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.model_dir:
        enc = EcapaWavLMEncoder(args.model_dir, device=device)
    else:
        logging.warning("no --model-dir: using the HF fallback encoder; "
                        "SIM numbers will not be paper-comparable")
        enc = SpeakerEncoder(args.model, device=device)
    scores = []
    rows = []
    with open(args.test_list, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            name, _ptext, pwav, _text = line.rstrip("\n").split("\t")[:4]
            gen_path = Path(args.wav_dir) / f"{name}.wav"
            if not gen_path.exists():
                continue
            g, gsr = read_wav(gen_path)
            p, psr = read_wav(pwav)
            s = cosine_similarity(enc.embed(g.mean(axis=0), gsr), enc.embed(p.mean(axis=0), psr))
            scores.append(s)
            rows.append((name, s))

    overall = float(np.mean(scores)) if scores else float("nan")
    logging.info("SIM over %d utts: %.4f", len(scores), overall)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(f"SIM\t{overall:.6f}\n")
            for name, s in rows:
                f.write(f"{name}\t{s:.4f}\n")
    return {"SIM": overall, "rows": rows}


if __name__ == "__main__":
    main()
