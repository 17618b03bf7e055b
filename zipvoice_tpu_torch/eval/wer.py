"""WER evaluation with the published ASR scorer stacks.

Protocols:

* ``--model hubert``: the LibriSpeech protocol, hubert-large-ls960-ft;
* ``--model whisper``: the Seed-TTS English protocol, Whisper-large-v3
  with the english/transcribe decoder prompt;
* ``--model paraformer``: the Seed-TTS Chinese protocol, funasr Paraformer
  and a traditional-to-simplified conversion;
* ``--model whisperd``: the dialog protocol, WhisperD (a Whisper finetune
  that emits [S1]/[S2]) and cpWER over the speaker split.

``--model-dir`` is a local clone of k2-fsa/TTS_eval_models
(wer/whisper-large-v3/, wer/whisper-d-v1a/, wer/paraformer-zh/); without
it whisper and hubert load their HF hub ids (network needed), and
paraformer and whisperd refuse to run.  The transformers models run on
``--device``; funasr keeps its own device.

Text normalization follows the Seed-TTS scripts: CJK and ASCII punctuation
stripped (the apostrophe kept), Chinese split into characters, English
lowercased (``text/zh.seedtts_normalize``).  Both aggregates are
reported: the Seed-TTS mean of per-utterance WERs and the corpus-weighted
WER.  ``score_pairs`` runs offline.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np

ASR_HUB_IDS = {
    "hubert": "facebook/hubert-large-ls960-ft",
    "whisper": "openai/whisper-large-v3",
}
MODEL_DIR_SUBPATHS = {
    "whisper": "wer/whisper-large-v3",
    "whisperd": "wer/whisper-d-v1a",
    "paraformer": "wer/paraformer-zh",
}


def load_asr(model_key: str, model_dir: str = None, device="cpu"):
    """Returns transcribe(wav_f32_16k: np.ndarray, wav_path: str) -> str.
    The transformers models run on ``device``."""
    local = None
    if model_dir and model_key in MODEL_DIR_SUBPATHS:
        local = os.path.join(model_dir, MODEL_DIR_SUBPATHS[model_key])
        if not os.path.isdir(local):
            raise FileNotFoundError(
                f"{local} not found — download k2-fsa/TTS_eval_models and "
                "pass its root as --model-dir"
            )

    if model_key == "paraformer":
        if local is None:
            raise ValueError("--model paraformer requires --model-dir")
        from funasr import AutoModel  # optional dependency

        model = AutoModel(model=local, disable_update=True)

        def transcribe(wav, wav_path):
            res = model.generate(input=wav_path, batch_size_s=300,
                                 disable_pbar=True)
            return res[0]["text"]

        return transcribe

    if model_key == "whisperd":
        # WhisperD emits its own [S1]/[S2]-tagged format: the forced
        # english/transcribe prompt is cleared and long dialogs decode
        # through the chunked pipeline.  A vanilla Whisper would never emit
        # speaker tags and its cpWER would mean nothing, so the directory
        # is required
        if not local:
            raise ValueError(
                "--model whisperd requires --model-dir pointing at the "
                "WhisperD checkpoint (wer/whisper-d-v1a layout)"
            )
        from transformers import (
            WhisperForConditionalGeneration,
            WhisperProcessor,
            WhisperTokenizer,
            pipeline,
        )

        src = local
        processor = WhisperProcessor.from_pretrained(src)
        tokenizer = WhisperTokenizer.from_pretrained(src)
        model = WhisperForConditionalGeneration.from_pretrained(src)
        model.eval()
        model.generation_config.suppress_tokens = None
        model.generation_config.forced_decoder_ids = None
        pipe = pipeline(
            "automatic-speech-recognition", model=model, tokenizer=tokenizer,
            feature_extractor=processor.feature_extractor, chunk_length_s=30,
            device=device,
        )

        def transcribe(wav, wav_path):
            return pipe({"array": np.asarray(wav),
                         "sampling_rate": 16000})["text"]

        return transcribe

    if model_key == "whisper":
        import torch
        from transformers import (
            WhisperForConditionalGeneration,
            WhisperProcessor,
        )

        src = local
        processor = WhisperProcessor.from_pretrained(src)
        model = WhisperForConditionalGeneration.from_pretrained(src).to(device)
        model.eval()
        forced = processor.get_decoder_prompt_ids(
            language="english", task="transcribe"
        )

        def transcribe(wav, wav_path):
            feats = processor(
                wav, sampling_rate=16000, return_tensors="pt"
            ).input_features.to(device)
            with torch.no_grad():
                ids = model.generate(feats, forced_decoder_ids=forced)
            return processor.batch_decode(ids, skip_special_tokens=True)[0]

        return transcribe

    from transformers import pipeline

    asr = pipeline("automatic-speech-recognition",
                   model=local or ASR_HUB_IDS[model_key], chunk_length_s=30,
                   device=device)

    def transcribe(wav, wav_path):
        return asr({"array": np.asarray(wav), "sampling_rate": 16000})["text"]

    return transcribe


def score_pairs(pairs, lang: str, dialog: bool = False,
                protocol: str = "seedtts"):
    """pairs: [(name, ref_text, hyp_text)].  Returns a dict of aggregates and
    per-utt rows.  protocol selects the normalization: "seedtts"
    (punctuation deleted, ZH char-split) or "hubert" (the LibriSpeech
    protocol: non-alnum -> space)."""
    from zipvoice_tpu_torch.eval.metrics import cp_wer, edit_ops, normalize_transcript
    from zipvoice_tpu_torch.text.zh import seedtts_normalize

    rows = []
    wers, subs_t, dels_t, inss_t, words_t = [], 0, 0, 0, 0
    for name, ref_text, hyp_text in pairs:
        if dialog:
            w = cp_wer(ref_text, hyp_text, lang)
            rows.append((name, w, ref_text, hyp_text))
            wers.append(w)
            words_t += max(len(ref_text.split()), 1)
            continue
        if protocol == "hubert":
            ref_w = normalize_transcript(ref_text)
            hyp_w = normalize_transcript(hyp_text)
            ref_n, hyp_n = " ".join(ref_w), " ".join(hyp_w)
        else:
            ref_n = seedtts_normalize(ref_text, lang)
            hyp_n = seedtts_normalize(hyp_text, lang)
            # empty tokens from double spaces are not words (jiwer drops them)
            ref_w = [w for w in ref_n.split(" ") if w]
            hyp_w = [w for w in hyp_n.split(" ") if w]
        s, d, i = edit_ops(ref_w, hyp_w)
        n = len(ref_w)
        w = (s + d + i) / max(n, 1)
        rows.append((name, w, ref_n, hyp_n))
        wers.append(w)
        subs_t += s
        dels_t += d
        inss_t += i
        words_t += n
    out = {
        # Seed-TTS official protocol: mean of per-utterance WERs
        "wer_avg": float(np.mean(wers)) if wers else float("nan"),
        # corpus-weighted WER
        "wer": ((subs_t + dels_t + inss_t) / max(words_t, 1))
        if not dialog else float(np.mean(wers)) if wers else float("nan"),
        "substitutions": subs_t,
        "deletions": dels_t,
        "insertions": inss_t,
        "words": words_t,
        "rows": rows,
    }
    return out


def main(argv=None) -> dict:
    """Transcribe and score; returns score_pairs's dict."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True,
                   help="TSV: name\\t...\\ttext (text = last column)")
    p.add_argument("--model", type=str, default="hubert",
                   choices=["hubert", "whisper", "paraformer", "whisperd"])
    p.add_argument("--lang", type=str, default=None, choices=["en", "zh"],
                   help="default: zh for paraformer, en otherwise")
    p.add_argument("--model-dir", type=str, default=None,
                   help="local k2-fsa/TTS_eval_models clone")
    p.add_argument("--extension", type=str, default="wav")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.audio.wav import read_wav, resample
    from zipvoice_tpu_torch.text.zh import traditional_to_simplified
    from zipvoice_tpu_torch.utils.device import resolve_device

    lang = args.lang or ("zh" if args.model == "paraformer" else "en")
    transcribe = load_asr(args.model, args.model_dir, resolve_device(args.device))
    dialog = args.model == "whisperd"

    pairs = []
    with open(args.test_list, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            items = line.rstrip("\n").split("\t")
            name, text = items[0], items[-1]
            wav_path = Path(args.wav_dir) / f"{name}.{args.extension}"
            if not wav_path.exists():
                logging.warning("missing %s", wav_path)
                continue
            wav, sr = read_wav(wav_path)
            wav = resample(wav.mean(axis=0, keepdims=True), sr, 16000)[0]
            hyp = transcribe(wav, str(wav_path))
            if lang == "zh":
                hyp = traditional_to_simplified(hyp)
            pairs.append((name, text, hyp))

    res = score_pairs(pairs, lang, dialog=dialog,
                      protocol="hubert" if args.model == "hubert" else "seedtts")
    metric = "cpWER" if dialog else "WER"
    logging.info("Seed-TTS %s (avg of per-utt): %.2f%%",
                 metric, res["wer_avg"] * 100)
    logging.info("%s (corpus-weighted): %.2f%% (S=%d D=%d I=%d / %d words)",
                 metric, res["wer"] * 100, res["substitutions"],
                 res["deletions"], res["insertions"], res["words"])
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(f"{metric}\t{res['wer']:.6f}\t{res['wer_avg']:.6f}\n")
            for name, w, ref, hyp in res["rows"]:
                f.write(f"{name}\t{w:.4f}\t{ref}\t{hyp}\n")
    return res


if __name__ == "__main__":
    main()
