"""cpSIM: concatenated max-permutation speaker similarity for dialog TTS.

For each conversation: split the generated two-speaker wav into one track
a speaker, embed each track with the SIM-o speaker encoder
(``eval/sim.py``) and score the best speaker assignment's mean cosine
similarity against the prompt speakers.

How the speakers are separated, per input:

* ``--prompt-mode split``: the prompt is two single-speaker wavs (columns
  4 and 5 of the test list), so it needs no diarization;
* a stereo wav: each channel is a speaker (ZipVoice-Dialog-Stereo's
  output);
* a mono two-speaker wav: pyannote diarization when it is installed
  (``speaker_similarity/pyannote/pyannote_diarization_config.yaml`` under
  ``--model-dir``); otherwise the whole audio stands for both speakers,
  with a warning.

The encoders run on ``--device``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np


def _diarize_pyannote(pipeline, wav: np.ndarray, sr: int) -> Optional[List[np.ndarray]]:
    """2-speaker diarization -> per-speaker concatenated tracks, or None."""
    import torch

    annotation = pipeline(
        {"waveform": torch.from_numpy(wav[None, :]), "sample_rate": sr},
        num_speakers=2,
    )
    chunks = {"SPEAKER_00": [], "SPEAKER_01": []}
    for turn, _, speaker in annotation.itertracks(yield_label=True):
        if speaker in chunks:
            chunks[speaker].append(wav[int(turn.start * sr): int(turn.end * sr)])
    if not (chunks["SPEAKER_00"] and chunks["SPEAKER_01"]):
        return None
    return [np.concatenate(chunks["SPEAKER_00"]), np.concatenate(chunks["SPEAKER_01"])]


def load_diarizer(model_dir: Optional[str]):
    """The pyannote pipeline of a k2-fsa/TTS_eval_models layout, or None."""
    if model_dir is None:
        return None
    cfg = Path(model_dir) / "speaker_similarity/pyannote" / "pyannote_diarization_config.yaml"
    if not cfg.exists():
        return None
    try:
        from pyannote.audio import Pipeline  # optional dependency

        return Pipeline.from_pretrained(str(cfg))
    except ImportError:
        logging.warning("pyannote not installed; mono dialog wavs fall back "
                        "to full-audio-for-both-speakers")
        return None


def speaker_tracks(wav: np.ndarray, sr: int, diarizer) -> List[np.ndarray]:
    """(C, T) waveform -> two per-speaker 1-D tracks."""
    if wav.ndim == 2 and wav.shape[0] == 2:
        return [wav[0], wav[1]]  # stereo: a channel a speaker
    mono = wav.mean(axis=0) if wav.ndim == 2 else wav
    if diarizer is not None:
        tracks = _diarize_pyannote(diarizer, mono.astype(np.float32), sr)
        if tracks is not None:
            return tracks
        logging.debug("diarization found <2 speakers; using full audio")
    return [mono, mono]


def cp_sim_tracks(encoder, gen_tracks, gen_sr, prompt_tracks, prompt_sr) -> float:
    """Best-permutation mean cosine over per-speaker (gen, prompt) pairs.
    prompt_sr: one rate for all tracks, or a list with one a track."""
    from itertools import permutations

    from zipvoice_tpu_torch.eval.metrics import cosine_similarity

    if not isinstance(prompt_sr, (list, tuple)):
        prompt_sr = [prompt_sr] * len(prompt_tracks)
    g = [encoder.embed(w, gen_sr) for w in gen_tracks]
    p = [encoder.embed(w, sr) for w, sr in zip(prompt_tracks, prompt_sr)]
    return max(
        float(np.mean([cosine_similarity(g[i], p[j]) for i, j in enumerate(perm)]))
        for perm in permutations(range(len(p)))
    )


def main(argv=None) -> dict:
    """Score; returns {"cpSIM": mean, "rows": [(name, score), ...]}."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True,
                   help="TSV: name\\tptext1\\tptext2\\tpwav1\\tpwav2\\ttext "
                        "(split mode) or name\\tptext\\tpwav\\ttext (merge)")
    p.add_argument("--prompt-mode", type=str, default="split", choices=["split", "merge"])
    p.add_argument("--model-dir", type=str, default=None,
                   help="local k2-fsa/TTS_eval_models clone")
    p.add_argument("--extension", type=str, default="wav")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.eval import sim
    from zipvoice_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.model_dir:
        enc = sim.EcapaWavLMEncoder(args.model_dir, device=device)
    else:
        logging.warning("no --model-dir: HF fallback encoder; cpSIM numbers "
                        "will not be paper-comparable")
        enc = sim.SpeakerEncoder(device=device)
    diarizer = load_diarizer(args.model_dir)

    scores, rows = [], []
    with open(args.test_list, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            items = line.rstrip("\n").split("\t")
            name = items[0]
            gen_path = Path(args.wav_dir) / f"{name}.{args.extension}"
            if not gen_path.exists():
                logging.warning("missing %s", gen_path)
                continue
            g_wav, g_sr = read_wav(gen_path)
            gen_tracks = speaker_tracks(g_wav, g_sr, diarizer)

            if args.prompt_mode == "split":
                pw1, psr1 = read_wav(items[3])
                pw2, psr2 = read_wav(items[4])
                prompt_tracks = [pw1.mean(axis=0), pw2.mean(axis=0)]
                # the two prompt wavs may differ in rate: each is embedded at its own
                p_sr = [psr1, psr2]
            else:
                p_wav, p_sr = read_wav(items[2])
                prompt_tracks = speaker_tracks(p_wav, p_sr, diarizer)

            # the encoders resample to their own rate
            s = cp_sim_tracks(enc, gen_tracks, g_sr, prompt_tracks, p_sr)
            scores.append(s)
            rows.append((name, s))

    overall = float(np.mean(scores)) if scores else float("nan")
    logging.info("cpSIM over %d conversations: %.4f", len(scores), overall)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(f"cpSIM\t{overall:.6f}\n")
            for name, s in rows:
                f.write(f"{name}\t{s:.4f}\n")
    return {"cpSIM": overall, "rows": rows}


if __name__ == "__main__":
    main()
