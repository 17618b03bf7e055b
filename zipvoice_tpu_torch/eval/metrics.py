"""Metric primitives of the evaluation suite, offline and testable.

The port's copy of the reference package's ``eval/metrics.py``.  The
scorers that need pretrained models (speaker similarity, ASR for WER,
UTMOS) are not ported; this holds their pure arithmetic: edit-distance
WER, cpWER over the speaker permutation, cosine similarity and mel MSE.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (substitution/insertion/deletion cost 1)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def edit_ops(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """(substitutions, deletions, insertions) of the minimal alignment —
    the jiwer compute_measures counts the reference WER scripts report
    (ref eval/wer/seedtts.py:154-188)."""
    n, m = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, inss)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0],) + prev[j - 1][1:]]
            else:
                c = prev[j - 1]
                cand = [(c[0] + 1, c[1] + 1, c[2], c[3])]
            d = prev[j]
            cand.append((d[0] + 1, d[1], d[2] + 1, d[3]))
            s = cur[j - 1]
            cand.append((s[0] + 1, s[1], s[2], s[3] + 1))
            cur[j] = min(cand)
        prev = cur
    return prev[m][1], prev[m][2], prev[m][3]


def normalize_transcript(text: str) -> List[str]:
    """The LibriSpeech/hubert protocol's normalization exactly
    (ref eval/wer/hubert.py:98-100): curly apostrophes -> straight FIRST
    (so contractions survive the character filter), lowercase, every
    non-[a-zA-Z0-9'] char -> space, collapse whitespace."""
    text = text.replace("\u2018", "'").replace("\u2019", "'")
    text = re.sub(r"[^a-zA-Z0-9']", " ", text.lower())
    return re.sub(r"\s+", " ", text).strip().split()


def wer(ref_text: str, hyp_text: str) -> Tuple[float, int, int]:
    """(wer, errors, ref_len) on normalized word sequences (cf. jiwer usage,
    ref eval/wer/hubert.py)."""
    ref = normalize_transcript(ref_text)
    hyp = normalize_transcript(hyp_text)
    errs = edit_distance(ref, hyp)
    return errs / max(len(ref), 1), errs, len(ref)


def corpus_wer(pairs: Sequence[Tuple[str, str]]) -> float:
    errs = 0
    total = 0
    for ref_text, hyp_text in pairs:
        _, e, n = wer(ref_text, hyp_text)
        errs += e
        total += n
    return errs / max(total, 1)


def split_dialog_turns(text: str) -> Dict[str, str]:
    """Split a speaker-tagged transcript into two per-speaker
    concatenations the way the reference does (ref eval/wer/dialog.py:
    267-272 split_dialogue): split on ANY [S1-9] tag and ALTERNATE the
    segments between the two speakers — untagged leading text lands on
    speaker one rather than being dropped, and unexpected tags ([S3]...)
    still alternate.  cpWER minimizes over the speaker permutation, so
    the arbitrary starting assignment is harmless."""
    segments = [s.strip() for s in re.split(r"\[S[1-9]\]", text)]
    return {
        "[S1]": " ".join(s for s in segments[::2] if s),
        "[S2]": " ".join(s for s in segments[1::2] if s),
    }


_DIALOG_BRACKETS = re.compile(r"\[.*?\]|<.*?>|\(.*?\)")


def post_process_dialog(text: str, lang: str = "en") -> str:
    """The dialog protocol's text cleanup (ref eval/wer/dialog.py:154-178):
    bracketed/parenthesized annotations removed WITH their contents, all
    punctuation except the apostrophe deleted, whitespace collapsed; ZH
    splits to characters, EN lowercases."""
    import string as _string
    import unicodedata

    text = _DIALOG_BRACKETS.sub("", text)
    for x in _string.punctuation:
        if x != "'":
            text = text.replace(x, "")
    # CJK/fullwidth punctuation (the reference's zhon.hanzi.punctuation)
    text = "".join(
        c for c in text
        if not (unicodedata.category(c).startswith("P") and c != "'")
    )
    text = re.sub(r"\s+", " ", text).strip()
    if lang == "zh":
        text = " ".join(text)
    else:
        text = text.lower()
    return text


def cp_wer(ref_text: str, hyp_text: str, lang: str = "en") -> float:
    """Concatenated-minimum-permutation WER (ref eval/wer/dialog.py:
    215-265 process_one_cpwer): per-speaker split -> dialog post_process ->
    WER over the CONCATENATED two-speaker strings, minimized over the two
    speaker assignments."""
    ref = split_dialog_turns(ref_text)
    hyp = split_dialog_turns(hyp_text)
    r1 = post_process_dialog(ref["[S1]"], lang)
    r2 = post_process_dialog(ref["[S2]"], lang)
    h1 = post_process_dialog(hyp["[S1]"], lang)
    h2 = post_process_dialog(hyp["[S2]"], lang)
    ref_words = f"{r1} {r2}".split()
    best = float("inf")
    for hyp_cat in (f"{h1} {h2}", f"{h2} {h1}"):
        errs = edit_distance(ref_words, hyp_cat.split())
        best = min(best, errs / max(len(ref_words), 1))
    return best


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def mel_mse(a: np.ndarray, b: np.ndarray) -> float:
    """North-star fidelity metric: MSE between mel feature matrices
    (BASELINE.md: < 1e-3 vs the reference on the same noise)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = min(a.shape[0], b.shape[0])
    return float(np.mean((a[:n] - b[:n]) ** 2))
