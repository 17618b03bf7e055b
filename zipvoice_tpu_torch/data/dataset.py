"""Training data: TSV manifests -> duration-bucketed batches with the fbank
computed on the device.

Manifest format: ``id\\ttext\\twav_path`` or ``id\\ttext\\twav_path\\tstart\\tend``
(start/end in seconds within the wav); a trailing tokens column may follow.
Audio is read and resampled on the host (a batch of whole mono files on
the native loader's threads, ``ops/native.py``; anything else in numpy),
padded to a frame bucket, and its log-mel runs on the device: the Vocos
features through the B8 kernel (``ops/melspec.fused_log_mel``) at any
frame count, the BigVGAN features through ``audio/mel.bigvgan_log_mel``
(plain PyTorch, as the reference package computes them outside any
kernel).  The stereo recipe's collator (``three_channel``) gives [ch0 mel,
ch1 mel, mel of the mix].  ``PrecomputedFeatureCollator`` reads offline
fbank shards instead (npz shards and an index TSV, as
``bin/compute_fbank.py`` writes them) and returns host arrays.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from zipvoice_tpu_torch.utils.shapes import round_up


@dataclasses.dataclass
class Utterance:
    uid: str
    text: str
    wav_path: str
    start: float = 0.0
    duration: Optional[float] = None  # seconds; probed lazily if None
    tokens: Optional[List[int]] = None
    token_strs: Optional[List[str]] = None  # offline tokenization (strings)
    sample_rate: Optional[int] = None  # cached by probe_duration
    num_samples: Optional[int] = None


def read_tsv_manifest(path) -> List[Utterance]:
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            items = line.rstrip("\r\n").split("\t")
            if len(items) == 3:
                uid, text, wav = items
                utts.append(Utterance(uid, text, wav))
            elif len(items) == 5:
                # 5-col = id, text, wav, start, END
                uid, text, wav, start, end = items
                utts.append(Utterance(uid, text, wav, float(start),
                                      float(end) - float(start)))
            elif len(items) == 4:
                # trailing column = offline tokens
                uid, text, wav, toks = items
                utts.append(Utterance(uid, text, wav,
                                      token_strs=toks.split(" ")))
            elif len(items) == 6:
                uid, text, wav, start, end, toks = items
                utts.append(Utterance(uid, text, wav, float(start),
                                      float(end) - float(start),
                                      token_strs=toks.split(" ")))
            elif items and items[0]:
                raise ValueError(
                    f"manifest line needs 3-6 columns: {items}"
                )
    return utts


def probe_duration(utt: Utterance) -> float:
    if utt.duration is None:
        from zipvoice_tpu_torch.audio.wav import probe_wav

        utt.sample_rate, utt.num_samples, _ = probe_wav(utt.wav_path)
        utt.duration = utt.num_samples / utt.sample_rate
    return utt.duration


class DurationBucketSampler:
    """Duration-bucketed batching: sorts a shuffled window by duration,
    emits batches capped at `max_duration` seconds, reshuffles per epoch,
    shards the epoch's batches over ``process_count`` ranks (an equal count
    each) and exposes resume state (epoch, batch cursor)."""

    def __init__(
        self,
        utterances: Sequence[Utterance],
        max_duration: float = 200.0,
        max_len: float = 30.0,
        min_len: float = 1.0,
        seed: int = 42,
        shuffle: bool = True,
        num_buckets: int = 30,
        process_index: int = 0,
        process_count: int = 1,
    ):
        utterances = list(utterances)
        unprobed = [u for u in utterances if u.duration is None]
        if len(unprobed) > 32:
            # header-only probes are tiny reads; a serial loop over a large
            # duration-less manifest costs minutes of startup per process
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=16) as pool:
                list(pool.map(probe_duration, unprobed))
        self.utts = [
            u for u in utterances if min_len <= probe_duration(u) <= max_len
        ]
        self.max_duration = max_duration
        self.seed = seed
        self.shuffle = shuffle
        self.num_buckets = num_buckets
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.batch_cursor = 0  # batches already consumed this epoch
        self._batches_cache = None  # (epoch, batches) memo

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.batch_cursor = 0

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch_cursor": self.batch_cursor}

    def load_state_dict(self, state: Dict):
        self.epoch = state["epoch"]
        self.batch_cursor = state["batch_cursor"]

    def _epoch_batches(self) -> List[List[Utterance]]:
        # memoized per epoch: __len__, pessimistic_batches and __iter__ all
        # need the same plan; recomputing the shuffle+sort per call is O(n
        # log n) wasted work on large manifests
        if self._batches_cache is not None and self._batches_cache[0] == self.epoch:
            return self._batches_cache[1]
        order = np.arange(len(self.utts))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # bucket by duration within shuffled windows: sort each window of
        # num_buckets*capacity items so batches are duration-homogeneous but
        # epoch order stays random
        window = max(1, len(order) // self.num_buckets)
        batches: List[List[Utterance]] = []
        for w0 in range(0, len(order), window):
            idx = sorted(
                order[w0 : w0 + window], key=lambda i: self.utts[i].duration
            )
            cur: List[Utterance] = []
            cur_dur = 0.0
            for i in idx:
                u = self.utts[i]
                if cur and cur_dur + u.duration > self.max_duration:
                    batches.append(cur)
                    cur, cur_dur = [], 0.0
                cur.append(u)
                cur_dur += u.duration
            if cur:
                batches.append(cur)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7919 + self.epoch)
            rng.shuffle(batches)
        # this rank's shard, truncated to an equal count on every rank: a
        # rank with one batch more would wait in a collective the others
        # never join
        usable = len(batches) - len(batches) % self.process_count
        shard = batches[self.process_index:usable:self.process_count]
        self._batches_cache = (self.epoch, shard)
        return shard

    def pessimistic_batches(self, n: int = 1) -> List[List[Utterance]]:
        """The n largest batches (by total audio seconds) of the current
        epoch.  Does not advance the cursor."""
        return sorted(
            self._epoch_batches(),
            key=lambda b: sum(u.duration for u in b), reverse=True,
        )[:n]

    def __iter__(self) -> Iterator[List[Utterance]]:
        batches = self._epoch_batches()
        for i in range(self.batch_cursor, len(batches)):
            self.batch_cursor = i + 1
            yield batches[i]

    def __len__(self) -> int:
        return len(self._epoch_batches())


def _ensure_tokens(tokenizer, utts: List[Utterance]) -> None:
    """Fill u.tokens: offline token strings are a dict lookup; anything left
    runs the tokenizer."""
    for u in utts:
        if u.tokens is None and u.token_strs is not None:
            u.tokens = tokenizer.tokens_to_token_ids([u.token_strs])[0]
    if any(u.tokens is None for u in utts):
        token_lists = tokenizer.texts_to_token_ids([u.text for u in utts])
        for u, toks in zip(utts, token_lists):
            u.tokens = toks


def _pad_token_batch(utts: List[Utterance], pad_id: int, token_bucket: int, b_pad: int,
                     num_frames: List[int]):
    """(tokens (b_pad, S) padded to the token bucket, tokens_lens,
    features_lens), int64 host arrays; padded rows have length 0."""
    from zipvoice_tpu_torch.models.zipvoice import pad_labels

    tokens = pad_labels([u.tokens for u in utts], pad_id)
    tokens_padded = np.full((b_pad, round_up(tokens.shape[1], token_bucket)), pad_id,
                            np.int64)
    tokens_padded[: len(utts), : tokens.shape[1]] = tokens
    tokens_lens = np.zeros((b_pad,), np.int64)
    tokens_lens[: len(utts)] = [len(u.tokens) for u in utts]
    features_lens = np.zeros((b_pad,), np.int64)
    features_lens[: len(utts)] = num_frames
    return tokens_padded, tokens_lens, features_lens


class OnDeviceFbankCollator:
    """Collate utterances into a batch: tokens padded on the host, audio
    padded to a frame bucket and its fbank computed on ``device`` through
    the B8 kernel, features scaled to model space ((x + bias) * scale).

    Returns tokens (B, S) int64, tokens_lens (B,), features_lens (B,) as
    host numpy arrays and features (B, T, n_mels) f32 on the device; B and T
    are padded to batch_bucket and frame_bucket (padded rows have length
    0).  ``three_channel`` (the stereo recipe) needs stereo wavs and gives
    (B, T, 3 n_mels) features: channel 0's, channel 1's and the mix's, the
    3B rows in one fbank call."""

    def __init__(self, tokenizer, feat_cfg, device="cuda", pad_id: int = 0,
                 frame_bucket: int = 64, token_bucket: int = 16, batch_bucket: int = 8,
                 three_channel: bool = False):
        if feat_cfg.type not in ("vocos", "bigvgan"):
            raise ValueError(f"unknown feature type {feat_cfg.type!r}")
        self.tokenizer = tokenizer
        self.feat_cfg = feat_cfg
        self.device = torch.device(device)
        self.pad_id = pad_id
        self.frame_bucket = frame_bucket
        self.token_bucket = token_bucket
        self.batch_bucket = batch_bucket
        self.three_channel = three_channel

    def load_audio(self, utt: Utterance) -> np.ndarray:
        from zipvoice_tpu_torch.audio.wav import read_wav, resample

        wav, sr = read_wav(utt.wav_path)
        if self.three_channel:
            if wav.shape[0] != 2:
                raise ValueError(f"{utt.wav_path}: stereo wav required")
        elif wav.shape[0] > 1:
            wav = wav.mean(axis=0, keepdims=True)
        if utt.start or (utt.duration is not None and utt.num_samples is None):
            # a manifest segment row: crop with rounding
            a = int(round(utt.start * sr))
            wav = wav[:, a:a + int(round(utt.duration * sr))]
        if sr != self.feat_cfg.sampling_rate:
            wav = resample(wav, sr, self.feat_cfg.sampling_rate)
        return wav if self.three_channel else wav[0]

    def _load_batch_audio(self, utts: List[Utterance]) -> List[np.ndarray]:
        """The batch's audio: decoded and resampled on the native loader's
        threads (``ops/native.py``) when every row is a whole mono file and
        the library is available, else ``load_audio`` file by file."""
        sr_t = self.feat_cfg.sampling_rate

        def full_file(u: Utterance) -> bool:
            # the native loader reads whole files: a manifest segment row
            # (a duration without a probed num_samples) takes load_audio's crop
            return u.start == 0.0 and (u.duration is None or u.num_samples is not None)

        if not self.three_channel and all(full_file(u) for u in utts):
            try:
                from zipvoice_tpu_torch.ops import native

                if native.available():
                    for u in utts:
                        if u.sample_rate is None:
                            probe_duration(u)
                    exp = [-(-u.num_samples * sr_t // u.sample_rate) for u in utts]
                    audio, lens = native.batch_load_wav([u.wav_path for u in utts], sr_t,
                                                        int(max(exp)))
                    return [audio[i, : lens[i]] for i in range(len(utts))]
            except Exception as ex:  # noqa: BLE001 - the numpy path, with a warning
                logging.warning("native IO batch load failed (%s: %s); numpy fallback",
                                type(ex).__name__, ex)
        return [self.load_audio(u) for u in utts]

    def fbank(self, audio: torch.Tensor) -> torch.Tensor:
        """(R, L) f32 on the device, L a multiple of hop -> (R, >= L/hop,
        n_mels) model-space features: the center-padded Vocos log-mel (L/hop
        + 1 frames) through B8, or the BigVGAN log-mel (L/hop frames)."""
        from zipvoice_tpu_torch.audio.mel import bigvgan_log_mel
        from zipvoice_tpu_torch.ops.melspec import fused_log_mel

        fc = self.feat_cfg
        if fc.type == "bigvgan":
            mel = bigvgan_log_mel(audio, fc)
        else:
            pad = fc.n_fft // 2
            padded = torch.nn.functional.pad(audio[:, None, :], (pad, pad),
                                             mode="reflect")[:, 0]
            mel = fused_log_mel(padded, fc.sampling_rate, fc.n_fft, fc.hop_length, fc.n_mels)
        return (mel + fc.feat_bias) * fc.feat_scale

    def __call__(self, utts: List[Utterance]) -> Dict:
        from zipvoice_tpu_torch.audio.mel import compute_num_frames

        hop = self.feat_cfg.hop_length
        _ensure_tokens(self.tokenizer, utts)
        wavs = self._load_batch_audio(utts)
        num_frames = [compute_num_frames(w.shape[-1], hop) for w in wavs]
        t_pad = round_up(max(num_frames), self.frame_bucket)
        b_pad = round_up(len(utts), self.batch_bucket)
        audio = np.zeros((b_pad,) + wavs[0].shape[:-1] + (t_pad * hop,), np.float32)
        for i, w in enumerate(wavs):
            audio[i, ..., : w.shape[-1]] = w[..., : t_pad * hop]
        audio = torch.from_numpy(audio).to(self.device)
        if self.three_channel:
            rows = torch.cat([audio[:, 0], audio[:, 1], audio.mean(dim=1)])
            feats = self.fbank(rows)[:, :t_pad].reshape(3, b_pad, t_pad, -1)
            feats = torch.cat(tuple(feats), dim=-1)
        else:
            feats = self.fbank(audio)[:, :t_pad]

        tokens_padded, tokens_lens, features_lens = _pad_token_batch(
            utts, self.pad_id, self.token_bucket, b_pad, num_frames)
        return {"tokens": tokens_padded, "tokens_lens": tokens_lens,
                "features": feats, "features_lens": features_lens}


class PrecomputedFeatureCollator:
    """Collate from offline fbank shards: an index TSV (``uid\t..\t..\t
    shard name``) and npz shards under ``feats_dir`` holding each uid's
    (frames, n_mels) features.  Features are scaled to model space ((x +
    bias) * scale) and padded to the frame and batch buckets; everything
    is returned as host numpy arrays (the step moves them to the device).
    The five shards used last stay open."""

    def __init__(self, tokenizer, index_tsv: str, feats_dir: str,
                 feat_scale: float = 0.1, feat_bias: float = 0.0,
                 pad_id: int = 0, frame_bucket: int = 64,
                 token_bucket: int = 16, batch_bucket: int = 8):
        self.tokenizer = tokenizer
        self.feat_scale = feat_scale
        self.feat_bias = feat_bias
        self.pad_id = pad_id
        self.frame_bucket = frame_bucket
        self.token_bucket = token_bucket
        self.batch_bucket = batch_bucket
        self.feats_dir = Path(feats_dir)
        self.index: Dict[str, str] = {}
        with open(index_tsv, encoding="utf-8") as f:
            for line in f:
                items = line.rstrip("\r\n").split("\t")
                if len(items) >= 4:
                    self.index[items[0]] = items[3]
        self._shard_cache: "OrderedDict[str, object]" = OrderedDict()

    def _features(self, uid: str) -> np.ndarray:
        shard_name = self.index[uid]
        cache = self._shard_cache
        if shard_name in cache:
            cache.move_to_end(shard_name)
        else:
            if len(cache) > 4:
                cache.popitem(last=False)[1].close()
            cache[shard_name] = np.load(self.feats_dir / shard_name)
        return cache[shard_name][uid].astype(np.float32)

    def __call__(self, utts: List[Utterance]) -> Dict[str, np.ndarray]:
        _ensure_tokens(self.tokenizer, utts)
        feats = [self._features(u.uid) for u in utts]
        num_frames = [f.shape[0] for f in feats]
        t_pad = round_up(max(num_frames), self.frame_bucket)
        b_pad = round_up(len(utts), self.batch_bucket)
        out = np.zeros((b_pad, t_pad, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            out[i, : f.shape[0]] = (f + self.feat_bias) * self.feat_scale
        tokens_padded, tokens_lens, features_lens = _pad_token_batch(
            utts, self.pad_id, self.token_bucket, b_pad, num_frames)
        return {"tokens": tokens_padded, "tokens_lens": tokens_lens,
                "features": out, "features_lens": features_lens}
