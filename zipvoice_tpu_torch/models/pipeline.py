"""Zero-shot TTS inference pipeline: tokenize -> fbank -> ODE -> vocoder.

The PyTorch counterpart of the reference package's ``ZipVoicePipeline``.
The device path is three programs (``utils/graphs.Program``), each a plain
function over padded, bucketed tensors that the card captures as a CUDA
graph per shape bucket, as the reference package jits them:

  1. ``_sample_fn``:     text embed + text encoder + duration expansion +
                         N-step Euler ODE (CFG, or the distill variant's
                         embedded scale) + prompt strip + unscaling
  2. ``_vocode_i16_fn``: the vocoder (Vocos + ISTFT, or BigVGAN) + clip +
                         PCM16
  3. ``_sample_pcm_fn``: both in one graph (one request, one readback)

Token counts, frame counts and prompt lengths ride as (B,) tensors over the
token and frame buckets, so a handful of graphs serves every request size;
the bucketed values equal the unbucketed ones.  The prompt fbank stays
eager (one short call a request).

A pipeline serves one model variant: ``zipvoice`` (with ``distill`` for
ZipVoice-Distill), ``dialog`` or ``dialog_stereo``.  The stereo model
samples in 2F (noise, x and the generated mel; ``sample_feat_dim``) while
``model_cfg.feat_dim`` stays the per-channel F; its prompt fbank keeps two
channels, and the vocoder decodes the two halves at batch 2, giving a
(2, L) wav.

The vocoder follows the model's features: ``vocos`` (the default) or
``bigvgan``; ``vocos_params`` holds the chosen vocoder's weights.

``quantize`` (``int8`` or ``int8-dynamic``) serves a copy of the model
with int8 linear layers (``ops/quant.py``).  The mode lives on the
model's layers, so pipelines of different modes can live side by side.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from zipvoice_tpu_torch.audio.mel import (
    compute_num_frames,
    extract_features,
    stft_pad_amount,
)
from zipvoice_tpu_torch.audio.bigvgan import bigvgan_decode, build_bigvgan
from zipvoice_tpu_torch.audio.vocos import VocosConfig, vocos_decode
from zipvoice_tpu_torch.audio.wav import resample
from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.nn.zipformer import fused_flags
from zipvoice_tpu_torch.ops.quant import MODES as QUANT_MODES
from zipvoice_tpu_torch.ops.quant import cast_quantized, quantize_linear_int8
from zipvoice_tpu_torch.utils.device import resolve_device
from zipvoice_tpu_torch.utils.graphs import GraphSet, Program
from zipvoice_tpu_torch.utils.memo import instance_cache
from zipvoice_tpu_torch.utils.shapes import round_up


VARIANTS = ("zipvoice", "dialog", "dialog_stereo")
VOCODERS = ("vocos", "bigvgan")


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # (L,) float32; (2, L) for the stereo variant
    # (T_gen, F) generated mel (model scale removed); None on the fused
    # one-program path, which reads back only PCM16
    features: Optional[np.ndarray]
    metrics: Dict[str, float]


@dataclasses.dataclass
class _SampleInputs:
    tokens_padded: torch.Tensor  # (B, S) int64
    tokens_lens: torch.Tensor  # (B,) int64
    prompt_features: torch.Tensor  # (B, T, sample_feat_dim)
    prompt_features_lens: torch.Tensor  # (B,) int64
    features_lens: torch.Tensor  # (B,) int64
    noise: torch.Tensor  # (B, T, sample_feat_dim)
    gen_lens: List[int]  # generated frames a row (host arithmetic, sync-free)

    @property
    def args(self) -> Tuple[torch.Tensor, ...]:
        """The inputs of the sampling programs, in their order."""
        return (self.tokens_padded, self.tokens_lens, self.prompt_features,
                self.prompt_features_lens, self.features_lens, self.noise)


class ZipVoicePipeline:
    """Host-side orchestration around the captured programs."""

    # prompt wavs are padded to a grid of this many frames' worth of samples
    # (128 frames = 1.37 s at 24 kHz / hop 256), matching the reference
    # package's prompt buckets
    PROMPT_FRAME_BUCKET = 128

    def __init__(
        self,
        model: zv.ZipVoiceModel,
        model_cfg: ZipVoiceConfig,
        feat_cfg: FeatureConfig,
        vocos_params: Optional[Dict[str, torch.Tensor]] = None,
        vocos_cfg: VocosConfig = VocosConfig(),
        tokenizer=None,
        dtype: torch.dtype = torch.float32,
        token_bucket: int = 32,
        frame_bucket: int = 128,
        device: Union[str, torch.device] = "cuda",
        quantize: Optional[str] = None,
        distill: bool = False,
        variant: str = "zipvoice",
        vocoder: str = "vocos",
    ):
        if quantize is not None:
            if quantize not in QUANT_MODES:
                raise ValueError(f"unknown quantize mode {quantize!r}; one of {QUANT_MODES}")
        if vocoder not in VOCODERS:
            raise ValueError(f"unknown vocoder {vocoder!r}; one of {VOCODERS}")
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
        if distill and variant != "zipvoice":
            raise ValueError("distill sampling is for the zipvoice variant only")
        self.device = resolve_device(device)
        if quantize is None:
            self.model = model.to(device=self.device, dtype=dtype).eval()
        else:
            # an f32 quantization of a copy (the caller's model stays float),
            # then the cast policy that keeps the scales f32
            self.model = cast_quantized(
                quantize_linear_int8(copy.deepcopy(model), quantize), dtype,
                self.device).eval()
        self.quantize = quantize
        self.vocos_params = (
            None if vocos_params is None
            else {k: v.to(device=self.device, dtype=dtype)
                  for k, v in vocos_params.items()}
        )
        self.vocoder = vocoder
        # BigVGAN runs as a module over the same (cast, on-device) tensors
        self._bigvgan = (build_bigvgan(self.vocos_params)
                         if vocoder == "bigvgan" and vocos_params is not None else None)
        self.model_cfg = model_cfg
        self.feat_cfg = feat_cfg
        self.vocos_cfg = vocos_cfg
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.token_bucket = token_bucket
        self.frame_bucket = frame_bucket
        self.distill = distill
        self.variant = variant
        self.num_channels = 2 if variant == "dialog_stereo" else 1
        self.sample_feat_dim = model_cfg.feat_dim * self.num_channels
        # the programs' graphs: one pool, one lock, bounded; program memos
        # live on the instance (utils/memo), so both go with the pipeline
        self.graphs = GraphSet(self.device)

    @property
    def captures(self) -> int:
        """Graphs captured so far (0 on the CPU, which runs eagerly)."""
        return self.graphs.captures

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ programs

    def _strip_prompt(self, x1, prompt_features_lens, features_lens):
        """Roll each row's generated region to the front (left by its prompt
        length), zero the rest and undo the model feature scaling."""
        t = x1.shape[1]
        frames = torch.arange(t, device=x1.device)[None, :]
        src = (frames + prompt_features_lens[:, None]) % t
        x_gen = torch.gather(x1, 1, src[:, :, None].expand(-1, -1, x1.shape[-1]))
        gen_lens = features_lens - prompt_features_lens
        x_gen = x_gen.masked_fill((frames >= gen_lens[:, None])[:, :, None], 0.0)
        return x_gen / self.feat_cfg.feat_scale - self.feat_cfg.feat_bias

    @instance_cache
    def _sample_fn(self, num_step: int, guidance_scale: float, t_shift: float,
                   timesteps: Optional[tuple] = None) -> Program:
        """The sampler over the bucketed inputs (``_SampleInputs.args``):
        (B, T, sample_feat_dim) mel with each row's prompt stripped, frames
        >= its gen_len zeroed, in the pipeline's dtype."""
        model = self.model
        if self.variant == "zipvoice":
            sample = functools.partial(zv.sample, distill=self.distill)
        else:
            from zipvoice_tpu_torch.models.dialog import sample_dialog as sample

        def run(tokens_padded, tokens_lens, prompt_features, prompt_features_lens,
                features_lens, noise):
            x1 = sample(
                model, tokens_padded, tokens_lens, prompt_features,
                prompt_features_lens, features_lens, noise,
                num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift,
                timesteps=timesteps,
            )
            return self._strip_prompt(x1, prompt_features_lens, features_lens)

        return Program(self.graphs, "sample",
                       (self.variant, self.distill, num_step, guidance_scale, t_shift,
                        timesteps), run, fused_flags)

    def _decode_i16(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, F) mel -> (B, L) PCM16: the vocoder, clip, round; L is
        (T - 1) * hop for Vocos, T * hop for BigVGAN.  A (B, T, 2F) stereo
        mel decodes its two halves as 2B rows, -> (B, 2, L)."""
        b, t, width = mel.shape
        f = self.model_cfg.feat_dim
        if width != f:
            mel = mel.reshape(b, t, width // f, f).transpose(1, 2).reshape(-1, t, f)
        if self._bigvgan is not None:
            wav = bigvgan_decode(self._bigvgan, mel.to(self.dtype))
        else:
            wav = vocos_decode(self.vocos_params, mel.to(self.dtype), self.vocos_cfg)
        pcm = torch.round(torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        return pcm if width == f else pcm.reshape(b, width // f, -1)

    @instance_cache
    def _vocode_i16_fn(self) -> Program:
        """The vocoder emitting PCM16 (half the readback of f32)."""
        return Program(self.graphs, "vocode_i16", (self.vocoder,), self._decode_i16)

    @instance_cache
    def _sample_pcm_fn(self, num_step: int, guidance_scale: float,
                       t_shift: float) -> Program:
        """Sampler + vocoder + PCM16 as one graph: one replay and one int16
        readback a request."""
        sample = self._sample_fn(num_step, guidance_scale, t_shift).fn
        decode = self._decode_i16

        def run(*args):
            return decode(sample(*args))

        return Program(self.graphs, "sample_pcm",
                       (self.variant, self.distill, num_step, guidance_scale, t_shift,
                        self.vocoder), run, fused_flags)

    # ------------------------------------------------------------- inputs

    def _buckets(self, n_tokens: int, n_prompt_tokens: int, prompt_frames: int,
                 speed: float) -> Tuple[int, int, int]:
        """(total frames, token bucket s_pad, frame bucket t_pad) of one
        request with the token-ratio duration."""
        total = int(zv.predict_features_lens(
            np.array([prompt_frames]), np.array([max(n_prompt_tokens, 1)]),
            np.array([n_tokens]), speed=speed,
        )[0])
        s_pad = round_up(n_prompt_tokens + n_tokens + 1, self.token_bucket)
        return total, s_pad, round_up(total, self.frame_bucket)

    def _noise(self, seed: int, shape) -> torch.Tensor:
        """Standard normal noise drawn in f32 from a seeded generator on the
        device, in the pipeline's dtype."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32).to(self.dtype)

    def _prepare_batch(self, token_lists, prompt_token_lists, feats, speed: float,
                       seed: int, seeds: Optional[Sequence[int]] = None,
                       noise: Optional[np.ndarray] = None) -> _SampleInputs:
        """Bucket-pad n requests to one (n, s_pad) / (n, t_pad, F) batch.
        Noise: explicit ((n, T, F) numpy, cut or zero-padded to t_pad), or
        row i from its own generator seeded ``seeds[i] & 0xFFFFFFFF``, or
        one (n, t_pad, F) draw seeded ``seed``."""
        n = len(token_lists)
        dev, pad_id = self.device, self.model_cfg.pad_id
        cats = [list(p) + list(t) for p, t in zip(prompt_token_lists, token_lists)]
        prompt_lens = [int(f.shape[0]) for f in feats]
        plans = [self._buckets(len(t), len(p), pl, speed)
                 for t, p, pl in zip(token_lists, prompt_token_lists, prompt_lens)]
        totals = [total for total, _, _ in plans]
        s_pad = max(s for _, s, _ in plans)
        t_pad = max(t for _, _, t in plans)

        tokens_padded = np.full((n, s_pad), pad_id, np.int64)
        for i, c in enumerate(cats):
            tokens_padded[i, : len(c)] = c
        pf = torch.zeros((n, t_pad, feats[0].shape[-1]), dtype=self.dtype, device=dev)
        for i, f in enumerate(feats):
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.array(f, np.float32))
            pf[i, : prompt_lens[i]] = f.to(dev, self.dtype)

        feat_dim = self.sample_feat_dim
        if noise is not None:
            noise = np.asarray(noise, np.float32)[:, :t_pad]
            noise = np.pad(noise, ((0, 0), (0, t_pad - noise.shape[1]), (0, 0)))
            noise_t = torch.from_numpy(noise).to(dev, self.dtype)
        elif seeds is not None:
            if len(seeds) != n:
                raise ValueError(f"{len(seeds)} seeds for {n} requests")
            noise_t = torch.cat([self._noise(s & 0xFFFFFFFF, (1, t_pad, feat_dim))
                                 for s in seeds])
        else:
            noise_t = self._noise(seed, (n, t_pad, feat_dim))

        def ints(values):
            return torch.tensor(values, dtype=torch.int64, device=dev)

        return _SampleInputs(
            tokens_padded=torch.from_numpy(tokens_padded).to(dev),
            tokens_lens=ints([len(c) for c in cats]),
            prompt_features=pf,
            prompt_features_lens=ints(prompt_lens),
            features_lens=ints(totals),
            noise=noise_t,
            gen_lens=[t - p for t, p in zip(totals, prompt_lens)],
        )

    def _prepare_sample_inputs(self, tokens, prompt_tokens, prompt_feats,
                               speed: float, seed: int,
                               noise: Optional[np.ndarray] = None) -> _SampleInputs:
        """One request as a batch of one; noise from a seeded generator on
        the device unless given explicitly ((1, T, F) numpy)."""
        return self._prepare_batch([tokens], [prompt_tokens], [prompt_feats], speed,
                                   seed, noise=noise)

    # ---------------------------------------------------------------- api

    def warmup(self, num_step: int = 16, guidance_scale: float = 1.0,
               t_shift: float = 0.5, seconds=(10.0,), token_counts=(64,),
               fused: bool = True, batch_sizes=()):
        """Capture the serving programs for the given duration and token
        buckets before the first request (cold-start control).  ``fused``
        keeps the reference package's name for the one sample + vocoder +
        PCM16 program that single requests run (``_sample_pcm_fn``); it is
        not the fused eval path of ``nn/zipformer.set_fused_eval``, whose
        flags in force now are part of every warmed key.  ``batch_sizes``
        (e.g. ``(4, 8)``) adds the batched sampler and vocoder that a
        dynamic-batching server drains into."""
        rng = np.random.default_rng(0)
        for secs in seconds:
            frames = int(secs * self.feat_cfg.frame_rate)
            for n_tok in token_counts:
                tokens = list(rng.integers(1, self.model_cfg.vocab_size, n_tok))
                prompt_tokens = list(
                    rng.integers(1, self.model_cfg.vocab_size, max(n_tok // 4, 1)))
                pf = (rng.standard_normal((max(frames // 4, 8), self.sample_feat_dim))
                      * 0.01).astype(np.float32)
                mel, gen_len = self.sample_features(
                    tokens, prompt_tokens, pf, num_step=num_step,
                    guidance_scale=guidance_scale, t_shift=t_shift)
                if self.vocos_params is not None:
                    self.vocode(mel, gen_len)
                    if fused:
                        batch = self._prepare_sample_inputs(tokens, prompt_tokens, pf,
                                                            1.0, 0)
                        run = self._sample_pcm_fn(int(num_step), float(guidance_scale),
                                                  float(t_shift))
                        run(*batch.args).cpu()
                for b in batch_sizes:
                    if b <= 1:
                        continue
                    run = self._sample_fn(int(num_step), float(guidance_scale),
                                          float(t_shift))
                    args = self._prepare_sample_inputs(tokens, prompt_tokens, pf,
                                                       1.0, 0).args
                    mel_b = run(*(a.repeat_interleave(b, dim=0) for a in args))
                    if self.vocos_params is not None:
                        self._vocode_i16_fn()(mel_b).cpu()
        self._sync()

    @torch.no_grad()
    def prompt_features(self, prompt_wav: np.ndarray, sr: int,
                        target_rms: float = 0.1) -> Tuple[torch.Tensor, float]:
        """Resample + RMS-normalize + fbank the prompt.  Returns ((Tp,
        sample_feat_dim) device tensor in model scale, prompt_rms); the
        stereo variant takes a (2, L) prompt.

        The fbank runs on a bucketed length: the true wav gets the
        extractor's reflect padding on the host, then right zeros up to the
        bucket; the true frames are sliced out afterwards, so the values
        equal the unbucketed computation."""
        wav = np.asarray(prompt_wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None, :]
        if sr != self.feat_cfg.sampling_rate:
            wav = resample(wav, sr, self.feat_cfg.sampling_rate)
        prompt_rms = float(np.sqrt(np.mean(np.square(wav))))
        if prompt_rms <= 0.0:
            raise ValueError("prompt audio is silent (rms == 0)")
        if prompt_rms < target_rms:
            wav = wav * (target_rms / prompt_rms)

        fcfg = self.feat_cfg
        length = wav.shape[-1]
        pad = stft_pad_amount(fcfg)
        if length <= pad:
            raise ValueError(f"prompt too short: {length} samples <= reflect pad {pad}")
        length_b = round_up(length, fcfg.hop_length * self.PROMPT_FRAME_BUCKET)
        wav_p = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
        wav_p = np.pad(wav_p, ((0, 0), (0, length_b - length)))
        feats = extract_features(
            torch.from_numpy(wav_p).to(device=self.device, dtype=self.dtype),
            fcfg, num_channels=self.num_channels, pre_padded=True,
        )
        feats = (feats + fcfg.feat_bias) * fcfg.feat_scale
        # the frame contract (round-half-up of length / hop): crop to it;
        # where the unbucketed STFT would come up short (bigvgan's smaller
        # pad can), replicate its last frame, as extract_features does
        n_true = compute_num_frames(length, fcfg.hop_length)
        f_unpadded = 1 + (length + 2 * pad - fcfg.n_fft) // fcfg.hop_length
        if f_unpadded >= n_true:
            return feats[:n_true], prompt_rms
        last = feats[f_unpadded - 1:f_unpadded]
        return torch.cat([feats[:f_unpadded], last.expand(n_true - f_unpadded, -1)]), prompt_rms

    def _request_inputs(self, text, prompt_text, prompt_wav, prompt_sr, target_rms,
                        precomputed: Optional[Dict]):
        """(tokens, prompt tokens, prompt feats, prompt rms) of one request,
        or those ``precomputed`` off the dispatcher thread."""
        if precomputed is not None:
            return (precomputed["tokens"], precomputed["prompt_tokens"],
                    precomputed["prompt_feats"], precomputed["prompt_rms"])
        if self.tokenizer is None:
            raise ValueError("pipeline needs a tokenizer")
        tokens = self.tokenizer.texts_to_token_ids([text])[0]
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]
        pf, prompt_rms = self.prompt_features(prompt_wav, prompt_sr, target_rms)
        return tokens, prompt_tokens, pf, prompt_rms

    @torch.no_grad()
    def sample_features(self, tokens, prompt_tokens, prompt_feats,
                        num_step: int = 16, guidance_scale: float = 1.0,
                        speed: float = 1.0, t_shift: float = 0.5, seed: int = 666,
                        noise: Optional[np.ndarray] = None,
                        timesteps=None) -> Tuple[torch.Tensor, int]:
        """Run the sampler program.  Returns ((T_bucket, sample_feat_dim)
        mel on the device with frames >= gen_len zeroed, gen_len).
        ``timesteps`` (an explicit Euler grid) overrides num_step /
        t_shift."""
        s = self._prepare_sample_inputs(tokens, prompt_tokens, prompt_feats,
                                        speed, seed, noise)
        ts_key = None if timesteps is None else tuple(float(t) for t in timesteps)
        run = self._sample_fn(int(num_step), float(guidance_scale), float(t_shift), ts_key)
        return run(*s.args)[0], s.gen_lens[0]

    @torch.no_grad()
    def vocode(self, mel, gen_len: int) -> np.ndarray:
        """Vocode a (T_bucket, F) mel (device tensor or numpy) whose frames
        >= gen_len are zero; PCM16 on the device, float32 wav of
        (gen_len - 1) * hop samples on the host.  A (T_bucket, 2F) stereo
        mel gives a (2, L) wav (``vocode_stereo``)."""
        if self.vocos_params is None:
            raise ValueError("pipeline needs vocoder weights")
        if not isinstance(mel, torch.Tensor):
            mel = torch.from_numpy(np.asarray(mel, np.float32))
        pcm = self._vocode_i16_fn()(mel.to(self.device, self.dtype)[None])
        out = pcm[0].cpu().numpy().astype(np.float32) / 32767.0
        return out[..., : max(gen_len - 1, 1) * self.vocos_cfg.hop_length]

    def vocode_stereo(self, mel, gen_len: int) -> np.ndarray:
        """The stereo model's (T_bucket, 2F) mel -> (2, L) wav: channel 0
        from the first F mels, channel 1 from the rest, one vocoder program
        at batch 2."""
        width = mel.shape[-1]
        if width != 2 * self.model_cfg.feat_dim:
            raise ValueError(f"vocode_stereo needs a 2F-wide mel, got width {width}")
        return self.vocode(mel, gen_len)

    def synthesize(self, text: str, prompt_text: str, prompt_wav: np.ndarray,
                   prompt_sr: int, num_step: int = 16, guidance_scale: float = 1.0,
                   speed: float = 1.0, t_shift: float = 0.5, target_rms: float = 0.1,
                   seed: int = 666, timesteps=None) -> SynthesisResult:
        t0 = time.monotonic()
        tokens, prompt_tokens, pf, prompt_rms = self._request_inputs(
            text, prompt_text, prompt_wav, prompt_sr, target_rms, None)
        mel, gen_len = self.sample_features(
            tokens, prompt_tokens, pf, num_step=num_step,
            guidance_scale=guidance_scale, speed=speed, t_shift=t_shift,
            seed=seed, timesteps=timesteps,
        )
        self._sync()
        t1 = time.monotonic()

        wav = self.vocode(mel, gen_len)
        if prompt_rms < target_rms:
            wav = wav * (prompt_rms / target_rms)
        t2 = time.monotonic()

        wav_seconds = wav.shape[-1] / self.feat_cfg.sampling_rate
        metrics = {
            "t": t2 - t0,
            "t_no_vocoder": t1 - t0,
            "t_vocoder": t2 - t1,
            "wav_seconds": wav_seconds,
            "rtf": (t2 - t0) / wav_seconds,
            "rtf_no_vocoder": (t1 - t0) / wav_seconds,
            "rtf_vocoder": (t2 - t1) / wav_seconds,
        }
        return SynthesisResult(
            wav=wav, features=mel[:gen_len].float().cpu().numpy(), metrics=metrics,
        )

    @torch.no_grad()
    def synthesize_fused(self, text: str, prompt_text: str, prompt_wav: np.ndarray,
                         prompt_sr: int, num_step: int = 16, guidance_scale: float = 1.0,
                         speed: float = 1.0, t_shift: float = 0.5,
                         target_rms: float = 0.1, seed: int = 666,
                         precomputed: Optional[Dict] = None) -> SynthesisResult:
        """synthesize() through the one sample + vocoder + PCM16 program (no
        model/vocoder split in the metrics).  ``precomputed`` may carry
        {"tokens", "prompt_tokens", "prompt_feats", "prompt_rms"} prepared
        off the dispatcher thread."""
        if self.vocos_params is None:
            raise ValueError("pipeline needs vocoder weights")
        t0 = time.monotonic()
        tokens, prompt_tokens, pf, prompt_rms = self._request_inputs(
            text, prompt_text, prompt_wav, prompt_sr, target_rms, precomputed)
        batch = self._prepare_sample_inputs(tokens, prompt_tokens, pf, speed, seed)
        run = self._sample_pcm_fn(int(num_step), float(guidance_scale), float(t_shift))
        wav = run(*batch.args)[0].cpu().numpy().astype(np.float32) / 32767.0
        wav = wav[..., : max(batch.gen_lens[0] - 1, 1) * self.vocos_cfg.hop_length]
        if prompt_rms < target_rms:
            wav = wav * (prompt_rms / target_rms)
        t1 = time.monotonic()
        wav_seconds = wav.shape[-1] / self.feat_cfg.sampling_rate
        return SynthesisResult(
            wav=wav, features=None,
            metrics={"t": t1 - t0, "wav_seconds": wav_seconds,
                     "rtf": (t1 - t0) / max(wav_seconds, 1e-9)},
        )

    @torch.no_grad()
    def synthesize_batch(self, texts, prompt_texts, prompt_wavs, prompt_srs,
                         num_step: int = 16, guidance_scale: float = 1.0,
                         speed: float = 1.0, t_shift: float = 0.5,
                         target_rms: float = 0.1, seed: int = 666, seeds=None,
                         precomputed=None) -> List[SynthesisResult]:
        """Several requests in one sampler call and one vocoder call, padded
        to the largest token and frame bucket among them.

        ``seeds`` (one a request) draws each row's noise from its own
        generator, so a row equals the same request served alone in the
        same buckets whatever it was batched with.  Returns one
        SynthesisResult a request; the metrics carry the batch totals."""
        if self.vocos_params is None:
            raise ValueError("pipeline needs vocoder weights")
        t0 = time.monotonic()
        if precomputed is not None:
            rows = [self._request_inputs(None, None, None, None, target_rms, p)
                    for p in precomputed]
        else:
            rows = [self._request_inputs(t, p, w, sr, target_rms, None)
                    for t, p, w, sr in zip(texts, prompt_texts, prompt_wavs, prompt_srs)]
        tokens, prompt_tokens, feats, rmss = (list(c) for c in zip(*rows))
        batch = self._prepare_batch(tokens, prompt_tokens, feats, speed, seed, seeds)
        run = self._sample_fn(int(num_step), float(guidance_scale), float(t_shift))
        mel = run(*batch.args)
        self._sync()
        t1 = time.monotonic()

        wavs = self._vocode_i16_fn()(mel).cpu().numpy().astype(np.float32) / 32767.0
        mel_np = mel.float().cpu().numpy()
        t2 = time.monotonic()

        results = []
        total_secs = 0.0
        for i, gen_len in enumerate(batch.gen_lens):
            w = wavs[i, ..., : max(gen_len - 1, 1) * self.vocos_cfg.hop_length]
            if rmss[i] < target_rms:
                w = w * (rmss[i] / target_rms)
            total_secs += w.shape[-1] / self.feat_cfg.sampling_rate
            results.append(SynthesisResult(wav=w, features=mel_np[i, :gen_len],
                                           metrics={}))
        metrics = {
            "t": t2 - t0, "t_no_vocoder": t1 - t0, "t_vocoder": t2 - t1,
            "wav_seconds": total_secs, "rtf": (t2 - t0) / max(total_secs, 1e-9),
        }
        for r in results:
            r.metrics.update(metrics)
        return results

    def synthesize_long(self, text: str, prompt_text: str, prompt_wav: np.ndarray,
                        prompt_sr: int, num_step: int = 16, guidance_scale: float = 1.0,
                        speed: float = 1.0, t_shift: float = 0.5, target_rms: float = 0.1,
                        seed: int = 666, max_chunk_seconds: float = 20.0,
                        carry_seconds: float = 4.0) -> SynthesisResult:
        """Long-form synthesis beyond the trained utterance length: the text
        splits into sentence chunks, each conditioned on the tail of the
        previous chunk's generated mel (no vocode/fbank round trip), and the
        whole mel is vocoded once."""
        if self.tokenizer is None:
            raise ValueError("pipeline needs a tokenizer")
        t0 = time.monotonic()
        chunks = self._long_form_plan(text, max_chunk_seconds)
        pf0, prompt_rms = self.prompt_features(prompt_wav, prompt_sr, target_rms)
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]
        carry_frames = int(carry_seconds * self.feat_cfg.frame_rate)

        mels = list(self._long_form_mels(chunks, prompt_tokens, pf0, num_step,
                                         guidance_scale, speed, t_shift, seed,
                                         carry_frames))
        full_mel = np.concatenate(mels, axis=0)
        t1 = time.monotonic()
        wav = self.vocode(self._pad_frames(full_mel), full_mel.shape[0])
        if prompt_rms < target_rms:
            wav = wav * (prompt_rms / target_rms)
        t2 = time.monotonic()
        secs = wav.shape[-1] / self.feat_cfg.sampling_rate
        return SynthesisResult(
            wav=wav, features=full_mel,
            metrics={
                "t": t2 - t0, "t_no_vocoder": t1 - t0, "t_vocoder": t2 - t1,
                "wav_seconds": secs, "rtf": (t2 - t0) / max(secs, 1e-9),
                "chunks": len(chunks),
            },
        )

    # ---------------------------------------------------- long-form plumbing

    def _pad_frames(self, mel: np.ndarray) -> np.ndarray:
        """(T, F) mel zero-padded to the frame bucket."""
        t_pad = round_up(mel.shape[0], self.frame_bucket)
        return np.pad(np.asarray(mel, np.float32), ((0, t_pad - mel.shape[0]), (0, 0)))

    def _long_form_plan(self, text: str, max_chunk_seconds: float) -> List[str]:
        """Sentence split + greedy packing into chunks below the length cap,
        with a language-aware duration estimate (a CJK character is a
        syllable, ~0.30 s; a Latin character ~0.06 s)."""
        # Latin punctuation splits only before whitespace (keeps "3.14"
        # together); CJK full-width punctuation splits regardless, since
        # Chinese text has no space after it
        sentences = [
            s.strip()
            for s in re.split(r"(?<=[.!?;])\s+|(?<=[。！？；])\s*", text)
            if s.strip()
        ] or [text]

        def est_seconds(t: str) -> float:
            cjk = sum(1 for ch in t if "一" <= ch <= "鿿")
            return cjk * 0.30 + (len(t) - cjk) * 0.06

        chunks: List[str] = []
        cur = ""
        for s in sentences:
            cand = (cur + " " + s).strip()
            if cur and est_seconds(cand) > max_chunk_seconds:
                chunks.append(cur)
                cur = s
            else:
                cur = cand
        if cur:
            chunks.append(cur)
        return chunks

    def _long_form_mels(self, chunks, prompt_tokens, pf0, num_step, guidance_scale,
                        speed, t_shift, seed, carry_frames: int):
        """Generator of each chunk's generated (T, F) mel (model scale
        removed), each chunk conditioned on the previous chunk's trailing
        mel and a proportional tail of its tokens."""
        cur_prompt_feats = pf0
        cur_prompt_tokens = prompt_tokens
        for ci, chunk in enumerate(chunks):
            tokens = self.tokenizer.texts_to_token_ids([chunk])[0]
            mel, gen_len = self.sample_features(
                tokens, cur_prompt_tokens, cur_prompt_feats, num_step=num_step,
                guidance_scale=guidance_scale, speed=speed, t_shift=t_shift,
                seed=seed + ci,
            )
            mel_np = mel[:gen_len].float().cpu().numpy()
            # carry_frames == 0 conditions every chunk on the original
            # prompt (a mel_np[-0:] slice would carry the whole chunk)
            if carry_frames > 0:
                tail = mel_np[-carry_frames:]
                cur_prompt_feats = torch.from_numpy(
                    (tail + self.feat_cfg.feat_bias) * self.feat_cfg.feat_scale
                ).to(self.device, self.dtype)
                frac = min(1.0, len(tail) / max(gen_len, 1))
                cur_prompt_tokens = tokens[-max(1, int(len(tokens) * frac)):]
            yield mel_np

    def synthesize_stream(self, text: str, prompt_text: str, prompt_wav: np.ndarray,
                          prompt_sr: int, num_step: int = 16, guidance_scale: float = 1.0,
                          speed: float = 1.0, t_shift: float = 0.5,
                          target_rms: float = 0.1, seed: int = 666,
                          max_chunk_seconds: float = 20.0, carry_seconds: float = 4.0,
                          context_frames: int = 32):
        """Streaming long-form synthesis: a generator of float32 wav segments,
        one as each text chunk finishes.  Same chunks and carry as
        synthesize_long; each chunk is vocoded with ``context_frames`` of
        the previous chunk's mel as left context and those samples trimmed,
        so the segments concatenate to synthesize_long's length exactly and
        differ from it only within the vocoder's receptive field of each
        join."""
        if self.tokenizer is None:
            raise ValueError("pipeline needs a tokenizer")
        chunks = self._long_form_plan(text, max_chunk_seconds)
        pf0, prompt_rms = self.prompt_features(prompt_wav, prompt_sr, target_rms)
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]
        carry_frames = int(carry_seconds * self.feat_cfg.frame_rate)
        gain = prompt_rms / target_rms if prompt_rms < target_rms else 1.0
        hop = self.vocos_cfg.hop_length
        # >= 1 context frame for gapless joins: vocode() maps T frames to
        # (T - 1) * hop samples, so a chunk's last frame is emitted by the
        # next segment, whose trim starts one frame into the context
        context_frames = max(1, int(context_frames))

        prev_tail = None  # (C, F) left context from the previous chunk
        for mel_np in self._long_form_mels(chunks, prompt_tokens, pf0, num_step,
                                           guidance_scale, speed, t_shift, seed,
                                           carry_frames):
            ctx = 0 if prev_tail is None else prev_tail.shape[0]
            mel_in = mel_np if prev_tail is None else np.concatenate([prev_tail, mel_np])
            wav = self.vocode(self._pad_frames(mel_in), mel_in.shape[0])
            # drop the context samples but the last context frame's hop,
            # which carries the previous chunk's final frame
            yield wav[..., max(ctx - 1, 0) * hop:] * gain
            prev_tail = mel_np[-context_frames:]
