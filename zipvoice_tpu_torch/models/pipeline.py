"""Zero-shot TTS inference pipeline: tokenize -> fbank -> ODE -> vocoder.

The PyTorch counterpart of ``ZipVoicePipeline.synthesize``: the prompt
fbank, the text encoder, the CFG Euler sampler and the Vocos vocoder all run
on the pipeline's device; only the PCM16 wav comes back to the host.
Padded shapes follow the same token/frame buckets as the reference package,
so the bucketed values equal the unbucketed ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from zipvoice_tpu_torch.audio.mel import (
    compute_num_frames,
    extract_features,
    stft_pad_amount,
)
from zipvoice_tpu_torch.audio.vocos import VocosConfig, vocos_decode
from zipvoice_tpu_torch.audio.wav import resample
from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig
from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.utils.device import resolve_device
from zipvoice_tpu_torch.utils.shapes import round_up


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # (L,) float32
    features: np.ndarray  # (T_gen, F) generated mel (model scale removed)
    metrics: Dict[str, float]


@dataclasses.dataclass
class _SampleInputs:
    tokens_padded: torch.Tensor
    tokens_lens: torch.Tensor
    prompt_features: torch.Tensor
    prompt_features_lens: torch.Tensor
    features_lens: torch.Tensor
    noise: torch.Tensor
    gen_len: int  # generated frames (host arithmetic, sync-free)


class ZipVoicePipeline:
    """Host-side orchestration around the model and the vocoder."""

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
    ):
        if quantize is not None:
            raise NotImplementedError(
                "int8 quantization is not yet ported to zipvoice_tpu_torch"
            )
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.vocos_params = (
            None if vocos_params is None
            else {k: v.to(device=self.device, dtype=dtype)
                  for k, v in vocos_params.items()}
        )
        self.model_cfg = model_cfg
        self.feat_cfg = feat_cfg
        self.vocos_cfg = vocos_cfg
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.token_bucket = token_bucket
        self.frame_bucket = frame_bucket

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prompt_features(self, prompt_wav: np.ndarray, sr: int,
                        target_rms: float = 0.1) -> Tuple[torch.Tensor, float]:
        """Resample + RMS-normalize + fbank the prompt.  Returns ((Tp, F)
        device tensor in model scale, prompt_rms).

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
            fcfg, pre_padded=True,
        )
        feats = (feats + fcfg.feat_bias) * fcfg.feat_scale
        # the vocos pad always yields at least the lhotse frame count
        return feats[: compute_num_frames(length, fcfg.hop_length)], prompt_rms

    def _prepare_sample_inputs(self, tokens, prompt_tokens, prompt_feats,
                               speed: float, seed: int,
                               noise: Optional[np.ndarray] = None) -> _SampleInputs:
        """Bucket-pad one request; noise comes from a seeded generator on
        the device unless given explicitly ((1, T, F) numpy)."""
        cat_tokens = list(prompt_tokens) + list(tokens)
        prompt_len_frames = int(prompt_feats.shape[0])
        total_frames = int(zv.predict_features_lens(
            np.array([prompt_len_frames]),
            np.array([max(len(prompt_tokens), 1)]),
            np.array([len(tokens)]),
            speed=speed,
        )[0])
        s_pad = round_up(len(cat_tokens) + 1, self.token_bucket)
        t_pad = round_up(total_frames, self.frame_bucket)
        dev, feat_dim = self.device, self.model_cfg.feat_dim

        tokens_padded = np.full((1, s_pad), self.model_cfg.pad_id, np.int64)
        row = cat_tokens + [self.model_cfg.pad_id]
        tokens_padded[0, : len(row)] = row

        pf = torch.zeros((1, t_pad, prompt_feats.shape[-1]), dtype=self.dtype,
                         device=dev)
        if not isinstance(prompt_feats, torch.Tensor):
            prompt_feats = torch.from_numpy(np.array(prompt_feats, np.float32))
        pf[0, :prompt_len_frames] = prompt_feats.to(dev, self.dtype)

        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise_t = torch.randn((1, t_pad, feat_dim), generator=gen, device=dev,
                                  dtype=torch.float32).to(self.dtype)
        else:
            noise = np.asarray(noise, np.float32)
            if noise.shape[1] < t_pad:
                noise = np.concatenate(
                    [noise, np.zeros((1, t_pad - noise.shape[1], noise.shape[-1]),
                                     np.float32)], axis=1)
            noise_t = torch.from_numpy(noise[:, :t_pad]).to(dev, self.dtype)

        def ints(values):
            return torch.tensor(values, dtype=torch.int64, device=dev)

        return _SampleInputs(
            tokens_padded=torch.from_numpy(tokens_padded).to(dev),
            tokens_lens=ints([len(cat_tokens)]),
            prompt_features=pf,
            prompt_features_lens=ints([prompt_len_frames]),
            features_lens=ints([total_frames]),
            noise=noise_t,
            gen_len=total_frames - prompt_len_frames,
        )

    @torch.no_grad()
    def sample_features(self, tokens, prompt_tokens, prompt_feats,
                        num_step: int = 16, guidance_scale: float = 1.0,
                        speed: float = 1.0, t_shift: float = 0.5, seed: int = 666,
                        noise: Optional[np.ndarray] = None,
                        timesteps=None) -> Tuple[torch.Tensor, int]:
        """Run the sampler.  Returns ((T_bucket, F) mel on the device with
        frames >= gen_len zeroed, gen_len)."""
        s = self._prepare_sample_inputs(tokens, prompt_tokens, prompt_feats,
                                        speed, seed, noise)
        x1 = zv.sample(
            self.model, s.tokens_padded, s.tokens_lens, s.prompt_features,
            s.prompt_features_lens, s.features_lens, s.noise,
            num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift,
            timesteps=timesteps,
        )
        # strip the prompt: roll the generated region to the front (row b
        # left by its prompt length), zero the rest
        t = x1.shape[1]
        frames = torch.arange(t, device=x1.device)[None, :]
        src = (frames + s.prompt_features_lens[:, None]) % t
        x_gen = torch.gather(x1, 1, src[:, :, None].expand(-1, -1, x1.shape[-1]))
        gen_lens = s.features_lens - s.prompt_features_lens
        x_gen = x_gen.masked_fill((frames >= gen_lens[:, None])[:, :, None], 0.0)
        # undo the model feature scaling
        mel = x_gen / self.feat_cfg.feat_scale - self.feat_cfg.feat_bias
        return mel[0], s.gen_len

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor, gen_len: int) -> np.ndarray:
        """Vocode a (T_bucket, F) mel whose frames >= gen_len are zero;
        PCM16 on the device, float32 wav of (gen_len - 1) * hop samples on
        the host."""
        if self.vocos_params is None:
            raise ValueError("pipeline needs vocoder weights")
        wav = vocos_decode(self.vocos_params, mel.to(self.dtype)[None], self.vocos_cfg)
        pcm = torch.round(torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        out = pcm[0].cpu().numpy().astype(np.float32) / 32767.0
        return out[: max(gen_len - 1, 1) * self.vocos_cfg.hop_length]

    def synthesize(self, text: str, prompt_text: str, prompt_wav: np.ndarray,
                   prompt_sr: int, num_step: int = 16, guidance_scale: float = 1.0,
                   speed: float = 1.0, t_shift: float = 0.5, target_rms: float = 0.1,
                   seed: int = 666, timesteps=None) -> SynthesisResult:
        if self.tokenizer is None:
            raise ValueError("pipeline needs a tokenizer")
        t0 = time.monotonic()
        tokens = self.tokenizer.texts_to_token_ids([text])[0]
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]
        pf, prompt_rms = self.prompt_features(prompt_wav, prompt_sr, target_rms)
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
