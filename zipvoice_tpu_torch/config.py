"""Model configuration: the ``model.json`` contract of a ZipVoice model dir.

A JSON file with a ``model`` section (architecture hyperparameters) and a
``feature`` section (sampling rate / feature type).  A trained model dir is
``{model.pt, model.json, tokens.txt}``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union


def _to_tuple(x, n: int) -> Tuple[int, ...]:
    """Broadcast an int or 1-elem sequence to an n-tuple."""
    if isinstance(x, int):
        x = (x,)
    x = tuple(x)
    if len(x) == 1:
        x = x * n
    if len(x) != n:
        raise ValueError(f"expected {n} values, got {x}")
    return x


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    """Hyperparameters of one TTSZipformer backbone."""

    in_dim: int
    out_dim: int
    downsampling_factor: Tuple[int, ...] = (2, 4)
    num_encoder_layers: Union[int, Tuple[int, ...]] = 4
    cnn_module_kernel: Union[int, Tuple[int, ...]] = 31
    encoder_dim: int = 384
    query_head_dim: int = 24
    pos_head_dim: int = 4
    value_head_dim: int = 12
    num_heads: int = 8
    feedforward_dim: int = 1536
    pos_dim: int = 192
    use_time_embed: bool = True
    time_embed_dim: int = 192
    use_guidance_scale_embed: bool = False
    guidance_scale_embed_dim: int = 192
    use_conv: bool = True
    # keep the time-embed MLP and the final out_proj in f32 while the bulk
    # of the backbone runs in bf16
    f32_closers: bool = False

    def __post_init__(self):
        ds = self.downsampling_factor
        if isinstance(ds, int):
            ds = (ds,)
        ds = tuple(ds)
        object.__setattr__(self, "downsampling_factor", ds)
        n = len(ds)
        object.__setattr__(
            self, "num_encoder_layers", _to_tuple(self.num_encoder_layers, n)
        )
        object.__setattr__(
            self, "cnn_module_kernel", _to_tuple(self.cnn_module_kernel, n)
        )
        # U-net symmetry: 1, 2, 4, ..., 4, 2, 1
        ok = ds[0] == 1 and ds[-1] == 1
        ok = ok and all(ds[i] == ds[i - 1] * 2 for i in range(1, n // 2 + 1))
        ok = ok and all(ds[i] * 2 == ds[i - 1] for i in range(n // 2 + 1, n))
        if not ok:
            raise ValueError(f"downsampling factors must be a U-net: {ds}")

    @property
    def num_stacks(self) -> int:
        return len(self.downsampling_factor)


@dataclasses.dataclass(frozen=True)
class ZipVoiceConfig:
    """ZipVoice model hyperparameters (defaults: the published 123M base)."""

    fm_decoder_downsampling_factor: Tuple[int, ...] = (1, 2, 4, 2, 1)
    fm_decoder_num_layers: Tuple[int, ...] = (2, 2, 4, 4, 4)
    fm_decoder_cnn_module_kernel: Tuple[int, ...] = (31, 15, 7, 15, 31)
    fm_decoder_feedforward_dim: int = 1536
    fm_decoder_num_heads: int = 4
    fm_decoder_dim: int = 512
    text_encoder_num_layers: int = 4
    text_encoder_feedforward_dim: int = 512
    text_encoder_cnn_module_kernel: int = 9
    text_encoder_num_heads: int = 4
    text_encoder_dim: int = 192
    time_embed_dim: int = 192
    text_embed_dim: int = 192
    query_head_dim: int = 32
    value_head_dim: int = 12
    pos_head_dim: int = 4
    pos_dim: int = 48
    feat_dim: int = 100
    vocab_size: int = 26
    pad_id: int = 0
    use_guidance_scale_embed: bool = False  # ZipVoice-Distill
    guidance_scale_embed_dim: int = 192
    # f32 time-embed MLP + final out_proj in the fm_decoder, and an f32
    # Euler/CFG state in the sampler
    f32_closers: bool = False

    def fm_decoder_config(self) -> ZipformerConfig:
        """The fm_decoder takes the [x_t, text_cond, speech_cond] concat."""
        return ZipformerConfig(
            in_dim=self.feat_dim * 3,
            out_dim=self.feat_dim,
            downsampling_factor=self.fm_decoder_downsampling_factor,
            num_encoder_layers=self.fm_decoder_num_layers,
            cnn_module_kernel=self.fm_decoder_cnn_module_kernel,
            encoder_dim=self.fm_decoder_dim,
            feedforward_dim=self.fm_decoder_feedforward_dim,
            num_heads=self.fm_decoder_num_heads,
            query_head_dim=self.query_head_dim,
            pos_head_dim=self.pos_head_dim,
            value_head_dim=self.value_head_dim,
            pos_dim=self.pos_dim,
            use_time_embed=True,
            time_embed_dim=self.time_embed_dim,
            use_guidance_scale_embed=self.use_guidance_scale_embed,
            guidance_scale_embed_dim=self.guidance_scale_embed_dim,
            f32_closers=self.f32_closers,
        )

    def text_encoder_config(self) -> ZipformerConfig:
        return ZipformerConfig(
            in_dim=self.text_embed_dim,
            out_dim=self.feat_dim,
            downsampling_factor=(1,),
            num_encoder_layers=self.text_encoder_num_layers,
            cnn_module_kernel=self.text_encoder_cnn_module_kernel,
            encoder_dim=self.text_encoder_dim,
            feedforward_dim=self.text_encoder_feedforward_dim,
            num_heads=self.text_encoder_num_heads,
            query_head_dim=self.query_head_dim,
            pos_head_dim=self.pos_head_dim,
            value_head_dim=self.value_head_dim,
            pos_dim=self.pos_dim,
            use_time_embed=False,
            time_embed_dim=self.time_embed_dim,
        )


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Acoustic feature config."""

    sampling_rate: int = 24000
    type: str = "vocos"  # only "vocos" is ported
    n_mels: int = 100
    n_fft: int = 1024
    hop_length: int = 256
    # the model sees (fbank + feat_bias) * feat_scale
    feat_scale: float = 0.1
    feat_bias: float = 0.0

    @property
    def frame_rate(self) -> float:
        return self.sampling_rate / self.hop_length


_MODEL_FIELDS = {f.name for f in dataclasses.fields(ZipVoiceConfig)}
_FEATURE_FIELDS = {f.name for f in dataclasses.fields(FeatureConfig)}


def load_model_json(
    path: Union[str, Path],
    vocab_size: Optional[int] = None,
    pad_id: Optional[int] = None,
) -> Tuple[ZipVoiceConfig, FeatureConfig]:
    """Parse a model.json into configs; vocab_size / pad_id come from the
    tokenizer (tokens.txt)."""
    with open(path) as f:
        raw = json.load(f)
    model_kw = {
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in raw.get("model", {}).items()
        if k in _MODEL_FIELDS
    }
    if vocab_size is not None:
        model_kw["vocab_size"] = vocab_size
    if pad_id is not None:
        model_kw["pad_id"] = pad_id
    feat_kw = {k: v for k, v in raw.get("feature", {}).items() if k in _FEATURE_FIELDS}
    return ZipVoiceConfig(**model_kw), FeatureConfig(**feat_kw)


def save_model_json(path: Union[str, Path], model: ZipVoiceConfig, feat: FeatureConfig):
    model_d = dataclasses.asdict(model)
    model_d = {k: (list(v) if isinstance(v, tuple) else v) for k, v in model_d.items()}
    # vocab/pad are tokenizer-derived and stay out of the json
    model_d.pop("vocab_size", None)
    model_d.pop("pad_id", None)
    feat_d = {"sampling_rate": feat.sampling_rate, "type": feat.type}
    with open(path, "w") as f:
        json.dump({"model": model_d, "feature": feat_d}, f, indent=2)
