"""UTMOS22-strong MOS predictor: the model definition, for inference.

The UTMOS strong learner (tarepan/SpeechMOS, Saeki et al. 2022): a
wav2vec2-base feature encoder and a 12-layer post-LN transformer, frozen
data-domain and judge embeddings, a BLSTM and a 2-layer projection head
whose frame scores are averaged and mapped affinely to the MOS scale.  The
port's copy of the reference package's ``eval/models/utmos.py``, pure
torch:

* parameter names follow the published ``utmos22_strong`` checkpoint (that
  naming is the loading contract);
* no train-time machinery (dropout and masking are no-ops at inference;
  parameter-less Dropout placeholders keep the Sequential indices of the
  checkpoint keys);
* the published model pads the sequence to a multiple of 2 and masks the
  padded keys; a masked softmax over padded keys equals the unpadded
  softmax, so no padding is done here;
* attention runs through ``scaled_dot_product_attention``.

Weights: a local state-dict file, or the SpeechMOS release (network
needed); see ``eval/mos.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

# (channels, kernel, stride) of the wav2vec2-base feature encoder
_CONV_SPEC: List[Tuple[int, int, int]] = (
    [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
)
_D_SSL = 768
_D_EMB = 128
_D_LSTM = 512
_D_PROJ = 2048
_N_LAYERS = 12
_N_HEADS = 12
_POS_CONV_KERNEL = 128
_POS_CONV_GROUPS = 16


class _WeightNormConv1d(nn.Module):
    """Conv1d stored as (weight_g, weight_v) like torch's weight_norm with
    dim=2 — matches the ``pos_conv.0.weight_g/weight_v`` checkpoint keys
    without depending on the deprecated parametrization API."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel)
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups
        self.padding = kernel // 2
        nn.init.kaiming_uniform_(self.weight_v, a=5**0.5)

    def forward(self, x: Tensor) -> Tensor:
        # norm over (out, in) per kernel position (weight_norm dim=2)
        norm = self.weight_v.norm(dim=(0, 1), keepdim=True)
        w = self.weight_g * self.weight_v / norm.clamp_min(1e-12)
        return F.conv1d(x, w, self.bias, padding=self.padding,
                        groups=self.groups)


class _SelfAttention(nn.Module):
    """Standard MHA with separate q/k/v/out projections (checkpoint naming)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, x: Tensor) -> Tensor:
        b, t, d = x.shape
        h = self.heads

        def split(z: Tensor) -> Tensor:
            return z.view(b, t, h, d // h).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        )
        return self.out_proj(out.transpose(1, 2).reshape(b, t, d))


class _EncoderLayer(nn.Module):
    """Post-LN transformer layer: Res[Attn]-LN, Res[FFN(gelu)]-LN."""

    def __init__(self, dim: int, ffn_dim: int, heads: int):
        super().__init__()
        self.self_attn = _SelfAttention(dim, heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x: Tensor) -> Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class _Encoder(nn.Module):
    """Relative-position conv + post-LN transformer stack."""

    def __init__(self, dim: int):
        super().__init__()
        # Sequential keeps the `.0` index of the checkpoint's pos_conv keys;
        # SamePad + GELU of the reference are applied functionally.
        self.pos_conv = nn.Sequential(
            _WeightNormConv1d(dim, _POS_CONV_KERNEL, _POS_CONV_GROUPS)
        )
        self.layer_norm = nn.LayerNorm(dim)
        self.layers = nn.ModuleList(
            _EncoderLayer(dim, 4 * dim, _N_HEADS) for _ in range(_N_LAYERS)
        )

    def forward(self, x: Tensor) -> Tensor:
        # even kernel -> drop the trailing frame ("SamePad")
        pos = self.pos_conv[0](x.transpose(1, 2))[:, :, :-1]
        x = x + F.gelu(pos).transpose(1, 2)
        x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return x


class _FeatureExtractor(nn.Module):
    """Strided conv waveform encoder (wav2vec2-base spec)."""

    def __init__(self):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        d_in = 1
        for i, (d, k, s) in enumerate(_CONV_SPEC):
            mods: List[nn.Module] = [
                nn.Conv1d(d_in, d, k, stride=s, bias=False),
                nn.Dropout(0.0),  # placeholder keeps checkpoint indices
            ]
            if i == 0:
                mods.append(nn.GroupNorm(d, d))
            mods.append(nn.GELU())
            self.conv_layers.append(nn.Sequential(*mods))
            d_in = d

    def forward(self, wave: Tensor) -> Tensor:
        x = wave.unsqueeze(1)
        for block in self.conv_layers:
            x = block(x)
        return x  # (B, C, frames)


class Wav2Vec2Model(nn.Module):
    """wav2vec2 trunk: conv encoder -> LN -> projection -> transformer."""

    def __init__(self):
        super().__init__()
        self.feature_extractor = _FeatureExtractor()
        self.layer_norm = nn.LayerNorm(512)
        self.post_extract_proj = nn.Linear(512, _D_SSL)
        self.encoder = _Encoder(_D_SSL)
        # unused at inference; exists in the checkpoint
        self.mask_emb = nn.Parameter(torch.zeros(_D_SSL))

    def forward(self, wave: Tensor) -> Tensor:
        feats = self.feature_extractor(wave).transpose(1, 2)
        return self.encoder(self.post_extract_proj(self.layer_norm(feats)))


class UTMOS22Strong(nn.Module):
    """Wave -> MOS score in [1, 5] (frame scores averaged, *2 + 3)."""

    def __init__(self):
        super().__init__()
        self.wav2vec2 = Wav2Vec2Model()
        self.domain_emb = nn.Parameter(torch.zeros(1, _D_EMB),
                                       requires_grad=False)
        self.judge_emb = nn.Parameter(torch.zeros(1, _D_EMB),
                                      requires_grad=False)
        self.blstm = nn.LSTM(_D_SSL + 2 * _D_EMB, _D_LSTM, batch_first=True,
                             bidirectional=True)
        self.projection = nn.Sequential(
            nn.Linear(2 * _D_LSTM, _D_PROJ), nn.ReLU(), nn.Linear(_D_PROJ, 1)
        )

    def forward(self, wave: Tensor, sr: int = 16000) -> Tensor:
        """(B, T) 16 kHz waveform -> (B,) MOS."""
        assert sr == 16000, "resample to 16 kHz before scoring"
        units = self.wav2vec2(wave)  # (B, frames, 768)
        b, frames, _ = units.shape
        cond = torch.cat(
            [self.domain_emb, self.judge_emb], dim=-1
        ).expand(b, frames, -1)
        feats = torch.cat([units, cond.to(units.dtype)], dim=-1)
        scores = self.projection(self.blstm(feats)[0])  # (B, frames, 1)
        return scores.mean(dim=1).squeeze(-1) * 2.0 + 3.0


def load_utmos22_strong(checkpoint: str = None) -> UTMOS22Strong:
    """Build the predictor; load weights from a local state-dict file or,
    failing that, from the torch.hub SpeechMOS release (network needed)."""
    model = UTMOS22Strong()
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        missing, unexpected = model.load_state_dict(sd, strict=False)
        missing = [m for m in missing if "num_batches_tracked" not in m]
        if missing:
            raise RuntimeError(f"UTMOS checkpoint missing tensors: {missing[:8]}")
    else:
        hub_url = (
            "https://github.com/tarepan/SpeechMOS/releases/download/"
            "v1.2.0/utmos22_strong.pt"
        )
        sd = torch.hub.load_state_dict_from_url(hub_url, map_location="cpu")
        model.load_state_dict(sd)
    model.eval()
    return model
