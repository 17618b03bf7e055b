"""Speaker-verification model for SIM-o: ECAPA-TDNN on WavLM-large features.

Speaker similarity is scored with an ECAPA-TDNN head on a layer-weighted
sum of WavLM-large hidden states (checkpoint ``wavlm_large_finetune.pth``
of k2-fsa/TTS_eval_models).  The port's copy of the reference package's
``eval/models/ecapa_tdnn_wavlm.py``:

* the SSL trunk is ``transformers.WavLMModel``, imported only when a model
  is built without an ``ssl`` module; ``convert_wavlm_fairseq_to_hf`` maps
  an original fairseq-style ``wavlm_large.pt`` state dict onto it;
* the head (Conv1dReluBn, SE-Res2Blocks, attentive statistics pooling)
  keeps the checkpoint's parameter names, which are the loading contract;
* inference only: no dropout or masking.

Hidden states: s3prl's WavLM expert collects ``input[0]`` of every encoder
layer plus the encoder's final output, so for stable-layer-norm models its
list is [the stream entering layer 0, ..., entering layer L-1, the
post-final-LN output].  ``output_hidden_states`` of the HF module follows
the same convention for ``do_stable_layer_norm=True``;
``extract_hidden_states_s3prl_convention`` collects the states s3prl's
way, so that a test can hold the two equal.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import Tensor, nn

# WavLM-Large geometry (fairseq cfg of the released checkpoint)
WAVLM_LARGE = dict(
    hidden_size=1024,
    num_hidden_layers=24,
    num_attention_heads=16,
    intermediate_size=4096,
    conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2],
    conv_stride=[5, 2, 2, 2, 2, 2, 2],
    conv_bias=True,
    feat_extract_norm="layer",
    do_stable_layer_norm=True,
    num_buckets=320,
    max_bucket_distance=800,
)


# ---------------------------------------------------------------------------
# ECAPA-TDNN head (parameter names = checkpoint contract)
# ---------------------------------------------------------------------------


class _ConvReluBn(nn.Module):
    """conv -> relu -> batchnorm (the ECAPA ordering)."""

    def __init__(self, d_in: int, d_out: int, k: int = 1, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(d_in, d_out, k, padding=padding,
                              dilation=dilation)
        self.bn = nn.BatchNorm1d(d_out)

    def forward(self, x: Tensor) -> Tensor:
        return self.bn(F.relu(self.conv(x)))


class _Res2ConvReluBn(nn.Module):
    """Res2Net-style grouped convolution: the channel dim splits into
    `scale` groups; group i (i>0) is convolved after adding group i-1's
    pre-conv input, the last group passes through untouched."""

    def __init__(self, channels: int, k: int, padding: int, dilation: int,
                 scale: int = 8):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        self.width = channels // scale
        n = scale - 1 if scale > 1 else 1
        self.convs = nn.ModuleList(
            nn.Conv1d(self.width, self.width, k, padding=padding,
                      dilation=dilation)
            for _ in range(n)
        )
        self.bns = nn.ModuleList(nn.BatchNorm1d(self.width) for _ in range(n))

    def forward(self, x: Tensor) -> Tensor:
        groups = torch.split(x, self.width, dim=1)
        out: List[Tensor] = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = groups[i] if sp is None else sp + groups[i]
            # the carry between groups is the POST bn(relu(conv)) output
            sp = bn(F.relu(conv(sp)))
            out.append(sp)
        if self.scale > 1:
            out.append(groups[-1])
        return torch.cat(out, dim=1)


class _SEConnect(nn.Module):
    """Squeeze-excitation gate over the time-mean."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = nn.Linear(channels, bottleneck)
        self.linear2 = nn.Linear(bottleneck, channels)

    def forward(self, x: Tensor) -> Tensor:
        gate = torch.sigmoid(self.linear2(F.relu(self.linear1(x.mean(dim=2)))))
        return x * gate.unsqueeze(2)


class _SERes2Block(nn.Module):
    """1x1 conv -> res2 conv -> 1x1 conv -> SE, with residual."""

    def __init__(self, channels: int, k: int, padding: int, dilation: int,
                 scale: int = 8, se_bottleneck: int = 128):
        super().__init__()
        # attribute names mirror the checkpoint tree
        self.Conv1dReluBn1 = _ConvReluBn(channels, channels)
        self.Res2Conv1dReluBn = _Res2ConvReluBn(channels, k, padding, dilation,
                                                scale)
        self.Conv1dReluBn2 = _ConvReluBn(channels, channels)
        self.SE_Connect = _SEConnect(channels, se_bottleneck)

    def forward(self, x: Tensor) -> Tensor:
        y = self.Conv1dReluBn1(x)
        y = self.Res2Conv1dReluBn(y)
        y = self.Conv1dReluBn2(y)
        return self.SE_Connect(y) + x


class _AttentiveStatsPool(nn.Module):
    """Attention-weighted mean/std pooling over time."""

    def __init__(self, d_in: int, attention_channels: int = 128):
        super().__init__()
        self.linear1 = nn.Conv1d(d_in, attention_channels, 1)
        self.linear2 = nn.Conv1d(attention_channels, d_in, 1)

    def forward(self, x: Tensor) -> Tensor:
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x))), dim=2)
        mean = (alpha * x).sum(dim=2)
        var = (alpha * x * x).sum(dim=2) - mean * mean
        return torch.cat([mean, var.clamp_min(1e-9).sqrt()], dim=1)


class ECAPA_TDNN_WavLM(nn.Module):
    """Layer-weighted WavLM features -> ECAPA-TDNN -> speaker embedding."""

    def __init__(self, feat_dim: int = 1024, channels: int = 512,
                 emb_dim: int = 256, ssl: nn.Module = None):
        super().__init__()
        if ssl is None:
            from transformers import WavLMConfig, WavLMModel

            ssl = WavLMModel(WavLMConfig(**WAVLM_LARGE))
        self.ssl = ssl
        n_states = getattr(ssl.config, "num_hidden_layers", 24) + 1
        self.feature_weight = nn.Parameter(torch.zeros(n_states))
        self.instance_norm = nn.InstanceNorm1d(feat_dim)
        cat_channels = channels * 3
        self.layer1 = _ConvReluBn(feat_dim, channels, k=5, padding=2)
        self.layer2 = _SERes2Block(channels, 3, padding=2, dilation=2)
        self.layer3 = _SERes2Block(channels, 3, padding=3, dilation=3)
        self.layer4 = _SERes2Block(channels, 3, padding=4, dilation=4)
        self.conv = nn.Conv1d(cat_channels, 1536, 1)
        self.pooling = _AttentiveStatsPool(1536)
        self.bn = nn.BatchNorm1d(1536 * 2)
        self.linear = nn.Linear(1536 * 2, emb_dim)

    def extract_features(self, wave: Tensor) -> Tensor:
        """(B, T) 16 kHz waveform -> (B, feat_dim, frames)."""
        # WavLM-Large is a `normalize=True` model: per-sample zero-mean/unit-
        # var input (fairseq applies F.layer_norm over the whole waveform).
        wave = (wave - wave.mean(dim=1, keepdim=True)) / (
            wave.var(dim=1, keepdim=True, unbiased=False) + 1e-7
        ).sqrt()
        with torch.no_grad():
            states = self.ssl(wave, output_hidden_states=True).hidden_states
        stack = torch.stack(states, dim=0)  # (L+1, B, frames, D)
        w = torch.softmax(self.feature_weight, dim=0).view(-1, 1, 1, 1)
        feats = (w * stack).sum(dim=0).transpose(1, 2) + 1e-6
        return self.instance_norm(feats)

    def forward(self, wave: Tensor) -> Tensor:
        """(B, T) 16 kHz waveform -> (B, emb_dim) speaker embedding."""
        x = self.extract_features(wave)
        o1 = self.layer1(x)
        o2 = self.layer2(o1)
        o3 = self.layer3(o2)
        o4 = self.layer4(o3)
        pooled = self.pooling(F.relu(self.conv(torch.cat([o2, o3, o4], dim=1))))
        return self.linear(self.bn(pooled))


def extract_hidden_states_s3prl_convention(ssl: nn.Module,
                                           wave: Tensor) -> List[Tensor]:
    """Hidden states via forward hooks placed exactly where s3prl places
    them (s3prl upstream/wavlm/expert.py): ``input[0]`` of every encoder
    layer, then the encoder's final output: the extraction of the published
    SIM-o stack.  It exists so that a test can hold HF's
    ``output_hidden_states`` to the same convention for stable-layer-norm
    models; extract_features takes the HF path directly."""
    captured: List[Tensor] = []
    hooks = []
    for layer in ssl.encoder.layers:
        hooks.append(layer.register_forward_hook(
            lambda mod, args, out, store=captured: store.append(
                args[0].detach()
            )
        ))
    try:
        with torch.no_grad():
            final = ssl(wave).last_hidden_state
    finally:
        for h in hooks:
            h.remove()
    return captured + [final]


# ---------------------------------------------------------------------------
# Weight loading: fairseq-style WavLM checkpoints -> HF module
# ---------------------------------------------------------------------------

_FAIRSEQ_RENAMES = [
    # (fairseq pattern, HF replacement) — the published conversion mapping
    (r"^mask_emb$", "masked_spec_embed"),
    (r"^post_extract_proj\.", "feature_projection.projection."),
    (r"^layer_norm\.", "feature_projection.layer_norm."),
    (r"^feature_extractor\.conv_layers\.(\d+)\.0\.",
     r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^feature_extractor\.conv_layers\.0\.2\.",
     "feature_extractor.conv_layers.0.layer_norm."),
    (r"^encoder\.pos_conv\.0\.weight_g$",
     "encoder.pos_conv_embed.conv.parametrizations.weight.original0"),
    (r"^encoder\.pos_conv\.0\.weight_v$",
     "encoder.pos_conv_embed.conv.parametrizations.weight.original1"),
    (r"^encoder\.pos_conv\.0\.", "encoder.pos_conv_embed.conv."),
    (r"^encoder\.layer_norm\.", "encoder.layer_norm."),
    (r"^encoder\.layers\.(\d+)\.self_attn\.grep_linear\.",
     r"encoder.layers.\1.attention.gru_rel_pos_linear."),
    (r"^encoder\.layers\.(\d+)\.self_attn\.grep_a$",
     r"encoder.layers.\1.attention.gru_rel_pos_const"),
    (r"^encoder\.layers\.(\d+)\.self_attn\.relative_attention_bias\.",
     r"encoder.layers.\1.attention.rel_attn_embed."),
    (r"^encoder\.layers\.(\d+)\.self_attn\.",
     r"encoder.layers.\1.attention."),
    (r"^encoder\.layers\.(\d+)\.self_attn_layer_norm\.",
     r"encoder.layers.\1.layer_norm."),
    (r"^encoder\.layers\.(\d+)\.fc1\.",
     r"encoder.layers.\1.feed_forward.intermediate_dense."),
    (r"^encoder\.layers\.(\d+)\.fc2\.",
     r"encoder.layers.\1.feed_forward.output_dense."),
    (r"^encoder\.layers\.(\d+)\.final_layer_norm\.",
     r"encoder.layers.\1.final_layer_norm."),
]


def convert_wavlm_fairseq_to_hf(sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Rename an original (fairseq-style) WavLM state dict to HF WavLMModel
    naming.  Keys with no mapping (quantizer/projection heads used only in
    pre-training) are dropped with a debug log."""
    out: Dict[str, Tensor] = {}
    for k, v in sd.items():
        for pat, rep in _FAIRSEQ_RENAMES:
            new, n = re.subn(pat, rep, k)
            if n:
                out[new] = v
                break
        else:
            logging.debug("convert_wavlm: dropping %s", k)
    return out


def load_wavlm_ssl(path: str):
    """Build an HF WavLMModel from an original ``wavlm_large.pt`` checkpoint
    (dict with 'cfg'/'model') or from an HF directory/repo path."""
    from transformers import WavLMConfig, WavLMModel

    if path.endswith(".pt") or path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt)
        model = WavLMModel(WavLMConfig(**WAVLM_LARGE))
        hf_sd = convert_wavlm_fairseq_to_hf(sd)
        missing, unexpected = model.load_state_dict(hf_sd, strict=False)
        real_missing = [m for m in missing if "num_batches_tracked" not in m]
        if real_missing:
            logging.warning("load_wavlm_ssl: %d unmatched HF tensors (e.g. %s)",
                            len(real_missing), real_missing[:4])
        return model
    return WavLMModel.from_pretrained(path)


def load_sv_model(sv_checkpoint: str, ssl_path: str = None) -> ECAPA_TDNN_WavLM:
    """Assemble the SIM-o scorer: WavLM-large SSL + finetuned ECAPA head.

    sv_checkpoint: ``wavlm_large_finetune.pth`` (dict with 'model').
    ssl_path: ``wavlm_large.pt`` / HF dir; None keeps random SSL (tests).
    """
    ssl = load_wavlm_ssl(ssl_path) if ssl_path else None
    model = ECAPA_TDNN_WavLM(ssl=ssl)
    ckpt = torch.load(sv_checkpoint, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    head_sd = {k: v for k, v in sd.items()
               if not k.startswith("feature_extract.")}
    missing, unexpected = model.load_state_dict(head_sd, strict=False)
    head_missing = [m for m in missing if not m.startswith("ssl.")
                    and "num_batches_tracked" not in m]
    if head_missing:
        raise RuntimeError(f"SV head tensors missing: {head_missing[:8]}")
    # finetuned SSL weights ride under feature_extract.model.* when present
    ssl_sd = {k[len("feature_extract.model."):]: v for k, v in sd.items()
              if k.startswith("feature_extract.model.")}
    if ssl_sd:
        hf_sd = convert_wavlm_fairseq_to_hf(ssl_sd)
        model.ssl.load_state_dict(hf_sd, strict=False)
    model.eval()
    return model
