"""ZipVoice flow-matching TTS model: inference and the training loss in PyTorch.

``ZipVoiceModel`` holds the token embedding and the two Zipformers under
the published state_dict names; the forward pieces below are functions
over it.  Host-side arithmetic (label padding, duration prediction) stays
in numpy.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.nn.functional import make_pad_mask
from zipvoice_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    fold_rank,
    gather_frames,
    global_sum,
    scatter_frames,
)
from zipvoice_tpu_torch.nn.zipformer import (
    BiasNorm,
    TrainCtx,
    TTSZipformer,
    _Scale,
    check_sp_frames,
    sequence_parallel,
    tts_zipformer_forward,
)


class ZipVoiceModel(nn.Module):
    def __init__(self, cfg: ZipVoiceConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.text_embed_dim)
        self.fm_decoder = TTSZipformer(cfg.fm_decoder_config())
        self.text_encoder = TTSZipformer(cfg.text_encoder_config())


@torch.no_grad()
def init_zipvoice(cfg: ZipVoiceConfig, generator: Optional[torch.Generator] = None,
                  device="cpu") -> ZipVoiceModel:
    """Random weights with the JAX package's init statistics: Linear
    U(+-1/sqrt(in)) times its initial scale (bias U(+-0.1*scale) when the
    scale is not 1), depthwise conv U(+-1/sqrt(K)), embedding N(0, 1),
    bypass scales 0.5, BiasNorm log_scale 1 and bias 0, downsample bias 0.
    Draws come from ``generator`` (on ``device``)."""
    with torch.device("meta"):
        model = ZipVoiceModel(cfg)
    return init_weights(model.to_empty(device=device), generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Fill ``model``'s parameters in place with init_zipvoice's statistics."""
    g = generator
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            scale = getattr(mod, "initial_scale", 1.0)
            mod.weight.uniform_(-bound, bound, generator=g).mul_(scale)
            if mod.bias is not None:
                b = bound if scale == 1.0 else 0.1 * scale
                mod.bias.uniform_(-b, b, generator=g)
        elif isinstance(mod, nn.Conv1d):
            bound = 1.0 / math.sqrt(mod.kernel_size[0])
            mod.weight.uniform_(-bound, bound, generator=g)
            mod.bias.uniform_(-bound, bound, generator=g)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(generator=g)
        elif isinstance(mod, BiasNorm):
            mod.log_scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, _Scale):
            for name, p in mod.named_parameters():
                p.fill_(0.5 if name == "bypass_scale" else 0.0)
    return model


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------


def pad_labels(tokens: List[List[int]], pad_id: int) -> np.ndarray:
    """Pad token id lists to (B, S), appending one extra pad to every
    sequence so the duration-expansion index tokens_lens is in bounds."""
    tokens = [list(t) + [pad_id] for t in tokens]
    max_len = max(len(t) for t in tokens)
    return np.array(
        [t + [pad_id] * (max_len - len(t)) for t in tokens], dtype=np.int32
    )


def predict_features_lens(
    prompt_features_lens: np.ndarray,
    prompt_tokens_lens: np.ndarray,
    tokens_lens: np.ndarray,
    speed: float = 1.0,
) -> np.ndarray:
    """Duration prediction by token-count ratio (host-side numpy)."""
    extra = np.ceil(
        prompt_features_lens / np.maximum(prompt_tokens_lens, 1) * tokens_lens / speed
    ).astype(np.int64)
    return prompt_features_lens + extra


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def forward_fm_decoder(
    model: ZipVoiceModel,
    t,
    xt: torch.Tensor,
    text_condition: torch.Tensor,
    speech_condition: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    ctx: Optional[TrainCtx] = None,
    guidance_scale=None,
) -> torch.Tensor:
    """Velocity prediction at timestep t (a float, or a tensor of B
    values); xt and the conditions: (B, T, F).  xt may ride in f32 (f32
    Euler state) while the backbone runs at the conditions' dtype.
    guidance_scale (the distill variant's embedded scale): None, a float or
    a tensor of B values."""
    x = torch.cat([xt.to(text_condition.dtype), text_condition, speech_condition],
                  dim=-1)
    b = x.shape[0]
    # t and the scale stay f32 (the sinusoidal embeddings need full
    # precision); a float is filled on the device, with no host-to-device copy
    t = _per_row_f32(t, b, x.device)
    if guidance_scale is not None:
        guidance_scale = _per_row_f32(guidance_scale, b, x.device)
    return tts_zipformer_forward(model.fm_decoder, x, t, padding_mask,
                                 guidance_scale=guidance_scale, ctx=ctx)


def _per_row_f32(value, b: int, device) -> torch.Tensor:
    """A float or a tensor of 1 or B values -> (B,) f32 on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32).reshape(-1).expand(b)
    return torch.full((b,), float(value), dtype=torch.float32, device=device)


def forward_text_embed(model: ZipVoiceModel, tokens_padded: torch.Tensor,
                       tokens_lens: torch.Tensor, dtype=torch.float32,
                       ctx: Optional[TrainCtx] = None) -> torch.Tensor:
    """Token embedding + text encoder: (B, S) ids -> (B, S, feat_dim)."""
    embed = model.embed.weight.to(dtype)[tokens_padded.long()]
    mask = make_pad_mask(tokens_lens, tokens_padded.shape[1])
    return tts_zipformer_forward(model.text_encoder, embed, None, mask, ctx=ctx)


def average_duration_token_index(tokens_lens: torch.Tensor,
                                 features_lens: torch.Tensor,
                                 num_frames: int) -> torch.Tensor:
    """Uniform-duration frame -> token index map, (B, num_frames) int64:
    token i covers frames [i*avg, (i+1)*avg) with avg = features_len //
    tokens_len; leftover frames point at index tokens_len (the extra pad
    appended by pad_labels)."""
    tokens_lens = tokens_lens.long()
    avg = features_lens.long() // torch.clamp(tokens_lens, min=1)
    frames = torch.arange(num_frames, device=tokens_lens.device)[None, :]
    idx = frames // torch.clamp(avg, min=1)[:, None]
    idx = torch.minimum(idx, tokens_lens[:, None])
    # degenerate avg == 0: every frame maps to the trailing pad embedding
    return torch.where((avg == 0)[:, None], tokens_lens[:, None], idx)


def forward_text_condition(embed: torch.Tensor, tokens_lens: torch.Tensor,
                           features_lens: torch.Tensor,
                           num_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand token embeddings (B, S, F) to frame rate: ((B, T, F), (B, T)
    padding mask)."""
    padding_mask = make_pad_mask(features_lens, num_frames)
    idx = average_duration_token_index(tokens_lens, features_lens, num_frames)
    # clamp to S so a caller that padded exactly to tokens_lens gets the
    # last embedding instead of an out-of-bounds gather
    idx = torch.clamp(idx, max=embed.shape[1] - 1)
    text_condition = torch.gather(
        embed, 1, idx[:, :, None].expand(-1, -1, embed.shape[-1])
    )
    return text_condition, padding_mask


def forward_text_train(model: ZipVoiceModel, tokens_padded, tokens_lens, features_lens,
                       num_frames: int, dtype=torch.float32,
                       ctx: Optional[TrainCtx] = None):
    """Text encoder then the frame-rate expansion: ((B, T, F), (B, T) mask)."""
    embed = forward_text_embed(model, tokens_padded, tokens_lens, dtype, ctx=ctx)
    return forward_text_condition(embed, tokens_lens, features_lens, num_frames)


def condition_time_mask(features_lens: torch.Tensor, max_len: int,
                        generator: torch.Generator,
                        mask_percent: Tuple[float, float] = (0.7, 1.0)) -> torch.Tensor:
    """Random interior span of each utterance, (B, max_len) bool, True =
    masked: a span of U(mask_percent) of its frames at a uniform start."""
    b = features_lens.shape[0]
    dev = features_lens.device
    fl = features_lens.float()
    lo, hi = mask_percent
    u = torch.rand((b,), generator=generator, device=dev)
    size = ((lo + u * (hi - lo)) * fl).to(torch.int32)
    start = (torch.rand((b,), generator=generator, device=dev)
             * (fl - size.float())).to(torch.int32)
    seq = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :]
    return (seq >= start[:, None]) & (seq < (start + size)[:, None])


def loss_seq_mesh(model: nn.Module, num_frames: int) -> Optional[Mesh]:
    """The active mesh (``parallel/mesh.use_mesh``) when a seq axis of it
    splits the frames, its frame count checked against the fm_decoder
    (``check_sp_frames``); None otherwise."""
    mesh = active_mesh()
    if mesh is None or mesh.size("seq") == 1:
        return None
    check_sp_frames(model.fm_decoder.cfg, num_frames, mesh.size("seq"))
    return mesh


def seq_replicated_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters whose forward runs whole on every rank of a seq group:
    everything outside the fm_decoder (the token and speaker embeddings,
    the text encoder), whose frame-rate output each rank slices.  The
    fm_decoder's run on a rank's frames.  ``parallel/mesh.
    all_reduce_gradients`` averages the former over the seq group and sums
    the latter."""
    return [p for name, p in model.named_parameters() if not name.startswith("fm_decoder.")]


def compute_fm_loss(
    model: ZipVoiceModel,
    tokens_padded: torch.Tensor,
    tokens_lens: torch.Tensor,
    features: torch.Tensor,
    features_lens: torch.Tensor,
    noise: torch.Tensor,
    t: torch.Tensor,
    seed: int,
    condition_drop_ratio: float = 0.0,
    schedules: Optional[dict] = None,
) -> torch.Tensor:
    """Conditional flow-matching MSE on the velocity.

    features / noise: (B, T, F) in the compute dtype; t: (B, 1, 1) in (0, 1),
    f32.  ``seed`` seeds the condition mask, the text-condition drop and,
    with ``schedules`` ({"fm_decoder": ..., "text_encoder": ...} from
    train/schedules.zipvoice_schedules), the backbones' training contexts;
    the per-row draws take the rank's fold of it (``parallel/mesh``).
    Returns the sum over this rank's masked, non-padded positions divided
    by their count over every rank, f32: the mean over the global batch
    once summed over the ranks (the mean itself in one process).

    Under a mesh with a seq axis (``parallel/mesh.make_dp_sp_mesh``, the
    step's ``use_mesh``) every rank of a seq group passes the same whole
    rows: the text encoder, its frame-rate condition, the condition mask
    and the padding mask are computed whole (the draws from the data
    index's fold, so the ranks agree), then each rank takes its T / n frames
    of them and of features, noise (``scatter_frames``: the text
    condition's cotangent gathered back in the backward) and runs the
    fm_decoder on them (``nn/zipformer.sequence_parallel``).  T must pass
    ``check_sp_frames``."""
    num_frames = features.shape[1]
    seq = loss_seq_mesh(model, num_frames)
    dev = features.device
    seeds = np.random.default_rng(seed).integers(0, 2**62, size=4)
    text_ctx = fm_ctx = None
    if schedules is not None:  # a backbone whose schedule is None runs without one
        if schedules["text_encoder"] is not None:
            text_ctx = TrainCtx(int(seeds[2]), schedules["text_encoder"], dev)
        if schedules["fm_decoder"] is not None:
            fm_ctx = TrainCtx(int(seeds[3]), schedules["fm_decoder"], dev)
    text_condition, padding_mask = forward_text_train(
        model, tokens_padded, tokens_lens, features_lens, num_frames,
        dtype=features.dtype, ctx=text_ctx)
    gen = torch.Generator(device=dev)
    speech_condition_mask = condition_time_mask(features_lens, num_frames,
                                                gen.manual_seed(fold_rank(seeds[0])))
    speech_condition = features.masked_fill(speech_condition_mask[:, :, None], 0.0)
    if condition_drop_ratio > 0.0:
        drop = torch.rand((features.shape[0], 1, 1),
                          generator=gen.manual_seed(fold_rank(seeds[1])), device=dev)
        text_condition = text_condition * (drop > condition_drop_ratio).to(text_condition.dtype)
    loss_mask = speech_condition_mask & ~padding_mask
    if seq is not None:  # this rank's frames
        text_condition = scatter_frames(text_condition, seq)
        speech_condition, padding_mask, loss_mask, features, noise = (
            scatter_frames(x, seq) for x in (speech_condition, padding_mask, loss_mask,
                                             features, noise))
    # mix in the features' compute dtype (t is drawn in f32 and must not
    # promote x_t to f32)
    tm = t.to(features.dtype)
    xt = features * tm + noise * (1.0 - tm)
    ut = features - noise
    with contextlib.nullcontext() if seq is None else sequence_parallel(seq):
        vt = forward_fm_decoder(model, t, xt, text_condition, speech_condition, padding_mask,
                                ctx=fm_ctx)
    w = loss_mask[:, :, None].float()
    se = torch.square((vt - ut).float()) * w
    return torch.sum(se) / torch.clamp(global_sum(torch.sum(w)) * features.shape[-1],
                                       min=1.0)


def sample(
    model: ZipVoiceModel,
    tokens_padded: torch.Tensor,
    tokens_lens: torch.Tensor,
    prompt_features: torch.Tensor,
    prompt_features_lens: torch.Tensor,
    features_lens: torch.Tensor,
    noise: torch.Tensor,
    num_step: int = 16,
    guidance_scale: float = 1.0,
    t_shift: float = 1.0,
    distill: bool = False,
    timesteps=None,
) -> torch.Tensor:
    """Generate mel features for concatenated prompt+target tokens.

    prompt_features: (B, T, F) prompt mel zero-padded to the full frame
    count T; features_lens: (B,) total frames (prompt + generated); noise:
    (B, T, F) standard normal.  Returns the full (B, T, F) features at t=1;
    the caller strips the prompt region and the padding.  ``distill``: the
    distill variant's sampler (the scale embedded, no CFG batch)."""
    embed = forward_text_embed(model, tokens_padded, tokens_lens,
                               dtype=prompt_features.dtype)
    return sample_from_embed(model, embed, tokens_lens, prompt_features,
                             prompt_features_lens, features_lens, noise, num_step=num_step,
                             guidance_scale=guidance_scale, t_shift=t_shift,
                             distill=distill, timesteps=timesteps)


def sample_from_embed(model: ZipVoiceModel, embed: torch.Tensor, tokens_lens,
                      prompt_features, prompt_features_lens, features_lens, noise,
                      num_step: int = 16, guidance_scale: float = 1.0,
                      t_shift: float = 1.0, distill: bool = False,
                      timesteps=None) -> torch.Tensor:
    """``sample`` from the text encoder's output (B, S, F) onwards."""
    from zipvoice_tpu_torch.sampling.euler import euler_sample

    text_condition, speech_condition, padding_mask = _sample_conditions(
        embed, tokens_lens, prompt_features, prompt_features_lens, features_lens)
    return euler_sample(
        model, noise, text_condition, speech_condition, padding_mask,
        num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift,
        distill=distill, timesteps=timesteps,
    )


def _sample_conditions(embed, tokens_lens, prompt_features, prompt_features_lens,
                       features_lens):
    """The sampler's frame-rate conditions: (text condition, speech
    condition: the prompt region of prompt_features, zero elsewhere, padding
    mask), each over prompt_features' T frames."""
    num_frames = prompt_features.shape[1]
    text_condition, padding_mask = forward_text_condition(
        embed, tokens_lens, features_lens, num_frames
    )
    prompt_mask = make_pad_mask(prompt_features_lens, num_frames)
    speech_condition = prompt_features.masked_fill(prompt_mask[:, :, None], 0.0)
    return text_condition, speech_condition, padding_mask


@torch.no_grad()
def sp_sample(
    model: ZipVoiceModel,
    mesh: Mesh,
    tokens_padded: torch.Tensor,
    tokens_lens: torch.Tensor,
    prompt_features: torch.Tensor,
    prompt_features_lens: torch.Tensor,
    features_lens: torch.Tensor,
    noise: torch.Tensor,
    num_step: int = 16,
    guidance_scale: float = 1.0,
    t_shift: float = 1.0,
    distill: bool = False,
    timesteps=None,
) -> torch.Tensor:
    """``sample`` with the frame axis sharded over the ``seq`` axis of
    ``mesh`` (``parallel/mesh.make_seq_mesh``): the JAX package's
    ``sp_sample_jit``, its route to single utterances longer than the 30 s
    cap.  Every rank passes the full inputs and gets the full (B, T, F)
    output.  The text encoder and the frame-rate conditions run replicated;
    the fm_decoder and the Euler steps run on the rank's T / n frames
    (``nn/zipformer.sequence_parallel``), gathered once at the end.  T must
    be a multiple of n times the fm_decoder's largest downsampling factor,
    and every rank's frames must cover each stack's convolution halo
    (``check_sp_frames``).  Without gradient, unfused; the training step's
    counterpart is ``compute_fm_loss`` under a data x seq mesh."""
    from zipvoice_tpu_torch.sampling.euler import euler_sample

    n, i = mesh.size("seq"), mesh.index["seq"]
    num_frames = prompt_features.shape[1]
    check_sp_frames(model.fm_decoder.cfg, num_frames, n)
    embed = forward_text_embed(model, tokens_padded, tokens_lens,
                               dtype=prompt_features.dtype)
    conditions = _sample_conditions(embed, tokens_lens, prompt_features,
                                    prompt_features_lens, features_lens)
    rows = slice(i * num_frames // n, (i + 1) * num_frames // n)
    text_condition, speech_condition, padding_mask = (c[:, rows] for c in conditions)
    with sequence_parallel(mesh):
        x = euler_sample(
            model, noise[:, rows], text_condition, speech_condition, padding_mask,
            num_step=num_step, guidance_scale=guidance_scale, t_shift=t_shift,
            distill=distill, timesteps=timesteps,
        )
    return gather_frames(x, mesh)
