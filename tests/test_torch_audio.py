"""zipvoice_tpu_torch.audio against zipvoice_tpu.audio on the CPU, f32,
within 1e-5: the Vocos log-mel, the feature extractor (also bucketed ==
unbucketed, as the pipeline runs it), the ISTFT and the Vocos decoder."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zipvoice_tpu.audio import mel as jmel
from zipvoice_tpu.audio import stft as jstft
from zipvoice_tpu.audio import vocos as jvocos
from zipvoice_tpu.config import FeatureConfig as JFeatureConfig
from zipvoice_tpu_torch.audio import mel as tmel
from zipvoice_tpu_torch.audio import stft as tstft
from zipvoice_tpu_torch.audio import vocos as tvocos
from zipvoice_tpu_torch.config import FeatureConfig

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5


def _wav(n, seed=0, channels=1):
    return (np.random.default_rng(seed).standard_normal((channels, n)) * 0.1).astype(
        np.float32)


def _err(ref, out):
    return float(np.abs(np.asarray(ref, np.float64)
                        - out.detach().numpy().astype(np.float64)).max())


@pytest.mark.parametrize("n", [6000, 7777])
def test_vocos_log_mel_matches_jax(n):
    wav = _wav(n, seed=n)
    ref = jmel.vocos_log_mel(jnp.asarray(wav), JFeatureConfig())
    out = tmel.vocos_log_mel(torch.from_numpy(wav), FeatureConfig())
    assert _err(ref, out) < TOL


@pytest.mark.parametrize("channels", [1, 2])
def test_extract_features_matches_jax(channels):
    wav = _wav(9000, seed=1, channels=channels)
    ref = jmel.extract_features(wav, JFeatureConfig())
    out = tmel.extract_features(torch.from_numpy(wav), FeatureConfig())
    assert out.shape == tuple(ref.shape)
    assert _err(ref, out) < TOL


def test_extract_features_bucketed_equals_unbucketed():
    """The pipeline's prompt path: reflect-pad on the host, right zeros to a
    128-frame bucket, pre_padded STFT, crop to the true frame count."""
    cfg = FeatureConfig()
    wav = _wav(24000 * 3 + 77, seed=2)
    n = wav.shape[-1]
    pad = tmel.stft_pad_amount(cfg)
    bucket = cfg.hop_length * 128
    wav_p = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    wav_p = np.pad(wav_p, ((0, 0), (0, -(-n // bucket) * bucket - n)))
    bucketed = tmel.extract_features(torch.from_numpy(wav_p), cfg, pre_padded=True)
    bucketed = bucketed[: tmel.compute_num_frames(n, cfg.hop_length)]
    plain = tmel.extract_features(torch.from_numpy(wav), cfg)
    assert bucketed.shape == plain.shape
    assert float((bucketed - plain).abs().max()) < TOL


def test_istft_matches_jax():
    r = np.random.default_rng(3)
    n_fft, hop = 64, 16
    re = r.standard_normal((2, 11, n_fft // 2 + 1)).astype(np.float32)
    im = r.standard_normal((2, 11, n_fft // 2 + 1)).astype(np.float32)
    ref = jstft.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop,
                      jstft.hann_window(n_fft))
    out = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop)
    assert out.shape == (2, 10 * hop)
    assert _err(ref, out) < TOL


def test_vocos_decode_matches_jax():
    """Port weights in the published layout; the JAX package loads the same
    state_dict through its own loader."""
    cfg = tvocos.VocosConfig(input_channels=20, dim=32, intermediate_dim=64,
                             num_layers=2, n_fft=64, hop_length=16)
    sd = tvocos.init_vocos(cfg, torch.Generator().manual_seed(0))
    assert tvocos.vocos_config_from_params(sd, 16) == cfg
    jparams = jvocos.load_vocos_params({k: v.numpy() for k, v in sd.items()})
    jcfg = jvocos.VocosConfig(input_channels=20, dim=32, intermediate_dim=64,
                              num_layers=2, n_fft=64, hop_length=16)
    mel = np.random.default_rng(4).standard_normal((2, 25, 20)).astype(np.float32)
    ref = jvocos.vocos_decode(jparams, jnp.asarray(mel), jcfg)
    out = tvocos.vocos_decode(tvocos.load_vocos_params(sd), torch.from_numpy(mel), cfg)
    assert out.shape == (2, 24 * 16)
    assert _err(ref, out) < TOL
