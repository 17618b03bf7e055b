"""The pipeline's captured programs (utils/graphs.py) on the card: a replay
equals the eager run of the captured function bit for bit, in f32 and
bf16, unfused and with the fused eval path; two threads replaying one key
get their serial results; the launch counters count device launches; a
warmed key captures nothing at request time; a failed capture raises.
Marked ``cuda``: without a CUDA card every test skips.  On a machine with
one (and nvcc), run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos, load_vocos_params
from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig
from zipvoice_tpu_torch.models.pipeline import ZipVoicePipeline
from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
from zipvoice_tpu_torch.nn import zipformer as zf
from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer, write_token_file
from zipvoice_tpu_torch.utils.graphs import GraphKey, GraphSet, launch_counters

pytestmark = pytest.mark.cuda

CHARS = "_ abcdefghijklmnopqrstuvwxyz"
TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1), fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9), fm_decoder_feedforward_dim=128,
    fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=1,
    text_encoder_feedforward_dim=64, text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32, text_embed_dim=48,
    query_head_dim=8, value_head_dim=8, pos_head_dim=4, pos_dim=48, feat_dim=20,
)
TINY_VOCOS = dict(input_channels=20, dim=32, intermediate_dim=64, num_layers=2)
# half the published widths, every U-net stack
MID = dict(fm_decoder_num_layers=(1, 1, 2, 1, 1), fm_decoder_feedforward_dim=768,
           fm_decoder_dim=256, text_encoder_num_layers=2, text_encoder_dim=128,
           text_encoder_feedforward_dim=256)
MID_VOCOS = dict(dim=256, intermediate_dim=768, num_layers=4)


def _pipeline(tmp_path, width="tiny", dtype=torch.float32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    write_token_file({c: i for i, c in enumerate(CHARS)}, str(tmp_path / "tokens.txt"))
    tokenizer = SimpleTokenizer(str(tmp_path / "tokens.txt"))
    model_kw, vocos_kw = (TINY, TINY_VOCOS) if width == "tiny" else (MID, MID_VOCOS)
    cfg = ZipVoiceConfig(**model_kw, vocab_size=len(CHARS), pad_id=0)
    vcfg = VocosConfig(**vocos_kw)
    return ZipVoicePipeline(
        model=init_zipvoice(cfg, torch.Generator().manual_seed(0)), model_cfg=cfg,
        feat_cfg=FeatureConfig(n_mels=cfg.feat_dim),
        vocos_params=load_vocos_params(init_vocos(vcfg, torch.Generator().manual_seed(1))),
        vocos_cfg=vcfg, tokenizer=tokenizer, dtype=dtype, device="cuda",
        token_bucket=8, frame_bucket=32)


def _prompt(seed=0, seconds=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, int(24000 * seconds))) * 0.05).astype(np.float32)


def _inputs(p, seed=7, text="hello world"):
    tok = p.tokenizer.texts_to_token_ids
    pf, _ = p.prompt_features(_prompt(), 24000)
    return p._prepare_sample_inputs(tok([text])[0], tok(["hi there"])[0], pf, 1.0, seed)


def _counts():
    return [c.launches for c in launch_counters().values()]


class _Fused:
    def __enter__(self):
        zf.set_fused_eval(True)
        zf.set_fused_conv(True)

    def __exit__(self, *exc):
        zf.set_fused_eval(False)
        zf.set_fused_conv(False)


@pytest.mark.parametrize("width", ["tiny", "mid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
def test_replay_equals_eager(tmp_path, width, dtype, fused):
    """Tolerance: none.  A replay launches the captured kernels with the
    captured arguments on the same inputs, and no kernel of the path uses
    atomics, so the sampler's mel and the one-program PCM16 equal the eager
    run of the captured function bit for bit."""
    p = _pipeline(tmp_path, width, dtype)
    s = _inputs(p)
    with _Fused() if fused else contextlib.nullcontext():
        for prog in (p._sample_fn(4, 1.0, 0.5), p._sample_pcm_fn(4, 1.0, 0.5)):
            first = prog(*s.args)  # eager, then captured
            replayed = prog(*s.args)
            with torch.no_grad():
                eager = prog.fn(*s.args)
            assert torch.equal(first, eager) and torch.equal(replayed, eager)
            assert prog.key(s.args).flags == (fused, fused)
    assert p.captures == 2


def test_fused_flags_key_separate_graphs(tmp_path):
    p = _pipeline(tmp_path, "tiny", torch.bfloat16)
    s = _inputs(p)
    prog = p._sample_fn(4, 1.0, 0.5)
    plain = prog(*s.args)
    with _Fused():
        fused = prog(*s.args)
        assert torch.equal(prog(*s.args), fused)
    assert p.captures == 2 and torch.equal(prog(*s.args), plain)
    assert {k.flags for k in p.graphs.keys()} == {(False, False), (True, True)}


def test_two_threads_replaying_one_key_get_serial_results(tmp_path):
    p = _pipeline(tmp_path)
    prog = p._sample_pcm_fn(4, 1.0, 0.5)
    inputs = [_inputs(p, seed) for seed in (1, 2)]
    serial = [prog(*s.args).cpu() for s in inputs]  # the first also captures
    assert torch.equal(prog(*inputs[0].args).cpu(), serial[0])
    results = {0: [], 1: []}

    def work(i):
        for _ in range(20):
            results[i].append(prog(*inputs[i].args).cpu())

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for i in (0, 1):
        assert len(results[i]) == 20
        assert all(torch.equal(r, serial[i]) for r in results[i])
    assert p.captures == 1


def test_launch_counters_count_device_launches(tmp_path):
    """The first call counts its eager launches and the capture none; every
    replay adds the eager counts again."""
    p = _pipeline(tmp_path)
    s = _inputs(p)
    prog = p._sample_fn(4, 1.0, 0.5)
    c0 = _counts()
    with torch.no_grad():
        prog.fn(*s.args)
    eager = [b - a for a, b in zip(c0, _counts())]
    assert sum(eager) > 0
    c1 = _counts()
    prog(*s.args)  # eager + capture
    assert [b - a for a, b in zip(c1, _counts())] == eager and p.captures == 1
    for n in (1, 2):
        c = _counts()
        prog(*s.args)
        assert [b - a for a, b in zip(c, _counts())] == eager


def test_warmed_key_makes_no_capture(tmp_path):
    p = _pipeline(tmp_path)
    p.warmup(num_step=4, seconds=(0.5,), token_counts=(4,), batch_sizes=(2,))
    warmed = p.captures
    assert warmed == 5  # sample 1 and 2, vocoder 1 and 2, sample_pcm 1
    rng = np.random.default_rng(1)
    tokens = list(rng.integers(1, len(CHARS), 4))
    pf = rng.standard_normal((11, 20)).astype(np.float32) * 0.01
    mel, gen_len = p.sample_features(tokens, tokens[:1], pf, num_step=4)
    p.vocode(mel, gen_len)
    pcm = p._sample_pcm_fn(4, 1.0, 0.5)(
        *p._prepare_sample_inputs(tokens, tokens[:1], pf, 1.0, 3).args)
    assert p.captures == warmed and pcm.shape[0] == 1


def test_capture_failure_raises(tmp_path):
    """A host sync inside the captured function: the eager first run works,
    the capture fails, and the call raises instead of returning the eager
    result; so does the next call, and other keys still capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graphs = GraphSet(torch.device("cuda"))
    x = torch.arange(8.0, device="cuda")
    key = GraphKey("sync", (), ((tuple(x.shape), x.dtype),), ())
    calls = []

    def fn(t):
        calls.append(1)
        return t * float(t.sum().item())

    for _ in range(2):
        with pytest.raises(RuntimeError):
            graphs.run(key, fn, (x,))
    assert graphs.captures == 0 and len(calls) == 4  # eager + capture attempt, twice
    # the set still captures and replays other keys
    ok = GraphKey("ok", (), key.inputs, ())
    assert graphs.run(ok, lambda t: 2 * t + 1, (x,)).tolist() == (2 * x + 1).tolist()
    assert graphs.run(ok, lambda t: 2 * t + 1, (x + 1,)).tolist() == (2 * x + 3).tolist()
    assert graphs.captures == 1
