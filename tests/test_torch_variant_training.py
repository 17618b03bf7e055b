"""The variants' training in the port against the JAX package on the CPU, f32,
at tests/test_variants.py's tiny widths (one layer a stack): the distill
loss of both stages and its gradients, the EMA update, the dialog loss mono
and stereo (with the energy penalty, on ties too), the checkpoint surgery,
one distill step and one dialog step (JAX's gradients through the port's
ScaledAdam, which test_torch_regularizers.py holds to JAX's), and the
averaging CLI.  The random
draws (noise, guidance scales, t, the condition masks) are pinned on both
sides with ``monkeypatch``; JAX weights reach the port through
``from_jax_params``.  Then the four new CLIs run the recipes' chains on the
CPU (distill stage 1 -> average -> stage 2 -> average; dialog -> average ->
stereo -> average) over one module-scoped corpus and base checkpoint.

Tolerances: losses within 1e-5 relative; gradients and one step's updates
within 1e-4 relative L2 a tensor (f32 sums in another order; ScaledAdam's
first update is sign(g) times the tensor's RMS, so a tensor's update
follows its gradient's error)."""

import copy
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_tpu.config import ZipVoiceConfig as JConfig
from zipvoice_tpu.io.checkpoint import params_to_state_dict, state_dict_to_params
from zipvoice_tpu.models import dialog as jdialog
from zipvoice_tpu.models import distill as jdistill
from zipvoice_tpu.models import zipvoice as jzv
from zipvoice_tpu.train import distill_step as jdstep
from zipvoice_tpu_torch.audio.wav import write_wav
from zipvoice_tpu_torch.config import ZipVoiceConfig
from zipvoice_tpu_torch.io.checkpoint import from_jax_params, load_into
from zipvoice_tpu_torch.models import dialog as tdialog
from zipvoice_tpu_torch.models import distill as tdistill
from zipvoice_tpu_torch.models import zipvoice as tzv
from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
from zipvoice_tpu_torch.text.tokenizer import write_token_file
from zipvoice_tpu_torch.train import checkpoint as tckpt
from zipvoice_tpu_torch.train import distill_step as tdstep
from zipvoice_tpu_torch.train import step as tstep
from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 1),
    fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(9, 7, 9),
    fm_decoder_feedforward_dim=128,
    fm_decoder_num_heads=2,
    fm_decoder_dim=64,
    text_encoder_num_layers=1,
    text_encoder_feedforward_dim=64,
    text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=2,
    text_encoder_dim=48,
    time_embed_dim=32,
    text_embed_dim=48,
    query_head_dim=8,
    value_head_dim=8,
    pos_head_dim=4,
    pos_dim=48,
    feat_dim=20,
)
F = TINY["feat_dim"]
VOCAB = 30
SPK_A, SPK_B = 28, 29
TRIPLE = (np.float32(0.3), np.float32(0.2), np.float32(0.15))
DISTILL_KEY = jax.random.PRNGKey(3)


def _configs(distill=False):
    j = JConfig(**TINY, vocab_size=VOCAB, pad_id=0)
    t = ZipVoiceConfig(**TINY, vocab_size=VOCAB, pad_id=0)
    if distill:
        return jdistill.distill_config(j), tdistill.distill_config(t)
    return j, t


def _model(kind: str, seed: int):
    """(JAX tree, port module from that tree) with seeded port weights:
    "base", "distill", "dialog" or "stereo"."""
    _, cfg = _configs()
    g = torch.Generator().manual_seed(seed)
    if kind in ("base", "distill"):
        m = tzv.init_zipvoice(tdistill.distill_config(cfg) if kind == "distill" else cfg, g)
    else:
        m = tdialog.init_zipvoice_dialog(cfg, stereo=kind == "stereo", generator=g)
    tree = jax.tree.map(jnp.asarray, state_dict_to_params(
        {k: v.numpy() for k, v in m.state_dict().items()}))
    with torch.device("meta"):
        fresh = (tdialog.ZipVoiceDialogModel(m.cfg, stereo=kind == "stereo")
                 if kind in ("dialog", "stereo") else tzv.ZipVoiceModel(m.cfg))
    return tree, load_into(fresh, from_jax_params(tree))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _by_name(jtree):
    return {k: v.numpy() for k, v in from_jax_params(_np(jtree)).items()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(a)),
                                              float(np.linalg.norm(b)), 1e-12)


def _batch(width=F, b=2, t=24, s=9, seed=0, dialog=False):
    r = np.random.default_rng(seed)
    tokens = r.integers(1, 28, size=(b, s + 1)).astype(np.int64)
    if dialog:
        tokens[:, 0], tokens[:, 4], tokens[0, 7] = SPK_A, SPK_B, SPK_A
    tokens_lens = np.array([s, s - 3])
    tokens[1, s - 3:] = 0
    tokens[:, -1] = 0
    features = (r.standard_normal((b, t, width)) * 0.5).astype(np.float32)
    features_lens = np.array([t, t - 5])
    cond = np.zeros((b, t), bool)
    cond[0, 5:20] = True
    cond[1, 8:19] = True
    return tokens, tokens_lens, features, features_lens, cond


def _assert_ulps(a, b, name):
    """Within f32 rounding of one multiply-add (the compiled JAX reference
    fuses what the port rounds twice): 1e-6 relative."""
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12, err_msg=name)


def _pin_mask(monkeypatch, jmod, tmod, name, cond):
    monkeypatch.setattr(jmod, name, lambda *a, **k: jnp.asarray(cond))
    monkeypatch.setattr(tmod, name, lambda *a, **k: torch.from_numpy(cond))


def _jax_distill_draws(key, shape, stage):
    """compute_distill_loss's noise and guidance scales from its key."""
    k_noise, k_gs, _ = jax.random.split(key, 3)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    gs = jax.random.uniform(k_gs, (shape[0], 1, 1)) * 2.0 + (0.0 if stage == "first" else 1.0)
    return torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(gs, np.float32))


def _distill_pair(stage):
    """(student tree, teacher tree, student module, teacher module, student
    JAX config, teacher JAX config): stage first's teacher is a base model
    on the CFG path, stage second's a distill model (the EMA)."""
    sp, student = _model("distill", 1)
    tp, teacher = _model("base" if stage == "first" else "distill", 2)
    jcfg, _ = _configs(distill=True)
    return sp, tp, student, teacher, jcfg


@functools.lru_cache(maxsize=None)
def _jax_distill(stage):
    """JAX's (loss, ref_loss) and gradients of the student for the pinned
    inputs of ``stage``, compiled once for the loss and the step tests."""
    sp, tp, _, _, jcfg = _distill_pair(stage)
    tokens, tl, feats, fl, cond = _batch()
    orig = jzv.condition_time_mask
    jzv.condition_time_mask = lambda *a, **k: jnp.asarray(cond)
    try:
        def jloss(fm):  # the fm_decoder's gradients: the only ones that train
            return jdistill.compute_distill_loss(
                dict(sp, fm_decoder=fm), tp, jcfg, *map(jnp.asarray, (tokens, tl, feats, fl)),
                DISTILL_KEY, *TRIPLE, stage=stage)

        (jl, jref), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(sp["fm_decoder"])
    finally:
        jzv.condition_time_mask = orig
    return float(jl), float(jref), _by_name({"fm_decoder": jg})


def _pin_distill(monkeypatch, stage):
    """The port's distill inputs with JAX's draws pinned: (student,
    teacher, batch dict)."""
    _, _, student, teacher, _ = _distill_pair(stage)
    tokens, tl, feats, fl, cond = _batch()
    _pin_mask(monkeypatch, jzv, tzv, "condition_time_mask", cond)
    draws = _jax_distill_draws(DISTILL_KEY, feats.shape, stage)
    monkeypatch.setattr(tdistill, "draw_noise_and_scale", lambda *a: draws)
    batch = {"tokens": tokens, "tokens_lens": tl, "features": feats, "features_lens": fl}
    return student, teacher, batch


@pytest.mark.parametrize("stage", ["first", "second"])
def test_compute_distill_loss_matches_jax(monkeypatch, stage):
    """Loss, ref_loss and the fm_decoder's gradients (the student's other
    parameters get none: its text encoder runs without autograd)."""
    student, teacher, batch = _pin_distill(monkeypatch, stage)
    jl, jref, ref = _jax_distill(stage)
    loss, ref_loss = tdistill.compute_distill_loss(
        student, teacher, *map(torch.from_numpy, batch.values()), 0, *TRIPLE, stage=stage)
    loss.backward()
    assert abs(float(loss.detach()) - jl) <= 1e-5 * jl
    assert abs(float(ref_loss) - jref) <= 1e-5 * jref
    for name, q in student.named_parameters():
        if name.startswith("fm_decoder."):
            assert _rel_l2(q.grad.numpy(), ref[name]) < 1e-4, name
        else:
            assert q.grad is None, name
    assert all(q.grad is None for q in teacher.parameters())


def test_ema_update_and_t_schedule_match_jax():
    sp, student = _model("distill", 1)
    tp, teacher = _model("distill", 2)
    ref = _by_name(jax.jit(jdistill.ema_update, static_argnums=2)(tp, sp, 0.9999))
    tdistill.ema_update(teacher, student, 0.9999)
    for name, q in teacher.named_parameters():
        _assert_ulps(q.detach().numpy(), ref[name], name)
    for seed in range(3):
        assert tdstep.draw_t_schedule(np.random.default_rng(seed)) == \
            jdstep.draw_t_schedule(np.random.default_rng(seed))


@pytest.mark.parametrize("distill,num_step", [(True, 2), (False, 1)])
def test_sample_intermediate_matches_jax(distill, num_step):
    """Integration from t=0.2 to 0.7 on ground-truth conditioning: the
    distill path with no scale given embeds 0.0 (not nothing), the CFG
    path takes a float scale."""
    params, model = _model("distill" if distill else "base", 9)
    jcfg = _configs(distill=distill)[0]
    tokens, tl, feats, fl, cond = _batch(seed=4)
    noise = np.random.default_rng(5).standard_normal(feats.shape).astype(np.float32)
    kw = dict(t_start=0.2, t_end=0.7, num_step=num_step, distill=distill,
              guidance_scale=None if distill else 1.5)
    ref = jax.jit(lambda p, *a: jdistill.sample_intermediate(p, jcfg, *a, **kw))(
        params, *map(jnp.asarray, (tokens, tl, feats, fl, noise, cond)))
    with torch.no_grad():
        out = tdistill.sample_intermediate(model, *map(torch.from_numpy, (
            tokens, tl, feats, fl, noise, cond)), **kw)
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) < 1e-4


DIALOG_T = np.array([0.35, 0.8], np.float32).reshape(2, 1, 1)


def _dialog_inputs(stereo):
    tokens, tl, feats, fl, cond = _batch(2 * F if stereo else F, dialog=True)
    noise = np.random.default_rng(9).standard_normal(feats.shape).astype(np.float32)
    return (tokens, tl, feats, fl, noise, DIALOG_T), cond


@functools.lru_cache(maxsize=None)
def _jax_dialog(stereo):
    """JAX's dialog loss and gradients on the pinned inputs (compiled once
    for the loss and the step tests)."""
    params, _ = _model("stereo" if stereo else "dialog", 4)
    jcfg, _ = _configs()
    arrays, cond = _dialog_inputs(stereo)
    orig = jdialog.condition_time_mask_suffix
    jdialog.condition_time_mask_suffix = lambda *a, **k: jnp.asarray(cond)
    try:
        def jloss(p):
            return jdialog.compute_fm_loss_dialog(
                p, jcfg, *map(jnp.asarray, arrays), jax.random.PRNGKey(0),
                se_weight=1.0 if stereo else 0.0, stereo=stereo)

        jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    finally:
        jdialog.condition_time_mask_suffix = orig
    return float(jl), _by_name(jg)


@pytest.mark.parametrize("stereo", [False, True])
def test_compute_fm_loss_dialog_matches_jax(monkeypatch, stereo):
    """The suffix-masked dialog loss and every gradient; stereo: 2F
    features through stream 0 with the energy penalty (se_weight 1)."""
    _, model = _model("stereo" if stereo else "dialog", 4)
    arrays, cond = _dialog_inputs(stereo)
    _pin_mask(monkeypatch, jdialog, tdialog, "condition_time_mask_suffix", cond)
    jl, ref = _jax_dialog(stereo)
    loss = tdialog.compute_fm_loss_dialog(model, *map(torch.from_numpy, arrays), 0,
                                          se_weight=1.0 if stereo else 0.0, stereo=stereo)
    loss.backward()
    assert abs(float(loss.detach()) - jl) <= 1e-5 * jl
    for name, q in model.named_parameters():
        if q.grad is None:  # the stream the objective does not take
            assert stereo and ".1." in name and not ref[name].any(), name
            continue
        assert _rel_l2(q.grad.numpy(), ref[name]) < 1e-4, name


def test_energy_based_loss_matches_jax_on_ties():
    """The median threshold is the 0.5 quantile with linear
    interpolation: an even count of frame energies with ties at and
    around the middle."""
    r = np.random.default_rng(2)
    gt = np.repeat(r.standard_normal((2, 6, 1)), 2 * F, axis=-1).astype(np.float32)
    gt[:, :3] = 0.25  # ties: channel 0's first three frames equal
    gt[:, :, F:] = gt[:, :, :F][:, ::-1]  # channel 1 mirrors channel 0 in time
    est = r.standard_normal((2, 6, 2 * F)).astype(np.float32)
    est[:, :2] = 1.0
    ref = np.asarray(jdialog.energy_based_loss(est[..., :F], est[..., F:], gt, F))
    out = tdialog.energy_based_loss(*map(torch.from_numpy, (est[..., :F], est[..., F:], gt)), F)
    assert np.count_nonzero(ref) > 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_checkpoint_surgery_matches_jax():
    """extend_vocab_params (a base vocabulary of VOCAB - 2 rows into a
    dialog model) and duplicate_projections_stereo on the same weights."""
    base_cfg = ZipVoiceConfig(**TINY, vocab_size=VOCAB - 2, pad_id=0)
    base = tzv.init_zipvoice(base_cfg, torch.Generator().manual_seed(5))
    fresh_tree, fresh = _model("dialog", 6)
    base_sd = {k: v.detach() for k, v in base.state_dict().items()}
    jbase = state_dict_to_params({k: v.numpy() for k, v in base_sd.items()})
    extended = tdialog.extend_vocab_params(fresh.state_dict(), base_sd)
    jext = jdialog.extend_vocab_params(fresh_tree, jbase)
    ref = params_to_state_dict(_np(jext))
    assert sorted(extended) == sorted(ref)
    for k, v in extended.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    stereo = tdialog.duplicate_projections_stereo(extended, F)
    ref = _by_name(jdialog.duplicate_projections_stereo(jext, F))
    assert sorted(stereo) == sorted(ref)
    for k, v in stereo.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    with torch.device("meta"):
        model = tdialog.ZipVoiceDialogModel(fresh.cfg, stereo=True)
    load_into(model, stereo)  # strict: the stereo model's exact keys


def _reference_step(model, grads, lr):
    """A copy of ``model`` after one ScaledAdam step on ``grads`` (JAX's
    gradients by name; a missing name is no gradient): the reference
    update.  The port's ScaledAdam is held to JAX's update by
    test_torch_regularizers.py::test_scaled_adam_matches_jax, so this is
    JAX's step without compiling JAX's optimizer over the whole tree."""
    ref = copy.deepcopy(model)
    for name, p in ref.named_parameters():
        p.grad = torch.tensor(grads[name]) if name in grads else None
    ScaledAdam(ref.named_parameters()).step(lr)
    return {k: v.detach().numpy() for k, v in ref.state_dict().items()}


def _assert_updates_match(before, after, ref_after, grads, lr):
    """Each element within 2 ulp of its old value, plus 1e-3 of the
    reference update, plus what a gradient error of 1e-6 of the tensor's
    largest gradient moves it: ScaledAdam's first update is lr x RMS x
    (1 - beta1) x g / (|g| + eps), whose slope in g is eps / (|g| + eps)^2,
    so an element whose gradient is near eps (or is rounding noise around a
    true 0, as the key biases') follows its gradient's last bits.  A
    flipped sign of any gradient well above eps misses by twice the
    update."""
    eps = 1e-8
    for name, p in after.items():
        ref, old = ref_after[name], before[name]
        g = np.abs(grads.get(name, np.zeros_like(old)))
        full = lr * max(float(np.sqrt(np.mean(np.square(old)))), 1e-5) * 0.1
        slope = eps / np.square(g + eps)
        tol = (2 * np.spacing(np.abs(old)) + 1e-3 * np.abs(ref - old)
               + 2 * full * slope * 1e-6 * g.max())
        bad = np.abs(p - ref) > tol
        assert not bad.any(), (name, p[bad], ref[bad], old[bad], g[bad])


def test_distill_step_matches_jax(monkeypatch):
    """One stage-two distill step: the student's fm_decoder moves as JAX's
    gradients (the others zeroed, as JAX's step zeroes them) through
    ScaledAdam, everything else of it stays bit-equal, and the EMA teacher
    moves as JAX's ema_update."""
    student, teacher, batch = _pin_distill(monkeypatch, "second")
    jl, _, grads = _jax_distill("second")
    before = {k: v.detach().numpy().copy() for k, v in student.state_dict().items()}
    ref_after = _reference_step(student, {k: v for k, v in grads.items()
                                          if k.startswith("fm_decoder.")}, 5e-4)
    jt = jax.tree.map(jnp.asarray, state_dict_to_params(  # a copy: the step writes in place
        {k: v.detach().numpy().copy() for k, v in teacher.state_dict().items()}))
    fn = tdstep.make_distill_train_step(
        student, teacher, ScaledAdam(student.named_parameters()),
        tstep.TrainConfig(base_lr=5e-4, compute_dtype="float32", use_regularizers=False),
        stage="second")
    m = fn(batch, 0, TRIPLE)
    assert abs(float(m["loss"]) - jl) <= 1e-5 * jl and m["lr"] == 5e-4
    after = {k: v.detach().numpy() for k, v in student.state_dict().items()}
    _assert_updates_match(before, after, ref_after, grads, 5e-4)
    for k, v in after.items():
        if not k.startswith("fm_decoder."):
            np.testing.assert_array_equal(v, before[k], err_msg=k)
    js = jax.tree.map(jnp.asarray, state_dict_to_params(after))
    ema = _by_name(jax.jit(jdistill.ema_update, static_argnums=2)(jt, js, tdstep.EMA_DECAY))
    for k, v in teacher.state_dict().items():
        _assert_ulps(v.numpy(), ema[k], k)


def test_dialog_step_matches_jax(monkeypatch):
    """One dialog step (fixed LR, no regularizers, no text drop) on the
    loss test's pinned draws: every parameter moves as JAX's gradients
    through ScaledAdam."""
    _, model = _model("dialog", 4)
    arrays, cond = _dialog_inputs(False)
    tokens, tl, feats, fl, noise, t = arrays
    _pin_mask(monkeypatch, jdialog, tdialog, "condition_time_mask_suffix", cond)
    monkeypatch.setattr(tstep, "draw_t_and_noise",
                        lambda *a: (torch.from_numpy(t), torch.from_numpy(noise), 0))
    jl, grads = _jax_dialog(False)
    before = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    ref_after = _reference_step(model, grads, 1e-4)
    fn = tstep.make_train_step(model, ScaledAdam(model.named_parameters()), tstep.TrainConfig(
        base_lr=1e-4, compute_dtype="float32", schedule="fixed", condition_drop_ratio=0.0,
        use_regularizers=False, loss="dialog"))
    m = fn({"tokens": tokens, "tokens_lens": tl, "features": feats, "features_lens": fl},
           0, 1, 0.0)
    assert abs(float(m["loss"]) - jl) <= 1e-5 * jl and m["lr"] == 1e-4
    _assert_updates_match(before, {k: v.detach().numpy() for k, v in
                                   model.state_dict().items()}, ref_after, grads, 1e-4)


def test_generate_averaged_model_matches_jax(tmp_path, monkeypatch):
    """--iter and --epoch windows of the port's CLI equal the JAX CLI's
    on the same checkpoints (running averages in float64)."""
    from zipvoice_tpu.bin import generate_averaged_model as javg
    from zipvoice_tpu_torch.bin import generate_averaged_model as tavg

    _, model = _model("base", 8)
    avg = tckpt.init_averaged_model(model)
    g = torch.Generator().manual_seed(0)
    for i in range(1, 5):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.01)
        tckpt.update_averaged_model(avg, model, i, 1)
        info = {"batch_idx_train": i, "average_period": 1}
        for name in (f"checkpoint-{i}.pt", f"epoch-{i}.pt"):
            tckpt.save_checkpoint(str(tmp_path / name), model, model_avg=avg, info=info)
    for window in (["--iter", "4", "--avg", "2"], ["--epoch", "4", "--avg", "3"]):
        args = ["--exp-dir", str(tmp_path), *window]
        out = tavg.main(args + ["--out", str(tmp_path / "port.pt")])
        monkeypatch.setattr(sys, "argv", ["avg", *args, "--out", str(tmp_path / "jax.pt")])
        javg.main()
        ours = tckpt.load_checkpoint(out)["model"]
        ref = torch.load(tmp_path / "jax.pt", weights_only=False)["model"]
        assert sorted(ours) == sorted(ref)
        for k, v in ours.items():
            # the JAX bridge writes 0-d parameters (BiasNorm's log_scale) as (1,)
            assert v.dtype == ref[k].dtype and torch.equal(v.reshape(-1), ref[k].reshape(-1)), k


def test_average_without_model_avg_matches_jax(tmp_path, monkeypatch, caplog):
    """Checkpoints written without a running average (by other tools):
    the averaging CLI logs JAX's warning and writes the f64 mean of the two
    checkpoints' weights, equal to the JAX CLI's output."""
    from zipvoice_tpu.bin import generate_averaged_model as javg
    from zipvoice_tpu_torch.bin import generate_averaged_model as tavg

    _, model = _model("base", 8)
    g = torch.Generator().manual_seed(1)
    for i in (2, 4):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.01)
        torch.save({"model": dict(model.state_dict()), "batch_idx_train": i},
                   tmp_path / f"checkpoint-{i}.pt")
    args = ["--exp-dir", str(tmp_path), "--iter", "4", "--avg", "1"]
    with caplog.at_level("WARNING"):
        out = tavg.main(args + ["--out", str(tmp_path / "port.pt")])
    assert any("model_avg missing" in r.getMessage() for r in caplog.records)
    monkeypatch.setattr(sys, "argv", ["avg", *args, "--out", str(tmp_path / "jax.pt")])
    javg.main()
    ours = tckpt.load_checkpoint(out)["model"]
    ref = torch.load(tmp_path / "jax.pt", weights_only=False)["model"]
    a = torch.load(tmp_path / "checkpoint-2.pt", weights_only=False)["model"]
    b = torch.load(tmp_path / "checkpoint-4.pt", weights_only=False)["model"]
    assert sorted(ours) == sorted(ref) == sorted(a)
    for k, v in ours.items():
        assert v.dtype == ref[k].dtype == torch.float32
        assert torch.equal(v.reshape(-1), ref[k].reshape(-1)), k
        assert torch.equal(v, ((a[k].double() + b[k].double()) / 2).float()), k


@pytest.mark.parametrize("feature,three_channel", [("bigvgan", False), ("vocos", True)])
def test_fbank_collator_matches_jax(tmp_path, feature, three_channel):
    """The training collator's features against JAX's: the bigvgan fbank
    (plain PyTorch), and the stereo recipe's three channels [ch0, ch1, the
    mix] through B8's plain version in one call for the 3B rows; stereo
    wavs are required there."""
    from zipvoice_tpu.config import FeatureConfig as JFeatureConfig
    from zipvoice_tpu.data import dataset as jdata
    from zipvoice_tpu.text.tokenizer import get_tokenizer as jget_tokenizer
    from zipvoice_tpu_torch.config import FeatureConfig
    from zipvoice_tpu_torch.data import dataset as tdata
    from zipvoice_tpu_torch.text.tokenizer import get_tokenizer

    r = np.random.default_rng(3)
    write_token_file({"_": 0, " ": 1, **{c: i + 2 for i, c in enumerate("abcdefgh")}},
                     str(tmp_path / "tokens.txt"))
    rows = []
    for i, n in enumerate((30000, 41000)):
        write_wav(tmp_path / f"{i}.wav", (r.standard_normal((2, n)) * 0.1).astype(np.float32),
                  24000)
        rows.append(f"u{i}\tabc def\t{tmp_path / f'{i}.wav'}")
    (tmp_path / "m.tsv").write_text("\n".join(rows) + "\n")
    kw = dict(pad_id=0, three_channel=three_channel)
    ours = tdata.OnDeviceFbankCollator(
        get_tokenizer("simple", str(tmp_path / "tokens.txt")), FeatureConfig(type=feature),
        device="cpu", **kw)(tdata.read_tsv_manifest(tmp_path / "m.tsv"))
    ref = jdata.OnDeviceFbankCollator(
        jget_tokenizer("simple", str(tmp_path / "tokens.txt")), JFeatureConfig(type=feature),
        **kw)(jdata.read_tsv_manifest(tmp_path / "m.tsv"))
    width = 300 if three_channel else 100
    assert ours["features"].shape == ref["features"].shape == (8, 192, width)
    np.testing.assert_array_equal(ours["features_lens"], ref["features_lens"])
    np.testing.assert_array_equal(ours["tokens"], ref["tokens"])
    assert float(np.abs(ours["features"].numpy() - np.asarray(ref["features"])).max()) < 1e-4
    if three_channel:
        mono = tdata.OnDeviceFbankCollator(
            get_tokenizer("simple", str(tmp_path / "tokens.txt")), FeatureConfig(),
            device="cpu")
        mono.three_channel = True
        write_wav(tmp_path / "0.wav", np.zeros((1, 24000), np.float32), 24000)
        with pytest.raises(ValueError, match="stereo wav required"):
            mono(tdata.read_tsv_manifest(tmp_path / "m.tsv"))


# ---------------------------------------------------------------------------
# the CLIs: the recipes' chains on the CPU
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "the quick brown fox", "jumps over the dog", "good day to you"]
DIALOG_TEXTS = ["[S1] hello there. [S2] hi, how are you?", "[S1] fine. [S2] good to hear.",
                "[S1] see you. [S2] bye now.", "[S1] what is it? [S2] nothing at all."]


def _emilia_tokens(dialog: bool):
    """The espeak block and fillers to 334 rows; the dialog vocabulary
    adds 28 rows, [S1]/[S2] at 360/361 as in the released one."""
    token2id = dict(VENDORED_ESPEAK_MAP)
    token2id.update({f"<filler{i}>": i for i in range(len(token2id), 360 if dialog else 334)})
    if dialog:
        token2id.update({"[S1]": 360, "[S2]": 361})
    return token2id


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Mono and stereo wavs with English transcripts (emilia and dialog
    tokenizers through the offline G2P), both vocabularies, the model.json
    and a base checkpoint on the base vocabulary."""
    d = tmp_path_factory.mktemp("variant_corpus")
    rng = np.random.default_rng(0)
    for kind, texts, ch in (("mono", TEXTS, 1), ("stereo", DIALOG_TEXTS, 2),
                            ("dialog", DIALOG_TEXTS, 1)):
        lines = []
        for i, text in enumerate(texts):
            n = int(rng.uniform(1.1, 1.6) * 24000)
            wav = d / f"{kind}{i}.wav"
            write_wav(wav, (rng.standard_normal((ch, n)) * 0.1).astype(np.float32), 24000)
            lines.append(f"{kind}{i}\t{text}\t{wav}")
        (d / f"{kind}.tsv").write_text("\n".join(lines) + "\n")
    write_token_file(_emilia_tokens(False), str(d / "tokens_base.txt"))
    write_token_file(_emilia_tokens(True), str(d / "tokens_dialog.txt"))
    (d / "model.json").write_text(json.dumps({
        "model": {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()},
        "feature": {"sampling_rate": 24000, "type": "vocos", "n_mels": F}}))
    base = tzv.init_zipvoice(dataclasses.replace(_configs()[1], vocab_size=334),
                             torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(d / "base.pt"), base)
    return d


def _train_args(corpus, manifest, tokens, exp, iters):
    return ["--device", "cpu", "--train-manifest", str(corpus / manifest), "--token-file",
            str(corpus / tokens), "--model-config", str(corpus / "model.json"),
            "--exp-dir", str(exp), "--num-iters", str(iters), "--max-duration", "3",
            "--save-every-n", "1", "--average-period", "1", "--log-interval", "1",
            "--dtype", "float32"]


@pytest.mark.parametrize("recipe", ["run_distill", "run_dialog"])
def test_recipe_chain_cpu(corpus, tmp_path, recipe):
    """run_distill.sh: stage 1 from the base checkpoint, averaged, stage 2
    from the average, averaged; run.sh: dialog from the base checkpoint,
    averaged, stereo from the average, averaged.  Finite losses; distill
    trains only the fm_decoder and keeps its teacher in "model_ema"; every
    average loads as a model dir's model.pt."""
    from zipvoice_tpu_torch.bin import generate_averaged_model as avg
    from zipvoice_tpu_torch.io.model_dir import load_model_dir

    def average(exp, iters, name):
        out = avg.main(["--exp-dir", str(exp), "--iter", str(iters), "--avg", "1",
                        "--out", str(exp / "model.pt")])
        load_model_dir(str(exp), model_name=name)  # model.pt + model.json + tokens.txt
        return out

    if recipe == "run_distill":
        from zipvoice_tpu_torch.bin.train_zipvoice_distill import main as distill

        s1 = tmp_path / "s1"
        res = distill(_train_args(corpus, "mono.tsv", "tokens_base.txt", s1, 2)
                      + ["--teacher-checkpoint", str(corpus / "base.pt")])
        assert res["step_idx"] == 2 and all(np.isfinite([x for _, x in res["steps"]]))
        base = torch.load(corpus / "base.pt", weights_only=False)["model"]
        for k, v in res["student"].state_dict().items():
            if not k.startswith("fm_decoder."):
                assert torch.equal(v, base[k]), k
        assert tckpt.load_checkpoint(str(s1 / "checkpoint-2.pt"))["model_ema"] is None
        s1_avg = average(s1, 2, "zipvoice_distill")
        s2 = tmp_path / "s2"
        res = distill(_train_args(corpus, "mono.tsv", "tokens_base.txt", s2, 2)
                      + ["--teacher-checkpoint", s1_avg, "--distill-stage", "second"])
        assert all(np.isfinite([x for _, x in res["steps"]]))
        ema = tckpt.load_checkpoint(str(s2 / "checkpoint-2.pt"))["model_ema"]
        assert sorted(ema) == sorted(res["teacher"].state_dict())
        average(s2, 2, "zipvoice_distill")
    else:
        from zipvoice_tpu_torch.bin.train_zipvoice_dialog import main as dialog
        from zipvoice_tpu_torch.bin.train_zipvoice_dialog_stereo import main as stereo

        mono = tmp_path / "dialog"
        res = dialog(_train_args(corpus, "dialog.tsv", "tokens_dialog.txt", mono, 2)
                     + ["--checkpoint", str(corpus / "base.pt")])
        assert res["trainer"].batch_idx_train == 2
        assert all(np.isfinite([x for _, x in res["steps"]]))
        emb = res["trainer"].model.embed.weight
        assert emb.shape[0] == 362 and res["trainer"].train_cfg.loss == "dialog"
        d_avg = average(mono, 2, "zipvoice_dialog")
        st = tmp_path / "stereo"
        res = stereo(_train_args(corpus, "stereo.tsv", "tokens_dialog.txt", st, 2)
                     + ["--checkpoint", d_avg])
        assert all(np.isfinite([x for _, x in res["steps"]]))
        assert res["trainer"].model.fm_decoder.in_proj[0].in_features == 5 * F
        average(st, 2, "zipvoice_dialog_stereo")


@pytest.mark.parametrize("cli", ["distill", "dialog"])
def test_variant_clis_take_remat_policy_and_unroll_layers(corpus, tmp_path, cli):
    """The distill and dialog CLIs train a step under --remat-policy xprobs
    with --unroll-layers (no longer refused): a finite loss."""
    from zipvoice_tpu_torch.bin.train_zipvoice_dialog import main as dialog
    from zipvoice_tpu_torch.bin.train_zipvoice_distill import main as distill
    from zipvoice_tpu_torch.nn import zipformer as tzf

    flags = ["--remat-policy", "xprobs", "--unroll-layers"]
    try:
        if cli == "distill":
            res = distill(_train_args(corpus, "mono.tsv", "tokens_base.txt", tmp_path, 1)
                          + ["--teacher-checkpoint", str(corpus / "base.pt"), *flags])
        else:
            res = dialog(_train_args(corpus, "dialog.tsv", "tokens_dialog.txt", tmp_path, 1)
                         + ["--checkpoint", str(corpus / "base.pt"), *flags])
        assert tzf._REMAT_POLICY == "xprobs"
    finally:
        tzf.set_remat_policy("full")
    losses = [x for _, x in res["steps"]]
    assert len(losses) == 1 and np.isfinite(losses[0])
