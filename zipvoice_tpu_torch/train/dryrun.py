"""Multi-process dry run on the CPU: the data-parallel training CLIs, a
tensor-parallel step and the sequence-parallel sampler in n gloo processes
at a tiny width, before a run on cards.

``run_dryrun(n)`` writes a tiny corpus and a random base checkpoint,
starts n processes as torchrun would (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in each one's
environment) and runs in each, one after the other, the train CLI (the
regularizers on), the distill CLI (stage one, from the base checkpoint)
and the dialog CLI (from the base checkpoint), each as ``main([...,
"--distributed", "--device", "cpu"], backend="gloo")`` with a checkpoint
every step.  Every rank gets its own --exp-dir, so that what each one
writes can be told apart.  Then it checks, for each CLI, that every loss is
finite and equal on every rank (the metrics are global; the train CLI
also validates every step on a sharded dev set), that the ranks'
parameters are bit-identical, and that only rank 0 wrote anything.

As the JAX package's dry run does, the same processes then rehearse, on a
process group of their own: for n >= 4 and even, one bf16 training step
(the regularizers on) on a data x model mesh of n / 2 x 2
(``parallel/mesh.make_mesh``, the feedforwards split over the model axis):
a finite loss, equal on every rank, and each shard bit-identical across the
data ranks that hold it; and one bf16 sequence-parallel training step (the
regularizers on) on a data x seq mesh of n / 2 x 2
(``parallel/mesh.make_dp_sp_mesh``, each data row's frames over two ranks):
a finite loss, equal on every rank, and the parameters bit-identical on
every rank; for every n, the sequence-parallel sampler
(``models/zipvoice.sp_sample``) over all n ranks at T = 16 n: the same
finite output on every rank, within 2e-5 of one process's ``sample``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# the JAX package's dry-run configuration
TINY = dict(fm_decoder_downsampling_factor=[1, 2, 1], fm_decoder_num_layers=[1, 2, 1],
            fm_decoder_cnn_module_kernel=[9, 7, 9], fm_decoder_feedforward_dim=96,
            fm_decoder_num_heads=2, fm_decoder_dim=64, text_encoder_num_layers=2,
            text_encoder_feedforward_dim=48, text_encoder_cnn_module_kernel=5,
            text_encoder_num_heads=2, text_encoder_dim=48, time_embed_dim=32,
            text_embed_dim=48, query_head_dim=8, value_head_dim=8, pos_head_dim=4,
            pos_dim=48, feat_dim=16)

_WORKER = ("import importlib, json, sys; mod, fn = sys.argv[1].split(':'); "
           "getattr(importlib.import_module(mod), fn)(**json.loads(sys.argv[2]))")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, n: int, kwargs: Dict, timeout: float,
          path: Sequence[str] = ()) -> None:
    """Run ``module:function(**kwargs)`` in n processes, each with the
    environment torchrun gives rank r of n on this host (a free
    localhost port); ``path`` goes in front of PYTHONPATH.  Raises if a
    process exits non-zero or any outlives ``timeout`` seconds (all are
    killed then)."""
    port = free_port()
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [*path, str(REPO)] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    # each rank's output goes to a file: a pipe left unread while another
    # rank is waited for could fill and block its writer
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = []
    for r in range(n):
        e = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                 LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, target, json.dumps(kwargs)], env=e,
            stdout=logs[r], stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
        for p in procs:
            p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read()[-3000:])
        log.close()
    if timed_out:
        raise RuntimeError(f"{target}: {n} processes outlived {timeout} s:\n"
                           + "\n".join(f"rank {r}:\n{t}" for r, t in enumerate(outs)))
    failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{target}: ranks failed: " + "\n".join(
            f"rank {r} exit {rc}:\n{out}" for r, rc, out in failed))


def write_corpus(d: Path, n_utts: int, feat_dim: int, seed: int = 0) -> Dict[str, str]:
    """A tiny random corpus: n_utts wavs of 1.2-2 s at 24 kHz, their TSV
    manifest, a character tokens.txt and a model.json at the dry-run
    width.  Returns the CLI's paths."""
    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.text.tokenizer import write_token_file

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_utts):
        n = int(rng.uniform(1.2, 2.0) * 24000)
        write_wav(d / f"u{i}.wav", (rng.standard_normal((1, n)) * 0.1).astype(np.float32),
                  24000)
        text = " ".join("abcdefghij"[j % 10] * 3 for j in range(i % 4 + 2))
        lines.append(f"u{i}\t{text}\t{d / f'u{i}.wav'}")
    (d / "train.tsv").write_text("\n".join(lines) + "\n")
    write_token_file({"_": 0, " ": 1, **{c: i + 2 for i, c in
                                         enumerate("abcdefghijklmnopqrstuvwxyz")}},
                     str(d / "tokens.txt"))
    model = dict(TINY, feat_dim=feat_dim)
    (d / "model.json").write_text(json.dumps(
        {"model": model, "feature": {"sampling_rate": 24000, "type": "vocos",
                                     "n_mels": feat_dim}}))
    return {"train_manifest": str(d / "train.tsv"), "token_file": str(d / "tokens.txt"),
            "model_config": str(d / "model.json")}


# CLI name -> (module, the checkpoints a run of n steps writes)
CLIS = {
    "zipvoice": ("train_zipvoice", lambda n: [f"checkpoint-{i}.pt" for i in range(1, n + 1)]
                 + ["epoch-1.pt"]),
    "distill": ("train_zipvoice_distill",
                lambda n: [f"checkpoint-{i}.pt" for i in range(1, n + 1)] + [f"iter-{n}.pt"]),
    "dialog": ("train_zipvoice_dialog",
               lambda n: [f"checkpoint-{i}.pt" for i in range(1, n + 1)] + ["epoch-1.pt"]),
}


# the tensor- and sequence-parallel rehearsal's model: the JAX package's
# dry-run model (its make_dp_sp_mesh phase's)
PARALLEL_TINY = dict(TINY, fm_decoder_num_layers=[1, 1, 1], text_encoder_num_layers=1,
                     vocab_size=40, pad_id=0)


def _sp_inputs(n: int):
    """The sequence-parallel rehearsal's request: one utterance of T = 16 n
    frames, CFG, 2 steps."""
    rng = np.random.default_rng(0)
    t, s, f = 16 * n, 12, TINY["feat_dim"]
    return {"tokens": rng.integers(1, 40, (1, s)).astype(np.int64),
            "tokens_lens": np.array([s - 2]), "prompt_features":
            (rng.standard_normal((1, t, f)) * 0.1).astype(np.float32),
            "prompt_features_lens": np.array([t // 4]), "features_lens": np.array([t]),
            "noise": rng.standard_normal((1, t, f)).astype(np.float32)}


SP_ORDER = ("tokens", "tokens_lens", "prompt_features", "prompt_features_lens",
            "features_lens", "noise")
SP_KW = dict(num_step=2, guidance_scale=1.0, t_shift=0.5)


def _parallel_model():
    import torch

    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice

    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in PARALLEL_TINY.items()})
    return cfg, init_zipvoice(cfg, torch.Generator().manual_seed(0))


def _parallel_rank(out: str):
    """The tensor- and sequence-parallel rehearsal of one rank (module
    docstring), on the process group the environment names; results into
    ``out``."""
    import torch

    from zipvoice_tpu_torch.models.zipvoice import sp_sample
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    mesh.init_from_env("cpu", backend="gloo")
    r, n = mesh.rank(), mesh.world_size()
    res = {}
    if n >= 4 and n % 2 == 0:
        cfg, model = _parallel_model()
        m = mesh.make_mesh(n_model=2)
        mesh.shard_module(model, mesh.tp_param_shardings(model), m)
        rng = np.random.default_rng(0)
        b, s, t = 2, 12, 32  # rows a data rank
        d = m.index["data"]
        rows = {"tokens": rng.integers(1, 40, (b * m.size("data"), s)),
                "features": rng.standard_normal((b * m.size("data"), t, TINY["feat_dim"]))
                .astype(np.float32)}
        batch = {"tokens": rows["tokens"][d * b:(d + 1) * b],
                 "tokens_lens": np.full((b,), s - 2), "features_lens": np.full((b,), t - 3),
                 "features": rows["features"][d * b:(d + 1) * b]}
        step = make_train_step(model, ScaledAdam(model.named_parameters()),
                               TrainConfig(compute_dtype="bfloat16"), mesh=m)
        res["tp_loss"] = float(step(batch, 1, 1, 0.0, zipvoice_schedules(0.0, cfg))["loss"])
        res["tp_index"] = dict(m.index)
        res["tp_shards"] = {k: v.detach().clone() for k, v in model.state_dict().items()}

        cfg, model = _parallel_model()
        m = mesh.make_dp_sp_mesh(n // 2, 2)
        d = m.index["data"]
        batch = {"tokens": rows["tokens"][d * b:(d + 1) * b],
                 "tokens_lens": np.full((b,), s - 2), "features_lens": np.full((b,), t - 3),
                 "features": rows["features"][d * b:(d + 1) * b]}  # whole rows, all T
        step = make_train_step(model, ScaledAdam(model.named_parameters()),
                               TrainConfig(compute_dtype="bfloat16"), mesh=m)
        res["sp_loss"] = float(step(batch, 1, 1, 0.0, zipvoice_schedules(0.0, cfg))["loss"])
        res["sp_params"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    _, model = _parallel_model()
    x = {k: torch.from_numpy(v) for k, v in _sp_inputs(n).items()}
    res["sp_out"] = sp_sample(model, mesh.make_seq_mesh(), *(x[k] for k in SP_ORDER), **SP_KW)
    torch.save(res, Path(out) / f"parallel-rank-{r}.pt")
    mesh.shutdown()


def _check_parallel(out: Path, n: int) -> str:
    """The rehearsal's checks over the ranks' results; returns what ran."""
    import torch

    from zipvoice_tpu_torch.models.zipvoice import sample

    ranks = [torch.load(out / f"parallel-rank-{r}.pt") for r in range(n)]
    ran = []
    if "tp_loss" in ranks[0]:
        losses = {res["tp_loss"] for res in ranks}
        if len(losses) != 1 or not np.isfinite(ranks[0]["tp_loss"]):
            raise AssertionError(f"dp x tp step: losses {losses}")
        by_model = {}
        for res in ranks:
            first = by_model.setdefault(res["tp_index"]["model"], res["tp_shards"])
            diff = [k for k, v in res["tp_shards"].items() if not torch.equal(v, first[k])]
            if diff:
                raise AssertionError(f"dp x tp step: rank at {res['tp_index']} holds other "
                                     f"shards than its data rank 0: {diff[:5]}")
        ran.append(f"dp={n // 2} x tp=2 bf16 step, loss {ranks[0]['tp_loss']:.4f}, shards "
                   "bit-identical across the data ranks")
        losses = {res["sp_loss"] for res in ranks}
        if len(losses) != 1 or not np.isfinite(ranks[0]["sp_loss"]):
            raise AssertionError(f"dp x sp step: losses {losses}")
        for r, res in enumerate(ranks):
            diff = [k for k, v in res["sp_params"].items()
                    if not torch.equal(v, ranks[0]["sp_params"][k])]
            if diff:
                raise AssertionError(f"dp x sp step: rank {r}'s parameters differ from rank "
                                     f"0's: {diff[:5]}")
        ran.append(f"dp={n // 2} x sp=2 bf16 step, loss {ranks[0]['sp_loss']:.4f}, parameters "
                   "bit-identical on every rank")
    _, model = _parallel_model()
    x = {k: torch.from_numpy(v) for k, v in _sp_inputs(n).items()}
    with torch.no_grad():
        ref = sample(model, *(x[k] for k in SP_ORDER), **SP_KW)
    for r, res in enumerate(ranks):
        y = res["sp_out"]
        if not (torch.equal(y, ranks[0]["sp_out"]) and torch.isfinite(y).all()):
            raise AssertionError(f"sequence-parallel sampler: rank {r}'s output differs from "
                                 "rank 0's or is not finite")
    err = float((ranks[0]["sp_out"] - ref).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"sequence-parallel sampler vs one process: {err} > 2e-5")
    ran.append(f"sequence-parallel sampler over {n} ranks at T={16 * n}, max |diff| vs one "
               f"process {err:.2g}")
    return "; ".join(ran)


def _cli_worker(corpus: Dict[str, str], out: str, steps: int, ports: Dict[str, int]):
    """One rank of the dry run: each CLI with --distributed over gloo on
    the CPU, its exp dir its own, its process group on its own port (so
    that no rank joins the group of the CLI before); after each, its
    parameters and losses into ``out``; then the tensor- and
    sequence-parallel rehearsal on a group of its own."""
    import importlib

    import torch

    torch.set_num_threads(1)
    r = int(os.environ["RANK"])
    common = ["--distributed", "--device", "cpu", "--tokenizer", "simple",
              "--train-manifest", corpus["train_manifest"], "--token-file", corpus["token_file"],
              "--model-config", corpus["model_config"], "--num-epochs", "1",
              "--max-duration", "2.5", "--log-interval", "1", "--save-every-n", "1",
              "--dtype", "bfloat16"]
    # the train CLI also validates every step on a sharded dev set
    extra = {"zipvoice": ["--num-steps-per-epoch", str(steps), "--valid-interval", "1",
                          "--dev-manifest", corpus["train_manifest"]],
             "distill": ["--num-iters", str(steps),
                         "--teacher-checkpoint", corpus["checkpoint"]],
             "dialog": ["--num-iters", str(steps), "--checkpoint", corpus["checkpoint"]]}
    for name, (module, _) in CLIS.items():
        os.environ["MASTER_PORT"] = str(ports[name])
        main = importlib.import_module(f"zipvoice_tpu_torch.bin.{module}").main
        res = main(common + ["--exp-dir", str(Path(out) / f"{name}-{r}"), *extra[name]],
                   backend="gloo")
        model = res["student"] if name == "distill" else res["trainer"].model
        torch.save({"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
                    "losses": [loss for _, loss in res["steps"]],
                    "valid": res["trainer"].best_valid_loss if name == "zipvoice" else None},
                   Path(out) / f"{name}-rank-{r}.pt")
    os.environ["MASTER_PORT"] = str(ports["parallel"])
    _parallel_rank(out)


def run_dryrun(n_processes: int = 2, steps: int = 2, timeout: float = 240.0) -> Dict:
    """The dry run over n_processes ranks (module docstring); returns
    {CLI name: rank 0's losses}.  Raises on any failed check."""
    import torch

    from zipvoice_tpu_torch.config import load_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.tokenizer import SimpleTokenizer
    from zipvoice_tpu_torch.train.checkpoint import save_checkpoint

    losses = {}
    with tempfile.TemporaryDirectory() as td:
        out = Path(td)
        corpus = write_corpus(out / "corpus", 4 * n_processes, TINY["feat_dim"])
        tok = SimpleTokenizer(corpus["token_file"])
        cfg, _ = load_model_json(corpus["model_config"], vocab_size=tok.vocab_size,
                                 pad_id=tok.pad_id)
        corpus["checkpoint"] = str(out / "corpus" / "base.pt")
        save_checkpoint(corpus["checkpoint"], init_zipvoice(cfg, torch.Generator().manual_seed(1)))
        spawn(f"{__name__}:_cli_worker", n_processes,
              {"corpus": corpus, "out": td, "steps": steps,
               "ports": {name: free_port() for name in [*CLIS, "parallel"]}}, timeout)
        for name, (_, written_by) in CLIS.items():
            ranks = [torch.load(out / f"{name}-rank-{r}.pt") for r in range(n_processes)]
            first = ranks[0]
            for r, res in enumerate(ranks):
                if len(res["losses"]) != steps or not np.all(np.isfinite(res["losses"])):
                    raise AssertionError(f"{name} rank {r}: losses {res['losses']}")
                if res["losses"] != first["losses"] or res["valid"] != first["valid"]:
                    raise AssertionError(f"{name}: rank {r}'s losses {res['losses']} (valid "
                                         f"{res['valid']}) are not rank 0's {first['losses']} "
                                         f"({first['valid']})")
                if name == "zipvoice" and not np.isfinite(res["valid"]):
                    raise AssertionError(f"rank {r}: validation loss {res['valid']}")
                diff = [k for k, v in res["params"].items()
                        if not torch.equal(v, first["params"][k])]
                if diff:
                    raise AssertionError(f"{name}: rank {r}'s parameters differ from "
                                         f"rank 0's: {diff[:5]}")
            written = {r: sorted(p.name for p in (out / f"{name}-{r}").iterdir())
                       for r in range(n_processes) if (out / f"{name}-{r}").exists()}
            if not set(written_by(steps)) <= set(written[0]):
                raise AssertionError(f"{name}: rank 0 wrote {written[0]}, want "
                                     f"{written_by(steps)} among them")
            if any(written.get(r) for r in range(1, n_processes)):
                raise AssertionError(f"{name}: ranks other than 0 wrote files: {written}")
            losses[name] = first["losses"]
        parallel = _check_parallel(out, n_processes)
    print(f"dryrun ok: {n_processes} gloo processes, data parallel, bf16, the train, distill "
          f"and dialog CLIs; losses {losses}; parameters bit-identical across ranks; only "
          f"rank 0 wrote; {parallel}")
    return losses
