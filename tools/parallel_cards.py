#!/usr/bin/env python3
"""Tensor and sequence parallelism over four NVIDIA cards of one host, over
NCCL, at full width (123M, chip_smoke.py's phase 4 weights):

* the sequence-parallel sampler (``models/zipvoice.sp_sample``, f32, TF32
  off) over the four ranks on one request of 6144 frames (65.5 s), 16
  steps with CFG, against one card's ``sample`` on the same noise
  (relative L2), each rank's B1 / B2 launches and collectives, the wall of
  both;
* dp = 2 x tp = 2 (``parallel/mesh.make_mesh(2, 2)``) on chip_smoke.py's
  14c rows (B=8, T=1024, four rows a data rank): one f32 step without the
  regularizers, its gathered parameters against a dp = 2 run's (a second
  torchrun over two cards, the same rows and seed; atol 1e-4, JAX's TP
  tolerance), then 2 bf16 steps with the regularizers; after each step the
  shards of the two data ranks of every model index bit-identical;
* sequence-parallel training, dp = 2 x sp = 2
  (``parallel/mesh.make_dp_sp_mesh(2, 2)``) on the same rows, each data
  row's frames over two cards: one f32 step without the regularizers,
  against the same dp = 2 run (JAX's test_sp_train_step_matches_dp: loss
  within 1e-5, parameters within atol 1e-4), every rank's parameters
  bit-identical.

    python3 tools/parallel_cards.py

Needs four cards of one host, joined by NVLink.  Prints one line a
check with the card's name and power limit, and exits non-zero on a failed
one.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FRAMES = 6144
CARDS = 4


def _digest(tensors) -> str:
    h = hashlib.blake2b()
    for k in sorted(tensors):
        h.update(tensors[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _steps(root: Path, out: Path, mesh_shape, dev, regularized_steps: int):
    """One f32 step without the regularizers (then ``regularized_steps``
    bf16 ones with them) on a data x model mesh; after each, this rank's
    shard digest; the gathered parameters after the f32 step saved by rank
    0."""
    import torch

    import chip_smoke as cs
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.schedules import zipvoice_schedules
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    m = mesh.make_mesh(*mesh_shape)
    model = load_model_dir(str(root), tokenizer_name="simple").model.to(dev)
    mesh.shard_module(model, mesh.tp_param_shardings(model), m)
    opt = ScaledAdam(model.named_parameters())
    batch = cs._policy_batch(model.cfg)
    n_data, d = m.size("data"), m.index["data"]
    b = batch["tokens"].shape[0] // n_data
    rows = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
    res = {"index": dict(m.index), "steps": []}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for i in range(1 + regularized_steps):
        dtype = "float32" if i == 0 else "bfloat16"
        step = make_train_step(model, opt, TrainConfig(compute_dtype=dtype), mesh=m)
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(step(rows, 40 + i, i + 1, 0.0,
                          None if i == 0 else zipvoice_schedules(1000.0, model.cfg))["loss"])
        torch.cuda.synchronize()
        res["steps"].append({"dtype": dtype, "loss": loss, "ms": (time.monotonic() - t0) * 1e3,
                             "collectives": dict(mesh.COUNTS),
                             "shard": _digest(dict(model.named_parameters()))})
        if i == 0:
            full = mesh.unshard_state_dict(model)
            if mesh.rank() == 0:
                torch.save({k: v.cpu() for k, v in full.items()}, out / "params.pt")
            del full
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    return res


def _sp_step(root: Path, out: Path, dev):
    """One f32 step without the regularizers on dp = 2 x sp = 2 (the same
    rows and seed as _steps' first), this rank's parameter digest after it;
    rank 0 saves the parameters (``sp_params.pt``)."""
    import torch

    import chip_smoke as cs
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.parallel import mesh
    from zipvoice_tpu_torch.train.scaled_adam import ScaledAdam
    from zipvoice_tpu_torch.train.step import TrainConfig, make_train_step

    m = mesh.make_dp_sp_mesh(2, 2)
    model = load_model_dir(str(root), tokenizer_name="simple").model.to(dev)
    batch = cs._policy_batch(model.cfg)
    b = batch["tokens"].shape[0] // 2
    d = m.index["data"]
    rows = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}  # whole rows, all T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step = make_train_step(model, ScaledAdam(model.named_parameters()),
                           TrainConfig(compute_dtype="float32"), mesh=m)
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    loss = float(step(rows, 40, 1, 0.0, None)["loss"])
    torch.cuda.synchronize()
    res = {"index": dict(m.index), "loss": loss, "ms": (time.monotonic() - t0) * 1e3,
           "collectives": dict(mesh.COUNTS), "digest": _digest(dict(model.named_parameters()))}
    if mesh.rank() == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                   out / "sp_params.pt")
    return res


def _rank(root: str, out: str, mode: str) -> int:
    """A rank under torchrun: ``sp_tp`` (sequence-parallel sampler, then
    dp = 2 x tp = 2, then dp = 2 x sp = 2 training) or ``dp`` (the dp = 2
    reference step)."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.parallel import mesh

    dev = mesh.init_from_env("cuda")
    r, n = mesh.rank(), mesh.world_size()
    root, out = Path(root), Path(out)
    res = {}
    if mode == "sp_tp":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = load_model_dir(str(root), tokenizer_name="simple").model.eval().to(dev)
        request = cs._sp_request(model.cfg, FRAMES)
        x = [request[k].to(dev) for k in cs.SP_ORDER]
        seq = mesh.make_seq_mesh()
        counters = cs._counters()
        zv.sp_sample(model, seq, *x, num_step=cs.N_STEP)  # warm
        cs._zero(counters)
        mesh.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        y = zv.sp_sample(model, seq, *x, num_step=cs.N_STEP)
        torch.cuda.synchronize()
        res["sp"] = {"wall_s": time.monotonic() - t0, "launches": cs._launched(counters),
                     "collectives": dict(mesh.COUNTS)}
        if r == 0:  # one card's sample, the others waiting
            with torch.no_grad():
                zv.sample(model, *x, num_step=cs.N_STEP)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                ref = zv.sample(model, *x, num_step=cs.N_STEP)
                torch.cuda.synchronize()
            res["sp"]["one_card_s"] = time.monotonic() - t0
            res["sp"]["rel_l2"] = float((y - ref).float().norm() / ref.float().norm())
            res["sp"]["finite"] = bool(torch.isfinite(y).all())
        mesh.barrier()
        del model, x, y
        torch.cuda.empty_cache()
        res["tp"] = _steps(root, out, (n // 2, 2), dev, 2)
        torch.cuda.empty_cache()
        res["sp_train"] = _sp_step(root, out, dev)
    else:
        res["tp"] = _steps(root, out, (n, 1), dev, 0)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (out / f"{mode}-{r}.json").write_text(json.dumps(res))
    mesh.shutdown()
    return 0


def _torchrun(n: int, root: Path, out: Path, mode: str) -> None:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), str(Path(__file__).resolve()), "--rank", str(root), str(out), mode]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    print(f"torchrun {mode} over {n} cards: exit {proc.returncode} in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-6000:], flush=True)
        raise RuntimeError(f"torchrun {mode} failed")


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    from zipvoice_tpu_torch.ops import build

    card = cs.card_line()
    n = torch.cuda.device_count()
    print(f"{card}, {n} cards", flush=True)
    if n < CARDS:
        print(f"parallel_cards: needs {CARDS} cards, this host has {n}", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    build.build_all()
    print(f"build {time.monotonic() - t0:.1f} s", flush=True)
    build.BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="parallel-", dir=build.BUILD))
    cs.make_assets(root)
    out_sp, out_dp = root / "sp_tp", root / "dp"
    out_sp.mkdir()
    out_dp.mkdir()
    _torchrun(CARDS, root, out_sp, "sp_tp")
    _torchrun(2, root, out_dp, "dp")
    ranks = [json.loads((out_sp / f"sp_tp-{r}.json").read_text()) for r in range(CARDS)]
    ok = True

    sp = ranks[0]["sp"]
    fm_layers, stacks, steps = 16, 5, cs.N_STEP
    want_coll = {"all_reduce": 0, "all_gather": (4 * fm_layers + stacks) * steps + 1,
                 "halo": 2 * fm_layers * steps}
    pins = all({k: r["sp"]["launches"][k] for k in ("B1", "B2")}
               == {"B1": cs.UNFUSED_PER_REQUEST["B1"], "B2": cs.UNFUSED_PER_REQUEST["B2"]}
               and r["sp"]["collectives"] == want_coll for r in ranks)
    ok &= pins and sp["finite"] and sp["rel_l2"] <= cs.SP_TOL
    print(f"sequence-parallel sampler over {CARDS} cards (NCCL, f32, TF32 off): {FRAMES} "
          f"frames ({FRAMES / 93.75:.1f} s), {steps} steps with CFG: relative L2 against one "
          f"card's sample {sp['rel_l2']:.3g} (tol {cs.SP_TOL:g}), finite {sp['finite']}; "
          f"launches and collectives a rank pinned: {pins} ({sp['launches']}, "
          f"{sp['collectives']}); wall a rank {[round(r['sp']['wall_s'], 2) for r in ranks]} s "
          f"against one card's {sp['one_card_s']:.2f} s on {card}", flush=True)

    dp = torch.load(out_dp / "params.pt")
    tp = torch.load(out_sp / "params.pt")
    worst = max(float((tp[k] - v).abs().max()) for k, v in dp.items())
    same = all(ranks[m]["tp"]["steps"][i]["shard"] == ranks[2 + m]["tp"]["steps"][i]["shard"]
               for m in (0, 1) for i in range(3))
    dp_ranks = [json.loads((out_dp / f"dp-{r}.json").read_text()) for r in range(2)]
    ok &= same and worst <= 1e-4 and all(np.isfinite(s["loss"]) for s in ranks[0]["tp"]["steps"])
    print(f"dp=2 x tp=2 over {CARDS} cards (NCCL): the f32 step (no regularizers) loss "
          f"{ranks[0]['tp']['steps'][0]['loss']:.6f} against dp=2's "
          f"{dp_ranks[0]['tp']['steps'][0]['loss']:.6f}, gathered parameters max |diff| against "
          f"dp=2's {worst:.3g} (tol 1e-4); bf16 steps with the regularizers, losses "
          f"{[round(s['loss'], 4) for s in ranks[0]['tp']['steps'][1:]]}; shards bit-identical "
          f"across the data ranks after every step: {same}; step ms rank 0 "
          f"{[round(s['ms'], 1) for s in ranks[0]['tp']['steps']]} (dp=2's f32 step "
          f"{dp_ranks[0]['tp']['steps'][0]['ms']:.1f}); collectives a bf16 step "
          f"{ranks[0]['tp']['steps'][-1]['collectives']}; a rank's peak over "
          f"the run {max(r['peak_gib'] for r in ranks):.2f} GiB on {card}", flush=True)

    st = [r["sp_train"] for r in ranks]
    sp = torch.load(out_sp / "sp_params.pt")
    worst = max(float((sp[k] - v).abs().max()) for k, v in dp.items())
    dp_step = dp_ranks[0]["tp"]["steps"][0]
    loss_diff = abs(st[0]["loss"] - dp_step["loss"])
    same = len({r["digest"] for r in st}) == 1
    ok &= same and worst <= 1e-4 and loss_diff <= 1e-5
    print(f"dp=2 x sp=2 over {CARDS} cards (NCCL, make_dp_sp_mesh): the f32 step (no "
          f"regularizers, TF32 off) loss {st[0]['loss']:.7f} against dp=2's "
          f"{dp_step['loss']:.7f} (|diff| {loss_diff:.3g}, tol 1e-5), parameters max |diff| "
          f"against dp=2's {worst:.3g} (tol 1e-4); every rank's parameters bit-identical: "
          f"{same}; step ms {[round(r['ms'], 1) for r in st]} against dp=2's "
          f"{dp_step['ms']:.1f}; collectives a rank {st[0]['collectives']} on {card}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank(*sys.argv[2:5]))
    sys.exit(main())
