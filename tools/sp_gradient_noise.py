#!/usr/bin/env python3
"""Where sequence-parallel training's f32 gradient parts from one
process's, on one card, in chip_smoke.py 18d's setting: phase 4's
full-width weights, phase 14c's rows (B=8, T=1024), dp = 1 x sp = 2 over
two gloo ranks sharing the card, no regularizers, TF32 off; the noise and
t drawn from each of SEEDS (18d draws from the first); each in torch's
default mode and under chip_smoke.py's ``_deterministic`` (18d's):

* every tensor's relative L2 between the ranks' synced gradient and one
  process's, the largest named;
* one process's gradient computed twice, and the first seed's SP gradient
  twice: whether each is reproducible on the card;
* for each 0-d ``norm.log_scale`` of the text encoder, whose gradient is
  sum(g * y) over the norm's output y and its cotangent g: the
  cancellation kappa = sum|g y| / |sum g y|; the relative L2 between a
  rank's cotangent and one process's (the text encoder's forward is
  replicated bit for bit, so the cotangent is where the runs part); and
  the reading taken apart (signed, over |sum g y|, the sums in f64):
  sum (g_sp - g) y, the part the cotangent difference alone gives, and
  each run's own f32 rounding, its gradient less its sum g y.

    python3 tools/sp_gradient_noise.py

Prints a line a seed and a summary, with the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEEDS = (19, 20, 21, 22)


def _rel(a, b) -> float:
    """chip_smoke.py 18d's relative L2."""
    return float((a - b).norm()) / max(float(b.norm()), float(a.norm()), 1e-30)


def _taps(model):
    """Keep each text-encoder norm's output y and its cotangent g (by the
    name of its log_scale) while the returned dict lives; ``nn/zipformer.
    bias_norm`` wrapped until ``restore()``."""
    from zipvoice_tpu_torch.nn import zipformer as zf

    names = {id(p): n for n, p in model.named_parameters()
             if n.startswith("text_encoder.") and n.endswith("norm.log_scale")}
    taps = {n: {} for n in names.values()}
    norm = zf.bias_norm

    def tapped(x, bias, log_scale):
        y = norm(x, bias, log_scale)
        name = names.get(id(log_scale))
        if name is not None and y.requires_grad:
            # the remat recompute's y is the forward's bit for bit; only the
            # forward's is differentiated, so only its hook fires
            taps[name]["y"] = y.detach().double().cpu()
            y.register_hook(lambda g: taps[name].__setitem__("g", g.detach().double().cpu()))
        return y

    zf.bias_norm = tapped

    def restore():
        zf.bias_norm = norm

    return taps, restore


MODES = ("default", "deterministic")


def _gradient(model, cfg, seed: int, mode: str, seq=None):
    """compute_fm_loss's gradient on 18d's rows and draws in ``mode`` (synced
    over data x seq under ``seq``), returned on the CPU."""
    import contextlib

    import chip_smoke as cs
    from zipvoice_tpu_torch.models import zipvoice as zv
    from zipvoice_tpu_torch.parallel import mesh

    dev = next(model.parameters()).device
    batch, noise, t = cs._tp_inputs(cfg, seed)
    x = {k: v.to(dev) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    det = cs._deterministic() if mode == "deterministic" else contextlib.nullcontext()
    with det, mesh.use_mesh(seq):
        loss = zv.compute_fm_loss(model, x["tokens"], x["tokens_lens"], x["features"],
                                  x["features_lens"], noise.to(dev), t.to(dev), 9)
        loss.backward()
        if seq is not None:
            mesh.all_reduce_gradients(list(model.parameters()), [loss.detach()],
                                      zv.seq_replicated_params(model))
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def _rank(root: str, out: str, seeds):
    """One of two gloo ranks sharing the card: in each mode, the synced SP
    gradient and the text-encoder cotangents for each seed, then the first
    seed's again; rank 0 saves them (``sp-<mode>-<i>.pt``)."""
    import torch

    sys.path.insert(0, str(REPO))
    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    dev = mesh.init_from_env("cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model_dir(root, tokenizer_name="simple").model.to(dev)
    taps, restore = _taps(model)
    sp = mesh.make_dp_sp_mesh(1, 2)
    for mode in MODES:
        for i, seed in enumerate([*seeds, seeds[0]]):
            grads = _gradient(model, model.cfg, seed, mode, sp)
            if mesh.rank() == 0:
                torch.save({"grads": grads, "g": {n: v["g"] for n, v in taps.items()}},
                           Path(out) / f"sp-{mode}-{i}.pt")
    restore()
    mesh.shutdown()


def analyse(root: Path, out: Path, seeds, card: str) -> dict:
    """One process's gradients (twice a seed) against the ranks' saved
    ones in each mode; prints a line a mode and seed and a summary a mode;
    returns the readings."""
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_model_dir(str(root), tokenizer_name="simple").model.cuda()
    taps, restore = _taps(model)
    res = {}
    for mode in MODES:
        res[mode] = _analyse_mode(model, taps, out, seeds, mode, card)
    restore()
    return res


def _analyse_mode(model, taps, out: Path, seeds, mode: str, card: str) -> dict:
    import torch

    res = {"seeds": []}
    for i, seed in enumerate(seeds):
        one = _gradient(model, model.cfg, seed, mode)
        kept = {n: dict(v) for n, v in taps.items()}
        again = _gradient(model, model.cfg, seed, mode)
        saved = torch.load(out / f"sp-{mode}-{i}.pt")
        errs = {n: _rel(saved["grads"][n], g) for n, g in one.items()}
        worst = sorted(errs, key=errs.get, reverse=True)[:4]
        reruns = {n: _rel(again[n], g) for n, g in one.items()}
        rerun = max(reruns, key=reruns.get)
        scalars = {}
        for n, v in kept.items():
            y, g, g_sp = v["y"], v["g"], saved["g"][n]
            total, total_sp = float((g * y).sum()), float((g_sp * y).sum())
            scalars[n] = {"reading": errs[n],
                          "signed": float(saved["grads"][n] - one[n]) / abs(total),
                          "kappa": float((g * y).abs().sum()) / abs(total),
                          "cotangent": _rel(g_sp, g),
                          "from_cotangent": (total_sp - total) / abs(total),
                          "rounding_one": (float(one[n]) - total) / abs(total),
                          "rounding_sp": (float(saved["grads"][n]) - total_sp) / abs(total)}
        res["seeds"].append({"seed": seed, "errs": {n: errs[n] for n in worst},
                             "one_rerun": reruns[rerun], "scalars": scalars})
        top = max(scalars, key=lambda n: scalars[n]["reading"])
        print(f"{mode}, seed {seed}: SP against one process, largest relative L2 a tensor "
              + ", ".join(f"{n} {errs[n]:.3g}" for n in worst)
              + f"; one process against itself {reruns[rerun]:.3g} ({rerun}); text-encoder "
              f"log_scale readings "
              + ", ".join(f"{n.removeprefix('text_encoder.').removesuffix('.norm.log_scale')} "
                          f"{s['reading']:.3g}" for n, s in scalars.items())
              + f"; the largest ({top}): kappa {scalars[top]['kappa']:.4g}, its cotangent's "
              f"relative L2 {scalars[top]['cotangent']:.3g}; signed {scalars[top]['signed']:.3g}"
              f" = from the cotangent {scalars[top]['from_cotangent']:.3g} + the SP run's f32 "
              f"rounding {scalars[top]['rounding_sp']:.3g} - one process's "
              f"{scalars[top]['rounding_one']:.3g} on {card}", flush=True)
    first, last = (torch.load(out / f"sp-{mode}-{i}.pt")["grads"] for i in (0, len(seeds)))
    res["sp_rerun"] = max(_rel(last[n], g) for n, g in first.items())
    worst = max(s["scalars"][n]["reading"] for s in res["seeds"] for n in s["scalars"])
    print(f"{mode}, summary over seeds {list(seeds)}: the largest SP reading a tensor "
          f"{max(max(s['errs'].values()) for s in res['seeds']):.3g} (18d's tolerance 1e-5), "
          f"of a text-encoder log_scale {worst:.3g}; one process against itself "
          f"{max(s['one_rerun'] for s in res['seeds']):.3g}, SP against itself "
          f"{res['sp_rerun']:.3g} on {card}", flush=True)
    return res


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from zipvoice_tpu_torch.ops import build
    from zipvoice_tpu_torch.train.dryrun import spawn

    if not torch.cuda.is_available():
        print("sp_gradient_noise: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    t0 = time.monotonic()
    build.build_all()
    print(f"build {time.monotonic() - t0:.1f} s", flush=True)
    root = Path(tempfile.mkdtemp(prefix="sp-noise-", dir=build.build_dir()))
    cs.make_assets(root)
    out = root / "out"
    out.mkdir()
    t0 = time.monotonic()
    spawn("sp_gradient_noise:_rank", 2, {"root": str(root), "out": str(out),
                                         "seeds": list(SEEDS)},
          timeout=900, path=[str(Path(__file__).resolve().parent)])
    print(f"ranks {time.monotonic() - t0:.1f} s", flush=True)
    analyse(root, out, SEEDS, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
