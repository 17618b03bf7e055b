"""One rank of tests/test_torch_sequence_parallel.py, started by
``zipvoice_tpu_torch.train.dryrun.spawn`` (imports torch and the port
only): ``sp_sample`` over a seq mesh of every rank on the full inputs,
with the collectives counted and the (Tq, Tk) of every entry into B1's and
B2's plain versions recorded; rank 0 saves the output."""

import json
from pathlib import Path

import numpy as np
import torch


def run(cfg: str, model_path: str, inputs_path: str, out: str, tag: str, kw: dict):
    from zipvoice_tpu_torch.config import ZipVoiceConfig
    from zipvoice_tpu_torch.io.checkpoint import load_into
    from zipvoice_tpu_torch.models import zipvoice as tzv
    from zipvoice_tpu_torch.ops import attention as ta
    from zipvoice_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    cfg = ZipVoiceConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in json.loads(cfg).items()})
    with torch.device("meta"):
        model = tzv.ZipVoiceModel(cfg)
    model = load_into(model, torch.load(model_path))
    x = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    entries = {"B1": [], "B2": []}
    probs_plain, apply_plain = ta.rel_attention_probs_plain, ta.rel_attention_probs_apply_plain

    def b1(q, k, *a, **kw_):
        entries["B1"].append((q.shape[1], k.shape[1]))
        return probs_plain(q, k, *a, **kw_)

    def b2(probs, v):
        entries["B2"].append(tuple(probs.shape[2:]))
        return apply_plain(probs, v)

    ta.rel_attention_probs_plain, ta.rel_attention_probs_apply_plain = b1, b2
    seq = mesh.make_seq_mesh()
    mesh.reset_counts()
    y = tzv.sp_sample(model, seq, x["tokens"], x["tokens_lens"], x["prompt_features"],
                      x["prompt_features_lens"], x["features_lens"], x["noise"], **kw)
    res = {"counts": dict(mesh.COUNTS), "entries": entries, "out": y}
    torch.save(res, Path(out) / f"{tag}-{mesh.rank()}.pt")
    mesh.shutdown()


def _inputs(seed: int, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# the adjoint checks' shapes: B, frames a rank, channels; halo widths
ADJ_B, ADJ_T, ADJ_C, LEFT, RIGHT = 2, 6, 4, 2, 3


def adjoint_inputs(n: int):
    """The whole inputs of ``adjoints`` over n ranks: x (B, n T, C), each
    rank's cotangent of the gathered, haloed and scattered outputs, the
    balancer's input (channel means and scales away from its limits) and
    the whitening's, and the regularizers' cotangent."""
    t_all = n * ADJ_T
    x = _inputs(1, (ADJ_B, t_all, ADJ_C))
    w_gather = [_inputs(10 + r, (ADJ_B, t_all, ADJ_C)) for r in range(n)]
    w_halo = [_inputs(20 + r, (ADJ_B, LEFT + ADJ_T + RIGHT, ADJ_C)) for r in range(n)]
    w_scatter = [_inputs(30 + r, (ADJ_B, ADJ_T, ADJ_C)) for r in range(n)]
    offset = torch.tensor([-2.0, 0.0, 0.1, 3.0])
    scale = torch.tensor([0.1, 1.0, 4.0, 0.5])
    bal = _inputs(2, (ADJ_B, t_all, ADJ_C)) * scale + offset
    white = _inputs(3, (ADJ_B, t_all, ADJ_C)) @ _inputs(4, (ADJ_C, ADJ_C))
    g = _inputs(5, (ADJ_B, t_all, ADJ_C))
    return dict(x=x, w_gather=w_gather, w_halo=w_halo, w_scatter=w_scatter, bal=bal,
                white=white, g=g)


BALANCER = dict(min_positive=0.4, max_positive=0.6, min_abs=0.5, max_abs=2.0, grad_scale=0.04)
WHITEN = dict(num_groups=2, whitening_limit=1.0, grad_scale=0.1)


def adjoints(out: str):
    """gather_frames, halo and scatter_frames, the balancer and the
    whitening under autograd over a seq mesh of every rank, on this rank's
    frames of ``adjoint_inputs``: each input's gradient of the rank's own
    loss (sum(output * its cotangent)), and the collectives counted."""
    from zipvoice_tpu_torch.nn import regularizers as reg
    from zipvoice_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_from_env("cpu", backend="gloo")
    seq = mesh.make_seq_mesh()
    n, r = seq.size("seq"), seq.index["seq"]
    a = adjoint_inputs(n)
    rows = slice(r * ADJ_T, (r + 1) * ADJ_T)
    res, counts = {}, {}

    def grad_of(name, x, fn, w):
        x = x.clone().requires_grad_(True)
        mesh.reset_counts()
        (fn(x) * w).sum().backward()
        res[name], counts[name] = x.grad, dict(mesh.COUNTS)

    grad_of("gather", a["x"][:, rows], lambda x: mesh.gather_frames(x, seq), a["w_gather"][r])
    grad_of("halo", a["x"][:, rows], lambda x: mesh.halo(x, LEFT, RIGHT, seq), a["w_halo"][r])
    grad_of("scatter", a["x"], lambda x: mesh.scatter_frames(x, seq), a["w_scatter"][r])
    grad_of("balancer", a["bal"][:, rows], lambda x: reg.balancer(x, True, seq=seq, **BALANCER),
            a["g"][:, rows])
    grad_of("whiten", a["white"][:, rows], lambda x: reg.whiten(x, True, seq=seq, **WHITEN),
            a["g"][:, rows])
    torch.save({"grads": res, "counts": counts}, Path(out) / f"adjoints-{r}.pt")
    mesh.shutdown()
