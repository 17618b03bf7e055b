#!/usr/bin/env python3
"""Smoke run of zipvoice_tpu_torch on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases (each raises on failure; nothing is caught):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from zipvoice_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, in f32
     and bf16, at the main-path shapes (B=2, H=4, T in 1024/512/256 with a
     padded tail in one batch row), ragged T (288, 577) and a text-encoder
     T (40); print errors, kernel / plain / library times and the bound;
  4. build a full-width (123M) random ZipVoice model dir, a full-width
     random Vocos checkpoint and a 3 s prompt;
  5. drive the port's CLI: 3 f32 requests (~4, 8, 12 s of text) and one
     bf16 request, 16 steps with CFG; check the wavs and that every request
     launched B1 260 times and B2 520 times;
  6. one full-width fm_decoder forward on the card (kernels) against the
     CPU (plain versions) on the same weights and inputs;
  7. with --profile only: one warm request under torch.profiler (device
     busy share, top kernels; the trace goes to chiprun_out/ if present).

The line before the last is a JSON object with the per-kernel numbers; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without the
zipvoice_tpu_torch package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense), used only for the bound column
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

N_STEP = 16
# text-encoder layers + steps x fm_decoder layers (one 2B CFG batch a step)
B1_PER_REQUEST = 4 + N_STEP * 16
B2_PER_REQUEST = 2 * B1_PER_REQUEST


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of fn() in ms over iters launches, each after an
    L2 flush (the main path finds its inputs cold at long T).  A ~1 ms
    device sleep before each start event lets the host enqueue fn's work
    ahead of the card, so the host's Python time is not counted."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels():
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from zipvoice_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, qd, pd, vd = 2, 4, 32, 4, 12
    cases = [(1024, "main"), (512, "main"), (256, "main"), (288, "ragged"),
             (577, "ragged"), (40, "text")]
    results = {"B1": {}, "B2": {}}
    for t, kind in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            s = torch.finfo(dtype).bits // 8

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, pq = rnd(b, t, h, qd), rnd(b, t, h, qd), rnd(b, t, h, pd)
            pe = rnd(2 * t - 1, h, pd)
            mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
                [t, t - t // 3 - 1], device="cuda")[:, None]

            # B1: probs; the ragged text-encoder batch is B=1 at serving but
            # B=2 here keeps one padded row in every case
            out = att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=dtype)
            ref = att.rel_attention_probs_plain(q, k, pq, pe, mask, out_dtype=dtype)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            # f32: scores reach |s| ~ 30 and are summed in another order than
            # cuBLAS's; bf16: one unit in the last place of a probability <= 1
            tol = 2e-5 if dtype == torch.float32 else 8e-3
            k_ms = time_ms(lambda: att.rel_attention_probs(q, k, pq, pe, mask,
                                                           out_dtype=dtype))
            p_ms = time_ms(lambda: att.rel_attention_probs_plain(q, k, pq, pe, mask,
                                                                 out_dtype=dtype))
            nbytes = s * (2 * b * t * h * qd + b * t * h * pd + (2 * t - 1) * h * pd) \
                + b * t + s * b * h * t * t
            bnd, by = bound_ms(nbytes, 2 * b * h * t * t * (qd + pd), dn)
            results["B1"][(t, dn)] = dict(err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                                          library_ms=None, bound_ms=bnd, bound_by=by)
            print(f"B1 rel_probs T={t} ({kind}) {dn}: max_abs_err {err:.3g} "
                  f"(tol {tol:g}) kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
                  f"bound_ms {bnd:.4f} ({by})", flush=True)
            if not err <= tol:
                raise AssertionError(f"B1 disagrees at T={t} {dn}: {err} > {tol}")

            # B2: probs @ v on the kernel's own probabilities
            probs = out
            v = rnd(b, t, h, vd)
            o = att.rel_attention_probs_apply(probs, v)
            oref = att.rel_attention_probs_apply_plain(probs, v)
            torch.cuda.synchronize()
            scale = max(1.0, float(oref.float().abs().max()))
            err2 = float((o.float() - oref.float()).abs().max())
            tol2 = (2e-5 if dtype == torch.float32 else 8e-3) * scale
            v_hm = v.permute(0, 2, 1, 3).contiguous()  # the library's layout
            k2 = time_ms(lambda: att.rel_attention_probs_apply(probs, v))
            p2 = time_ms(lambda: att.rel_attention_probs_apply_plain(probs, v))
            l2 = time_ms(lambda: torch.matmul(probs, v_hm))
            nbytes2 = s * (b * h * t * t + 2 * b * t * h * vd)
            bnd2, by2 = bound_ms(nbytes2, 2 * b * h * t * t * vd, dn)
            results["B2"][(t, dn)] = dict(err=err2, tol=tol2, ms=k2, plain_ms=p2,
                                          library_ms=l2, bound_ms=bnd2, bound_by=by2)
            print(f"B2 probs_apply T={t} ({kind}) {dn}: max_abs_err {err2:.3g} "
                  f"(tol {tol2:.3g}) kernel_ms {k2:.4f} plain_ms {p2:.4f} "
                  f"library_ms {l2:.4f} bound_ms {bnd2:.4f} ({by2})", flush=True)
            if not err2 <= tol2:
                raise AssertionError(f"B2 disagrees at T={t} {dn}: {err2} > {tol2}")
    return results


def make_assets(root: Path):
    """Phase 4: full-width random model dir, Vocos checkpoint, 3 s prompt."""
    import numpy as np
    import torch

    from zipvoice_tpu_torch.audio.vocos import VocosConfig, init_vocos
    from zipvoice_tpu_torch.audio.wav import write_wav
    from zipvoice_tpu_torch.config import FeatureConfig, ZipVoiceConfig, save_model_json
    from zipvoice_tpu_torch.models.zipvoice import init_zipvoice
    from zipvoice_tpu_torch.text.tokenizer import write_token_file

    chars = "_ abcdefghijklmnopqrstuvwxyz,.'"
    write_token_file({c: i for i, c in enumerate(chars)}, str(root / "tokens.txt"))
    cfg = ZipVoiceConfig(vocab_size=len(chars), pad_id=0)
    save_model_json(root / "model.json", cfg, FeatureConfig())
    model = init_zipvoice(cfg, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    torch.save({"model": model.state_dict()}, root / "model.pt")
    del model
    torch.save(init_vocos(VocosConfig(), torch.Generator().manual_seed(1)),
               root / "vocos.bin")
    sr = 24000
    tt = np.arange(3 * sr) / sr
    rng = np.random.default_rng(0)
    prompt = (0.08 * np.sin(2 * np.pi * 220 * tt) * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
              + 0.01 * rng.standard_normal(tt.shape)).astype(np.float32)
    write_wav(root / "prompt.wav", prompt, sr)
    return n_params


PROMPT_TEXT = "this is a short prompt sentence for the smoke run"
BASE = "the quick brown fox jumps over the lazy dog, and then it runs away. "
TEXTS = {"r4s": BASE[:60], "r8s": (BASE * 2)[:120], "r12s": (BASE * 3)[:180]}


def expected_samples(text: str, prompt_samples: int) -> int:
    """(gen_len - 1) * hop, with gen_len from the token-ratio duration."""
    import numpy as np

    from zipvoice_tpu_torch.audio.mel import compute_num_frames
    from zipvoice_tpu_torch.models.zipvoice import predict_features_lens

    pf = compute_num_frames(prompt_samples, 256)
    total = predict_features_lens(np.array([pf]), np.array([len(PROMPT_TEXT)]),
                                  np.array([len(text)]))[0]
    return (int(total) - pf - 1) * 256


def run_cli(root: Path, names, dtype: str, card: str):
    """Phase 5 helper: one CLI run over `names`; returns its metrics after
    checking the wavs and the per-request kernel launches."""
    import numpy as np

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin.infer_zipvoice import main as cli_main
    from zipvoice_tpu_torch.ops import attention as att

    lst = root / f"list_{dtype}.tsv"
    lst.write_text("".join(f"{n}\t{PROMPT_TEXT}\t{root / 'prompt.wav'}\t{TEXTS[n]}\n"
                           for n in names))
    out_dir = root / f"out_{dtype}"
    att.rel_attention_probs.launches = 0
    att.rel_attention_probs_apply.launches = 0
    metrics = cli_main([
        "--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
        "--tokenizer", "simple", "--test-list", str(lst), "--res-dir", str(out_dir),
        "--num-step", str(N_STEP), "--guidance-scale", "1.0", "--dtype", dtype,
        "--device", "cuda",
    ])
    launches = (att.rel_attention_probs.launches, att.rel_attention_probs_apply.launches)
    want = (B1_PER_REQUEST * len(names), B2_PER_REQUEST * len(names))
    if launches != want:
        raise AssertionError(f"{dtype}: kernel launches {launches}, expected {want}")
    for n, m in zip(names, metrics):
        wav, sr = read_wav(out_dir / f"{n}.wav")
        exp = expected_samples(TEXTS[n], 3 * 24000)
        if sr != 24000 or wav.shape != (1, exp) or not np.isfinite(wav).all():
            raise AssertionError(f"{n} {dtype}: wav {wav.shape} sr {sr}, want (1, {exp})")
        print(f"request {n} {dtype}: {m['wav_seconds']:.2f} s audio, "
              f"rtf {m['rtf']:.4f} (model {m['rtf_no_vocoder']:.4f}, vocoder "
              f"{m['rtf_vocoder']:.4f}) on {card}", flush=True)
    return metrics, launches


def check_forward_against_cpu(root: Path):
    """Phase 6: one full-width fm_decoder velocity on the card (kernels) and
    on the CPU (plain versions), same weights and inputs, T=256 with a
    padded tail."""
    import torch

    from zipvoice_tpu_torch.io.model_dir import load_model_dir
    from zipvoice_tpu_torch.models.zipvoice import forward_fm_decoder

    model = load_model_dir(str(root), tokenizer_name="simple").model.eval()
    g = torch.Generator().manual_seed(3)
    b, t, f = 2, 256, model.cfg.feat_dim
    xt, tc, sc = (torch.randn((b, t, f), generator=g) for _ in range(3))
    mask = torch.arange(t)[None, :] >= torch.tensor([t, 200])[:, None]
    with torch.no_grad():
        ref = forward_fm_decoder(model, 0.3, xt, tc, sc, mask)
        model = model.cuda()
        out = forward_fm_decoder(model, 0.3, xt.cuda(), tc.cuda(), sc.cuda(),
                                 mask.cuda()).cpu()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"fm_decoder forward, card vs CPU: max_abs_err {err:.3g} "
          f"(|ref| max {scale:.3g}, tol {1e-3 * scale:.3g})", flush=True)
    if not err <= 1e-3 * scale:
        raise AssertionError(f"fm_decoder card vs CPU: {err}")
    return err


def profile_request(root: Path, card: str):
    """Optional phase (--profile): one warm f32 ~8 s request under
    torch.profiler; prints the device busy share and the kernels that take
    the most device time, and writes the trace under chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zipvoice_tpu_torch.audio.wav import read_wav
    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline, get_parser

    args = get_parser().parse_args([
        "--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
        "--tokenizer", "simple", "--device", "cuda"])
    pipeline, _, _ = build_pipeline(args)
    prompt, sr = read_wav(root / "prompt.wav")
    kw = dict(text=TEXTS["r8s"], prompt_text=PROMPT_TEXT, prompt_wav=prompt,
              prompt_sr=sr, num_step=N_STEP, guidance_scale=1.0)
    pipeline.synthesize(**kw)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = pipeline.synthesize(**kw)
        wall = time.monotonic() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    from torch.autograd import DeviceType

    # device-side entries only (CPU ops repeat their kernels' time)
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events) / 1e6
    print(f"profile r8s f32: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%), rtf {res.metrics['rtf']:.4f} on {card}")
    for e in events[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    out = REPO / "chiprun_out"
    if out.is_dir():
        prof.export_chrome_trace(str(out / "trace_r8s_f32.json"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "zipvoice_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout that holds zipvoice_tpu_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from zipvoice_tpu_torch.ops import attention as att
    from zipvoice_tpu_torch.ops import build

    t_start = time.monotonic()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.monotonic()
    logs = build.build_all()
    print(f"kernel build: {time.monotonic() - t0:.1f} s for {sorted(logs)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = check_kernels()

    build.BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="smoke-", dir=build.BUILD))
    try:
        t0 = time.monotonic()
        n_params = make_assets(root)
        print(f"assets: {n_params / 1e6:.1f}M-parameter model in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        metrics, launches = run_cli(root, list(TEXTS), "float32", card)
        run_cli(root, ["r8s"], "bfloat16", card)
        fwd_err = check_forward_against_cpu(root)
        if "--profile" in sys.argv[1:]:
            profile_request(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def entry(key, name, src, replaces, n):
        main_case = results[key][(1024, "float32")]
        every = results[key].values()
        return {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n, "launches_per_request": n // len(TEXTS),
            "max_abs_err": max(r["err"] for r in every),
            "max_abs_err_f32": max(r["err"] for (t, d), r in results[key].items()
                                   if d == "float32"),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "shape": "B=2 H=4 T=1024 f32",
        }

    kernels = [
        entry("B1", "rel_attention_probs", "zipvoice_tpu_torch/csrc/rel_probs.cu",
              "zipvoice_tpu/ops/attention.py:979", launches[0]),
        entry("B2", "rel_attention_probs_apply", "zipvoice_tpu_torch/csrc/probs_apply.cu",
              "zipvoice_tpu/ops/attention.py:1110", launches[1]),
    ]
    rtf = [round(m["rtf"], 5) for m in metrics]
    print(f"f32 rtf per request {rtf}; fm_decoder card-vs-cpu err {fwd_err:.3g}; "
          f"total {time.monotonic() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
