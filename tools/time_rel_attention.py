#!/usr/bin/env python3
"""Device times of the port's rel-position attention kernels (B1-B7), of
the log-mel kernel (B8) and of the fused conv module (B9) on one NVIDIA card, at the shapes
and with the timing of chip_smoke.py, for comparing two checkouts of this
repository on one card in one run.

    python3 tools/time_rel_attention.py [--tree DIR] [--kernels B1,B2,B3,B4,B5,B6,B7,B8,B9]
                                        [--tag NAME] [--ptxas FILE] [--sass FILE]
    python3 tools/time_rel_attention.py [--tree DIR] --full-build
    python3 tools/time_rel_attention.py [--tree DIR] --crossover

--tree is the root of the checkout whose ``zipvoice_tpu_torch`` is timed
(default: this one).  Only the kernel libraries that the chosen kernels
need are built, with nvcc, into that checkout's build directory.  Shapes:
B1 at chip_smoke.py's phase-3 cases (B=2, H=4, T 1024/512/256/288/577/40),
B2 at the same cases (vd 12) on B1's probabilities,
B6 and B7 at its phase-3c cases (T also 1152 and 1408; B7 at C=384, 144 at
T=40), B5 at its APPLY_CASES without the const gate, B4 without the penalty
at phase 3b's H=4 training cases (B=8, T 1024/512/256/288/577/120) and B1
at the same shapes beside it, B3 without the penalty and the const gate at
every one of phase 3b's training cases (H=4 with vd 12; H=1 with vd 384
at T=1024 and 144 at T=120); f32 and bf16 each; B8 at phase 3b's
LOG_MEL_CASES (B=8, f32), with its plain version and the same function
through torch.stft beside it; B9 at phase 3c's CONV_CASES (B=2, f32 and
bf16).  --ptxas writes the
-Xptxas -v lines of the libraries it built to FILE, and --sass their
machine code (cuobjdump -sass), so that two checkouts' compiled code can be
compared.  --full-build times the build of every
kernel library of the checkout (as chip_smoke.py's phase 2 builds them)
into a fresh directory, and times nothing else.  --crossover builds B5's
library twice more, with every width on its narrow route
(-DZV_NARROW_VD=4096) and with every width on its wide one
(-DZV_NARROW_VD=0), and times the two routes side by side at
CROSSOVER_CASES, f32 and bf16 in, out in f32 (the width at which the wide
route starts to win is the crossover rel_apply.cu keeps).
Times are chip_smoke.time_ms (mean of 10 launches, L2 flushed, the host
hidden behind a device sleep), taken from this checkout's chip_smoke.py.

Compare two versions in one call, in turns: parent, change, change,
parent.  Each run prints one line a case and, last, a JSON object
{"tag", "card", "ms": {"B6 T=1024 float32": ms, ...}}.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# the C entry point of each attention kernel, whose library the run builds
SYMBOLS = {"B1": "zv_rel_probs", "B2": "zv_probs_apply", "B3": "zv_rel_apply_bwd",
           "B4": "zv_rel_ds",
           "B5": "zv_rel_apply",
           "B6": "zv_rel_probs_consume", "B7": "zv_rel_head0_consume"}
# the library of each other kernel
LIBRARIES = {"B8": "log_mel", "B9": "conv_glu"}
# B5's (B, H, T, vd) at which --crossover times its two routes
CROSSOVER_CASES = [(8, 4, 1024, vd) for vd in (16, 32, 48, 64, 96, 128)] + [
    (8, 1, 1024, vd) for vd in (32, 64, 96, 128)]


def route_libraries(build):
    """B5's library built with ZV_NARROW_VD set so that every width takes
    the narrow route or the wide one: {route: path}, all compiles at once."""
    import os

    out = build.build_dir() / "crossover"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    srcs = build.sources("rel_apply")
    objs, procs, logs = {}, {}, []
    try:
        for route, narrow_vd in (("narrow", 4096), ("wide", 0)):
            for src in srcs:
                # only rel_apply.cu reads ZV_NARROW_VD; the other sources build once
                key = (route, src) if src == "rel_apply" else ("any", src)
                if key in objs:
                    continue
                objs[key] = out / f"{key[0]}-{src}.o"
                logs.append(open(out / f"{key[0]}-{src}.log", "w"))
                procs[key] = subprocess.Popen(
                    [nvcc, *build.NVCC_FLAGS, f"-DZV_NARROW_VD={narrow_vd}", "-c", "-o",
                     str(objs[key]), str(build.CSRC / f"{src}.cu")], stdout=logs[-1],
                    stderr=subprocess.STDOUT)
        failed = [key for key, proc in procs.items() if proc.wait()]
    finally:
        for log in logs:
            log.close()
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}: see {out}")
    libs = {}
    for route in ("narrow", "wide"):
        libs[route] = out / f"librel_apply-{route}-{os.getpid()}.so"
        subprocess.run([nvcc, "-shared", "-o", str(libs[route]),
                        *(str(objs[(route if src == "rel_apply" else "any", src)])
                          for src in srcs)], check=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--kernels", default="B1,B5,B6,B7")
    ap.add_argument("--tag", default="")
    ap.add_argument("--ptxas", type=Path, default=None)
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--full-build", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if "B4" in kernels and "B1" not in kernels:
        kernels.append("B1")  # B4 is timed beside B1 at its shapes

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # shapes and timing; imports nothing of the port

    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_rel_attention: CUDA is not available", file=sys.stderr)
        return 2
    from zipvoice_tpu_torch.ops import attention as att
    from zipvoice_tpu_torch.ops import build

    if args.full_build:
        with tempfile.TemporaryDirectory(dir=build.build_dir()) as tmp:
            build.build_dir = lambda: Path(tmp)
            t0 = time.monotonic()
            build.build_all()
            seconds = time.monotonic() - t0
        print(json.dumps({"tag": args.tag, "card": cs.card_line(), "full_build_s": seconds,
                          "libraries": len(build.SOURCES)}), flush=True)
        return 0
    if args.crossover:
        import ctypes

        card = cs.card_line()
        libs = route_libraries(build)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ms = {}
        lib, argtypes = att._SIGNATURES["zv_rel_apply"]
        for b, h, t, vd in CROSSOVER_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, pq, pe, mask, v, _ = cs._rel_inputs(gen, b, h, t, vd, dtype)
                outs = {}
                for route, path in libs.items():
                    fn = ctypes.CDLL(str(path)).zv_rel_apply
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    build._entry_points[(lib, "zv_rel_apply")] = fn  # the wrapper calls it

                    def run():
                        return att.rel_attention_apply(q, k, pq, pe, mask, v,
                                                       out_dtype=torch.float32)

                    outs[route] = run()
                    name = f"B5 {route} B={b} H={h} T={t} vd={vd} {str(dtype)[6:]}"
                    ms[name] = cs.time_ms(run)
                    print(f"{args.tag} {name}: {ms[name]:.4f} ms", flush=True)
                ref = att.rel_attention_apply_plain(q, k, pq, pe, mask, v, torch.float32)
                for route, out in outs.items():
                    err = float((out - ref).abs().max()) / max(1.0, float(ref.abs().max()))
                    if not err <= (2e-5 if dtype == torch.float32 else 8e-3):
                        raise AssertionError(f"B5 {route} route at vd={vd} {dtype}: {err}")
        build._entry_points.pop((lib, "zv_rel_apply"), None)
        print(json.dumps({"tag": args.tag, "card": card, "ms": ms}), flush=True)
        return 0
    build.SOURCES = tuple(sorted({LIBRARIES.get(k) or att._SIGNATURES[SYMBOLS[k]][0]
                                  for k in kernels}))
    logs = build.build_all()
    if args.ptxas:  # without the compile times and the per-file namespace hashes
        args.ptxas.write_text("".join(
            f"{name}: {re.sub(r'_GLOBAL__N__[0-9a-f]+_', '_GLOBAL__N__', line.strip())}\n"
            for name, log in sorted(logs.items()) for line in log.splitlines()
            if ("ptxas" in line or "spill" in line) and "Compile time" not in line))
    if args.sass:
        cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
        args.sass.write_text("".join(
            f"{name}: {re.sub(r'_GLOBAL__N__[0-9a-f]+_', '_GLOBAL__N__', line.rstrip())}\n"
            for name in build.SOURCES for line in subprocess.run(
                [str(cuobjdump), "-sass", str(build.library_path(name))], check=True,
                capture_output=True, text=True).stdout.splitlines()))
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}

    def record(name, fn):
        ms[name] = cs.time_ms(fn)
        print(f"{args.tag} {name}: {ms[name]:.4f} ms", flush=True)

    dtypes = (torch.float32, torch.bfloat16)
    if "B4" in kernels:
        for _, b, h, t, vd in cs.TRAIN_ATTN_CASES:
            if h != 4:
                continue
            for dtype in dtypes:
                q, k, pq, pe, mask, _, _ = cs._rel_inputs(gen, b, h, t, vd, dtype, scale=1.5)
                gp = torch.randn((b, h, t, t), generator=gen, device="cuda").to(dtype)
                record(f"B4 B={b} T={t} {str(dtype)[6:]}",
                       lambda: att.rel_attention_ds(q, k, pq, pe, mask, gp))
                record(f"B1 B={b} T={t} {str(dtype)[6:]}",
                       lambda: att.rel_attention_probs(q, k, pq, pe, mask, out_dtype=dtype))
                del gp
    if "B3" in kernels:
        for _, b, h, t, vd in cs.TRAIN_ATTN_CASES:
            for dtype in dtypes:
                q, k, pq, pe, mask, v, g = cs._rel_inputs(gen, b, h, t, vd, dtype, scale=1.5)
                record(f"B3 B={b} H={h} T={t} vd={vd} {str(dtype)[6:]}",
                       lambda: att.rel_attention_consume_bwd(q, k, pq, pe, mask, v, g))
    if {"B1", "B2"} & set(kernels):
        for t, _ in [(1024, 0), (512, 0), (256, 0), (288, 0), (577, 0), (40, 0)]:
            for dtype in dtypes:
                q, k, pq, pe, mask, v, _ = cs._rel_inputs(gen, 2, 4, t, 12, dtype)
                if "B1" in kernels:
                    record(f"B1 T={t} {str(dtype)[6:]}",
                           lambda: att.rel_attention_probs(q, k, pq, pe, mask,
                                                          out_dtype=dtype))
                if "B2" in kernels:
                    probs = att.rel_attention_probs_plain(q, k, pq, pe, mask, out_dtype=dtype)
                    record(f"B2 T={t} {str(dtype)[6:]}",
                           lambda: att.rel_attention_probs_apply(probs, v))
    for t, kind in cs.FUSED_ATTN_CASES:
        for dtype in dtypes:
            if not {"B6", "B7"} & set(kernels):
                break
            q, k, pq, pe, mask, v, _ = cs._rel_inputs(gen, 2, 4, t, 12, dtype)
            if "B6" in kernels:
                record(f"B6 T={t} {str(dtype)[6:]}",
                       lambda: att.rel_attention_probs_consume(q, k, pq, pe, mask, v))
            if "B7" in kernels:
                c = 144 if kind == "text" else 384
                v0 = torch.randn((2, t, c), generator=gen, device="cuda").to(dtype)
                record(f"B7 T={t} C={c} {str(dtype)[6:]}",
                       lambda: att.rel_attention_head0_consume(q, k, pq, pe, mask, v0))
    if "B5" in kernels:
        for b, h, t, vd in cs.APPLY_CASES:
            for dtype in dtypes:
                q, k, pq, pe, mask, v, _ = cs._rel_inputs(gen, b, h, t, vd, dtype)
                record(f"B5 B={b} H={h} T={t} vd={vd} {str(dtype)[6:]}",
                       lambda: att.rel_attention_apply(q, k, pq, pe, mask, v,
                                                       out_dtype=torch.float32))
    if "B8" in kernels:
        from zipvoice_tpu_torch.audio.mel import mel_filterbank
        from zipvoice_tpu_torch.ops import melspec

        fb = torch.from_numpy(mel_filterbank(24000, 1024, 100)).cuda()
        hann = torch.hann_window(1024, device="cuda")
        for label, n, zero_rows in cs.LOG_MEL_CASES:
            wp = cs.log_mel_input(gen, n, zero_rows)
            record(f"B8 {label}", lambda: melspec.fused_log_mel(wp))
            record(f"B8 plain {label}", lambda: melspec.fused_log_mel_plain(wp))
            record(f"B8 cufft {label}", lambda: cs.log_mel_cufft(wp, fb, hann))
    if "B9" in kernels:
        from zipvoice_tpu_torch.ops.convglu import conv_glu_swoosh_out

        for c, kk, t in cs.CONV_CASES:
            w = 0.2 * torch.randn((c, 1, kk), generator=gen, device="cuda")
            bias = 0.1 * torch.randn((c,), generator=gen, device="cuda")
            w_out = (torch.rand((c, c), generator=gen, device="cuda") * 2 - 1) / c ** 0.5
            b_out = 0.01 * torch.randn((c,), generator=gen, device="cuda")
            mask = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
                [t, t - t // 3 - 1], device="cuda")[:, None]
            proj32 = torch.randn((2, t, 2 * c), generator=gen, device="cuda")
            for dtype in dtypes:
                proj = proj32.to(dtype)
                record(f"B9 C={c} K={kk} T={t} {str(dtype)[6:]}",
                       lambda: conv_glu_swoosh_out(proj, w, bias, mask, w_out, b_out))
    print(json.dumps({"tag": args.tag, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
