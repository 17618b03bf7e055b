#!/usr/bin/env python3
"""int8-dynamic at short and narrow shapes on one card, and the card
machine's packaging tools:

* whether ``setuptools`` and ``pip`` import (``chip_smoke.py`` phase 20
  builds the port's wheel with them) and whether ``sitecustomize`` and
  ``wheel`` do;
* phase 4's full-width model dir through the infer CLI with
  ``--quantize int8-dynamic``, one batch-1 request of 16 tokens (prompt
  transcript and text) and one of 68, with every (M, K, N) that reaches
  ``nn/functional.linear_int8`` recorded (the pipeline pads the tokens to
  its 32-token bucket);
* ``linear_int8(dynamic=True)`` at M = 1, 16 and 17, and ``torch._int_mm``
  itself at those M and at K or N off a multiple of 8: whether each runs
  or what it raises.

    python3 tools/int8_short_probe.py

Builds only the libraries of the unfused inference path (B1, B2, B8).
Prints each result with the card's name and power limit.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

SHORT = ("hello", "the red fox")
LONG = (cs.PROMPT_TEXT, "the quick brown fox")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_short_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    for module in ("setuptools", "pip", "sitecustomize", "wheel"):
        p = subprocess.run([sys.executable, "-c", f"import {module}; print({module}.__file__, "
                            f"getattr({module}, '__version__', ''))"],
                           capture_output=True, text=True)
        print(f"import {module}: exit {p.returncode} {p.stdout.strip()} "
              f"{p.stderr.strip()[-200:]}", flush=True)

    from zipvoice_tpu_torch.bin.infer_zipvoice import main as cli_main
    from zipvoice_tpu_torch.nn import functional as F
    from zipvoice_tpu_torch.nn import zipformer as zf
    from zipvoice_tpu_torch.ops import build
    from zipvoice_tpu_torch.ops.quant import quantize_weight

    build.SOURCES = ("rel_probs", "probs_apply", "log_mel")
    build.build_all()
    root = Path(tempfile.mkdtemp(prefix="int8-probe-"))
    shapes = []
    plain = zf.linear_int8

    def recorded(x, w, s, b=None, dynamic=False):
        shapes.append((x.numel() // x.shape[-1], w.shape[1], w.shape[0]))
        return plain(x, w, s, b, dynamic)

    try:
        cs.make_assets(root)
        zf.linear_int8 = recorded
        for prompt_text, text in (SHORT, LONG):
            (root / "list.tsv").write_text(
                f"probe\t{prompt_text}\t{root / 'prompt.wav'}\t{text}\n")
            shapes.clear()
            try:
                cli_main(["--model-dir", str(root), "--vocoder-path", str(root / "vocos.bin"),
                          "--tokenizer", "simple", "--test-list", str(root / "list.tsv"),
                          "--res-dir", str(root / "out"), "--num-step", "16",
                          "--guidance-scale", "1.0", "--dtype", "float32", "--device", "cuda",
                          "--quantize", "int8-dynamic"])
                outcome = "exit 0"
            except Exception as ex:  # the finding: what the request raised
                outcome = f"raised {type(ex).__name__}: {ex}"
            print(f"request of {len(prompt_text) + len(text)} tokens: {outcome}; (M, K, N) into "
                  f"linear_int8: {sorted(set(shapes))} on {card}", flush=True)
    finally:
        zf.linear_int8 = plain
        shutil.rmtree(root, ignore_errors=True)

    wq, ws = quantize_weight(torch.randn(512, 192) * 0.05)
    wq, ws = wq.cuda(), ws.cuda()

    def attempt(label, fn):
        try:
            fn()
            print(f"{label}: runs on {card}", flush=True)
        except (RuntimeError, ValueError) as ex:
            print(f"{label}: raised {type(ex).__name__}: {str(ex)[:300]} on {card}", flush=True)

    for m in (1, 16, 17):
        attempt(f"linear_int8 dynamic M={m} K=192 N=512", lambda m=m: F.linear_int8(
            torch.randn(m, 192, device="cuda"), wq, ws, dynamic=True))
        attempt(f"torch._int_mm M={m} K=192 N=512", lambda m=m: torch._int_mm(
            torch.zeros(m, 192, dtype=torch.int8, device="cuda"), wq.t()))
    for k, n in ((100, 100), (96, 36)):
        attempt(f"torch._int_mm M=32 K={k} N={n}", lambda k=k, n=n: torch._int_mm(
            torch.zeros(32, k, dtype=torch.int8, device="cuda"),
            torch.zeros(n, k, dtype=torch.int8, device="cuda").t()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
