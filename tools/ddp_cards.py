#!/usr/bin/env python3
"""Data-parallel training over every NVIDIA card of one host: the port's
train CLI with --distributed under ``torchrun --nproc-per-node N`` (NCCL),
at full width (123M, seeded random weights) in bf16, on a 32-file random
corpus (chip_smoke.py's phase 8 corpus, twice as many files, so that every
rank gets its 6 steps).

    python3 tools/ddp_cards.py

Each rank is chip_smoke.py's 14a worker: its kernel launches counted, its
last step profiled (the gradient sync's range ``all_reduce_gradients``:
the flatten, the NCCL all-reduce and the views back), its trained
parameters digested.  Prints one line a rank (losses, launches a step,
the warm step ms as the median of the intervals between its second and
last step, the profiled step's wall and device busy ms, the NCCL kernels'
device ms, the sync's device and host ms, peak memory), whether the ranks'
parameters are bit-identical, and which files the exp dir holds (rank
0's).  Exits non-zero if torchrun fails or the parameters differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    from zipvoice_tpu_torch.ops import build

    card = cs.card_line()
    n = torch.cuda.device_count()
    print(f"{card}, {n} cards", flush=True)
    t0 = time.monotonic()
    build.build_all()
    print(f"build {time.monotonic() - t0:.1f} s", flush=True)
    root = Path(tempfile.mkdtemp(prefix="ddp-", dir=build.build_dir()))
    cs.make_assets(root)
    manifest = cs.make_corpus(root, n=32)
    out = root / "ranks"
    out.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), str(REPO / "chip_smoke.py"), "--ddp-worker", str(out),
           *cs._train_argv(root, manifest, root / "exp", cs.DDP_STEPS, "--distributed")]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    print(f"torchrun exit {proc.returncode} in {time.monotonic() - t0:.1f} s", flush=True)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
        return 1
    ranks = [json.loads((out / f"rank-{r}.json").read_text()) for r in range(n)]
    for r, res in enumerate(ranks):
        steps = len(res["losses"])
        print(f"rank {r}: losses {[round(x, 4) for x in res['losses']]}, launches a step "
              f"{ {k: v / steps for k, v in res['launches'].items()} }, warm step "
              f"{float(np.median(np.diff(res['ends'])[1:-1])) * 1e3:.1f} ms, profiled step "
              f"(features {res['features']}) wall {res['wall_ms']:.1f} ms, busy "
              f"{res['busy_ms']:.1f} ms, backend {res['backend']}, world {res['world']}, NCCL "
              f"kernels {res['nccl']}, sync range {res['sync_device_ms']:.3f} ms device / "
              f"{res['sync_host_ms']:.1f} ms host, peak {res['peak_gib']:.2f} GiB on {card}",
              flush=True)
    same = len({res["digest"] for res in ranks}) == 1
    print(f"parameters bit-identical across the {n} ranks: {same}; exp dir "
          f"{sorted(p.name for p in (root / 'exp').iterdir())}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
