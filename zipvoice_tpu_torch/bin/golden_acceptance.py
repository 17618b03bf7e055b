"""Golden acceptance CLI: certify the port against released checkpoints.

Writes GOLDEN.json (the JAX package's schema, ``docs/parity.md``) with, per
variant: the checkpoint tree against the port's modules (then loaded on
``--device``), the tokenizer contract and golden token strings, and f32 and
bf16 mel parity against the reference ``zipvoice`` package
(``eval/parity.py``), reported ``gated: no reference`` while its source is
absent at --reference-path.

Usage:
  # fetch every model from the Hugging Face Hub's cache (huggingface_hub):
  python -m zipvoice_tpu_torch.bin.golden_acceptance --models all --output GOLDEN.json

  # or with local model dirs ({model.pt | model.safetensors, model.json,
  # tokens.txt} each):
  python -m zipvoice_tpu_torch.bin.golden_acceptance \\
      --models zipvoice,zipvoice_distill \\
      --model-dirs /ckpt/zipvoice,/ckpt/zipvoice_distill --device cuda

  # check the files the run would read, load nothing:
  python -m zipvoice_tpu_torch.bin.golden_acceptance --models all \\
      --model-dirs A,B,C,D --dry-run
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from zipvoice_tpu_torch.eval.golden import DEFAULT_FIXTURE, DEFAULT_REFERENCE, golden_acceptance
from zipvoice_tpu_torch.io.model_dir import HF_REPO, MODEL_FILES, MODEL_REGISTRY
from zipvoice_tpu_torch.utils.device import resolve_device


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", type=str, default="all",
                   help="comma list of variants, or 'all'")
    p.add_argument("--model-dirs", type=str, default=None,
                   help="comma list of local model dirs aligned with --models; "
                        "omit (or leave an entry empty) to fetch from the hub")
    p.add_argument("--reference-path", type=str, default=str(DEFAULT_REFERENCE))
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fixture", type=str, default=str(DEFAULT_FIXTURE),
                   help="golden token fixture (json)")
    p.add_argument("--output", type=str, default="GOLDEN.json")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dry-run", action="store_true",
                   help="verify the files the real run would read and print its "
                        "invocation, without loading weights")
    return p


def _dry_run(names, dirs, args) -> int:
    """Rehearse the acceptance without weights: verify every file the real
    run would read, report what is missing, and print the invocation."""
    report = {"mode": "dry-run", "models": {}}
    ok = True
    for name, d in zip(names, dirs):
        entry = {"files": {}}
        if name not in MODEL_REGISTRY:
            entry["source"] = f"UNKNOWN model '{name}' (known: {', '.join(MODEL_REGISTRY)})"
            ok = False
        elif d is None:
            sub = MODEL_REGISTRY[name]["hf_dir"]
            entry["source"] = f"hf://{HF_REPO}/{sub}/{{{','.join(MODEL_FILES)}}}"
            try:
                import huggingface_hub  # noqa: F401

                entry["hf_hub"] = "importable"
            except ImportError:
                entry["hf_hub"] = "MISSING (pass --model-dirs or install)"
                ok = False
        else:
            entry["source"] = str(Path(d).resolve())
            for f in ("model.json", "tokens.txt"):
                entry["files"][f] = "ok" if (Path(d) / f).exists() else "MISSING"
            have_ckpt = any((Path(d) / c).exists() for c in ("model.pt", "model.safetensors"))
            entry["files"]["model.pt|model.safetensors"] = "ok" if have_ckpt else "MISSING"
            ok = ok and all(v == "ok" for v in entry["files"].values())
        report["models"][name] = entry
    report["fixture"] = "ok" if Path(args.fixture).exists() else f"MISSING: {args.fixture}"
    ok = ok and Path(args.fixture).exists()
    report["reference"] = (
        "ok" if Path(args.reference_path).exists()
        else f"absent: {args.reference_path} (parity will report gated)")
    dirs_arg = (" --model-dirs " + ",".join("" if d is None else str(d) for d in dirs)
                if any(d is not None for d in dirs) else "")
    report["invocation"] = (
        f"python -m zipvoice_tpu_torch.bin.golden_acceptance"
        f" --models {','.join(names)}{dirs_arg}"
        f" --reference-path {args.reference_path}"
        f" --seconds {args.seconds} --output {args.output} --device {args.device}"
    )
    report["expected_output_schema"] = "docs/parity.md#goldenjson-schema"
    report["status"] = "ready" if ok else "not-ready"
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


def main(argv=None) -> int:
    """Run the acceptance; returns the exit code (0 when overall passes)."""
    p = get_parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    names = list(MODEL_REGISTRY) if args.models == "all" else args.models.split(",")
    # an empty entry means "fetch from the hub", so a mixed list round-trips
    # through the dry run's printed invocation
    dirs = ([d or None for d in args.model_dirs.split(",")]
            if args.model_dirs else [None] * len(names))
    if len(dirs) != len(names):
        p.error("--model-dirs must align with --models")

    if args.dry_run:
        return _dry_run(names, dirs, args)

    device = resolve_device(args.device)
    reports = []
    for name, d in zip(names, dirs):
        if name not in MODEL_REGISTRY:
            p.error(f"unknown model: {name}")
        try:
            rep = golden_acceptance(name, d, args.reference_path, args.seconds,
                                    fixture_path=args.fixture, device=device)
        except Exception as e:  # noqa: BLE001 — report, keep certifying the rest
            logging.exception("golden acceptance errored for %s", name)
            rep = {"model_name": name, "status": "error", "error": repr(e)}
        reports.append(rep)
        logging.info("%s: %s", name, rep["status"])

    summary = {
        "overall": ("fail" if any(r["status"] in ("fail", "error") for r in reports)
                    else "pass"),
        "reports": reports,
    }
    Path(args.output).write_text(json.dumps(summary, indent=2))
    print(json.dumps({r["model_name"]: r["status"] for r in reports}))
    return 0 if summary["overall"] == "pass" else 1


if __name__ == "__main__":
    raise SystemExit(main())
