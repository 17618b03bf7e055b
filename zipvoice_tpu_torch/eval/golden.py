"""Golden acceptance: hold a model dir against the port's modules and the
pinned token goldens.

One harness per model variant that runs, in order:

1. **tree check** — the checkpoint's tensors, by name and torch-layout
   shape, equal the variant's module tree built on the meta device from the
   same ``model.json`` (every checkpoint tensor consumed AND every expected
   tensor fed); only then is the checkpoint loaded strictly into the module
   and moved to the device.  Ref zipvoice/utils/checkpoint.py:108-147.
2. **tokenizer check** — the shipped ``tokens.txt`` loads, its vocab size
   matches the checkpoint's embedding table, the dialog variants' speaker
   tokens are present, and a sentence battery reproduces the pinned golden
   token strings (``tests/fixtures/token_goldens.json``) where the G2P
   backends are installed.
3. **mel parity** against the reference ``zipvoice`` package
   (``eval/parity.py``): the port's sampler on the device in f32 and in
   bf16 against the reference's on the CPU in f32, at the variant's
   default sampling settings, within 1e-3 and 1e-2.  It is reported
   ``gated: no reference`` while the reference source is absent (the
   default place is ``reference/`` at the repository root).

The reports have the JAX package's schema (``docs/parity.md``, GOLDEN.json).
Without a model dir the model's files come from the Hugging Face Hub's cache
(``io/model_dir.maybe_download``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from zipvoice_tpu_torch.config import load_model_json
from zipvoice_tpu_torch.io.checkpoint import load_into, load_torch_state_dict
from zipvoice_tpu_torch.eval.parity import BUDGETS, DEFAULT_REFERENCE, run_parity
from zipvoice_tpu_torch.io.model_dir import (
    MODEL_REGISTRY,
    _find_checkpoint,
    build_model,
    maybe_download,
)
from zipvoice_tpu_torch.text import tokenizer as tok_mod
from zipvoice_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
DEFAULT_FIXTURE = REPO / "tests" / "fixtures" / "token_goldens.json"
DIALOG_MODELS = ("zipvoice_dialog", "zipvoice_dialog_stereo")

SENTENCE_BATTERY: List[Dict] = [
    # EN (espeak G2P), ZH (pinyin), pinyin escapes, tags, mixed — the
    # constructions of ref tokenizer.py:640-648's self-test string.  Every
    # entry has its golden pinned in tests/fixtures/token_goldens.json (the
    # EN ones with the G2P backend named in its _provenance block).
    {"lang": "en-us", "text": "Hello world, this is a test."},
    {"lang": "en-us", "text": "How are you doing today? I'm fine; thanks!"},
    {"lang": "zh", "text": "你好世界。"},
    {"lang": "zh", "text": "我们在<zhong1><guo2>说中文。"},
    # tag inside ZH (tag path, ref tokenizer.py:291-293)
    {"lang": "zh", "text": "你好[laughter]世界!"},
    # the full punctuation map exercised between hanzi (ref :369-385)
    {"lang": "zh", "text": "第一,第二;第三:第四?好!"},
    # ZH normalizer: digits -> hanzi via the cn2an-equivalent (numbers.py)
    {"lang": "zh", "text": "我有25个苹果。"},
    # tone sandhi (不/一 rules live in text/pinyin_data.py)
    {"lang": "zh", "text": "一起不要去。"},
    {"lang": "mixed", "text": "Turn it up to 11, 好吗 [laughter]?"},
]

DIALOG_BATTERY: List[Dict] = [
    {"lang": "mixed", "text": "[S1] Hello there. [S2] Hi, how are you?"},
    # fully-offline dialog entry ([S1]/[S2] handling + ZH)
    {"lang": "zh", "text": "[S1] 你好。 [S2] 再见!"},
]


def _roll_up(statuses) -> str:
    statuses = [str(s) for s in statuses]
    return ("fail" if any(s.startswith("fail") for s in statuses)
            else "gated" if any(s.startswith("gated") for s in statuses)
            else "pass")


def _checkpoint_tree(sd: Mapping[str, np.ndarray]) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of a checkpoint as the JAX package reads it back: its
    loader nests the dotted names and flattens them again (a name replaces
    the earlier names it is a prefix of; a leading dot is dropped),
    and its layout round trip refuses a 3-D ``depthwise_conv.weight`` whose
    middle axis is not 1 (``load_torch_state_dict`` has given a 2-D one
    its middle axis, as JAX's reading does)."""
    root: Dict = {}
    for key, arr in sd.items():
        shape = tuple(np.shape(arr))
        if key.endswith("depthwise_conv.weight") and len(shape) == 3 and shape[1] != 1:
            raise ValueError(f"{key}: a depthwise conv weight is (C, 1, K), got {shape}")
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"{key}: a prefix of it names a tensor")
        node[parts[-1]] = shape
    flat: Dict[str, Tuple[int, ...]] = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}.{k}" if name else k)
            return
        flat[name] = node

    walk(root, "")
    return flat


def check_tree(model_name: str, model_dir: Union[str, Path],
               device: Union[str, torch.device] = "cuda") -> Dict:
    """Checkpoint tree vs the variant's module tree: keys and shapes must
    match exactly in both directions.  On a match the checkpoint is loaded
    strictly into the module on ``device``."""
    device = resolve_device(device)
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model_name: {model_name}")
    model_dir = Path(model_dir)
    tokenizer = tok_mod.get_tokenizer("simple", str(model_dir / "tokens.txt"))
    model_cfg, _ = load_model_json(model_dir / "model.json", vocab_size=tokenizer.vocab_size,
                                   pad_id=tokenizer.pad_id)
    sd = load_torch_state_dict(_find_checkpoint(model_dir, None))
    loaded = _checkpoint_tree(sd)
    model = build_model(model_name, model_cfg)
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}

    missing = sorted(set(expected) - set(loaded))
    extra = sorted(set(loaded) - set(expected))
    shape_mismatch = sorted(k for k in set(expected) & set(loaded) if expected[k] != loaded[k])
    ok = not (missing or extra or shape_mismatch)
    if ok:
        load_into(model, sd).float().to(device)
    return {
        "check": "tree",
        "status": "pass" if ok else "fail",
        "n_tensors": len(loaded),
        "missing": missing[:20],
        "extra": extra[:20],
        "shape_mismatch": shape_mismatch[:20],
    }


def check_tokenizer(
    model_name: str,
    model_dir: Union[str, Path],
    fixture_path: Optional[str] = None,
) -> Dict:
    """tokens.txt contract + embedding-row consistency + golden token strings.

    Sub-results are "pass" / "fail" / "gated:<missing dep>": a gated check
    (a G2P backend absent on this machine) does not fail the acceptance but
    is reported, so the report shows exactly what ran.
    """
    model_dir = Path(model_dir)
    token_file = str(model_dir / "tokens.txt")
    result: Dict = {"check": "tokenizer", "sub": {}}

    token_map = tok_mod.read_token_file(token_file)
    ids = sorted(token_map.values())
    result["sub"]["token_file"] = (
        "pass" if len(ids) == len(set(ids)) and ids == list(range(len(ids))) else "fail")
    result["vocab_size"] = len(ids)

    # embedding table rows must equal the tokenizer vocab
    sd = load_torch_state_dict(_find_checkpoint(model_dir, None))
    embed_rows = int(np.shape(sd["embed.weight"])[0])
    result["sub"]["embed_rows"] = (
        "pass" if embed_rows == len(ids) else f"fail ({embed_rows} != {len(ids)})")

    dialog = model_name in DIALOG_MODELS
    if dialog:
        # the dialog vocab extension appends [S1]/[S2] (ref
        # zipvoice_dialog.py:53-54: ids 360/361 in the released vocab)
        has = "[S1]" in token_map and "[S2]" in token_map
        result["sub"]["dialog_tokens"] = "pass" if has else "fail"
        result["spk_ids"] = [token_map.get("[S1]"), token_map.get("[S2]")] if has else None

    # sentence battery -> pinned golden token STRINGS: the segmentation /
    # pinyin-split / punctuation-map logic (ref tokenizer.py:234-296) is what
    # regresses, and strings stay valid whichever tokens.txt ships.  Every
    # entry counts as checked / pending / failed; an all-pending run reports
    # "gated", never a vacuous "pass".
    battery = list(SENTENCE_BATTERY) + (list(DIALOG_BATTERY) if dialog else [])
    tok_name = MODEL_REGISTRY[model_name]["tokenizer"]
    goldens = {}
    if fixture_path is None:
        fixture_path = str(DEFAULT_FIXTURE) if DEFAULT_FIXTURE.exists() else None
    pinned_provenance = None
    if fixture_path and Path(fixture_path).exists():
        fixture = json.loads(Path(fixture_path).read_text())
        goldens = fixture.get(tok_name, {})
        pinned_provenance = fixture.get("_provenance", {}).get(tok_name)
    # which G2P engine produced the EN goldens at pin time and which is
    # active now: a mismatch means the pinned strings certify another engine
    result["en_g2p_backend"] = tok_mod.active_g2p_backend("en-us")
    result["en_g2p_pinned_with"] = (pinned_provenance or {}).get("en_g2p_backend")
    produced = {}
    n_checked, n_pending, failed, crashed = 0, 0, [], []
    tok_cache: Dict[str, object] = {}
    for item in battery:
        try:
            tok = tok_cache.get(item["lang"])
            if tok is None:
                tok = tok_mod.get_tokenizer(tok_name, token_file, lang=item["lang"])
                tok_cache[item["lang"]] = tok
            toks = tok.texts_to_tokens([item["text"]])[0]
            ids_out = tok.tokens_to_token_ids([toks])[0]
            if not toks:
                # the tokenizers log a G2P crash and yield [] (the reference's
                # fail-soft); no battery entry tokenizes to nothing, so [] is
                # a swallowed crash, not a golden mismatch the backend gate
                # below could excuse
                produced[item["text"]] = "error: empty tokenization"
                failed.append(item["text"])
                crashed.append(item["text"])
                continue
        except Exception as e:  # noqa: BLE001
            # only a missing G2P backend is pending; any other exception is
            # a tokenizer crash and fails the battery
            if isinstance(e, (tok_mod.G2PUnavailableError, ImportError)):
                produced[item["text"]] = f"gated: {type(e).__name__}: {e}"
                n_pending += 1
            else:
                produced[item["text"]] = f"error: {type(e).__name__}: {e}"
                failed.append(item["text"])
                crashed.append(item["text"])
            continue
        produced[item["text"]] = {"tokens": toks, "ids": ids_out}
        g = goldens.get(item["text"])
        if g is None:
            n_pending += 1  # produced but nothing pinned to check against
        else:
            n_checked += 1
            if list(g) != list(toks):
                failed.append(item["text"])
    lang_of = {item["text"]: item["lang"] for item in battery}
    # the backend-mismatch gate excuses only golden-string mismatches of EN
    # entries; a crash fails the battery whichever engine is active
    only_en_failed = failed and not crashed and all(
        lang_of.get(t) in ("en-us", "mixed") for t in failed)
    if only_en_failed and result["en_g2p_pinned_with"] not in (None, result["en_g2p_backend"]):
        battery_status = (
            f"gated: goldens pinned with {result['en_g2p_pinned_with']} but "
            f"active G2P is {result['en_g2p_backend']}; re-pin via "
            "tools/pin_token_goldens.py"
        )
    elif failed:
        battery_status = "fail"
    elif n_checked == 0:
        battery_status = "gated: 0 of %d battery entries checked" % len(battery)
    elif n_pending:
        battery_status = f"pass ({n_checked} checked, {n_pending} pending-backend)"
    else:
        battery_status = "pass"
    result["sub"]["battery"] = battery_status
    result["battery_checked"] = n_checked
    result["battery_pending"] = n_pending
    result["battery_failed"] = failed
    result["battery_ids"] = produced
    result["status"] = _roll_up(result["sub"].values())
    return result


def check_parity(
    model_name: str,
    model_dir: Union[str, Path],
    reference_path: Union[str, Path] = DEFAULT_REFERENCE,
    seconds: float = 5.0,
    spk_a_id: Optional[int] = None,
    spk_b_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """f32 + bf16 mel parity at the variant's default sampling settings,
    the port's side on ``device``."""
    reg = MODEL_REGISTRY[model_name]
    out: Dict = {"check": "parity", "sub": {}}
    ok = True
    for dt, budget in BUDGETS.items():
        mse = run_parity(
            str(model_dir), reference_path, num_step=reg["num_step"],
            guidance_scale=reg["guidance_scale"], t_shift=reg["t_shift"],
            seconds=seconds, prompt_seconds=0.4 * seconds, dtype=dt,
            model_name=model_name, spk_a_id=spk_a_id, spk_b_id=spk_b_id, device=device,
        )
        passed = mse < budget
        ok = ok and passed
        out["sub"][dt] = {"mel_mse": float(f"{mse:.3e}"), "budget": budget,
                          "status": "pass" if passed else "fail"}
    out["status"] = "pass" if ok else "fail"
    return out


def golden_acceptance(
    model_name: str,
    model_dir: Optional[Union[str, Path]] = None,
    reference_path: Union[str, Path] = DEFAULT_REFERENCE,
    seconds: float = 5.0,
    fixture_path: Optional[str] = None,
    spk_a_id: Optional[int] = None,
    spk_b_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Run the three checks for one variant; returns the report dict."""
    if model_dir is None:
        model_dir = str(maybe_download(model_name))
    if spk_a_id is None and model_name in DIALOG_MODELS:
        # the [S1]/[S2] ids live in the shipped tokens.txt (ids 360/361 in
        # the released vocab, ref zipvoice_dialog.py:53-54)
        token_map = tok_mod.read_token_file(str(Path(model_dir) / "tokens.txt"))
        spk_a_id = token_map.get("[S1]")
        spk_b_id = token_map.get("[S2]")
    report: Dict = {"model_name": model_name, "model_dir": str(model_dir)}
    checks = [check_tree(model_name, model_dir, device)]
    checks.append(check_tokenizer(model_name, model_dir, fixture_path))
    if Path(reference_path).exists():
        checks.append(check_parity(model_name, model_dir, reference_path, seconds,
                                   spk_a_id=spk_a_id, spk_b_id=spk_b_id, device=device))
    else:
        checks.append({"check": "parity", "status": "gated: no reference"})
        logging.warning("reference repo not found at %s — parity skipped", reference_path)
    report["checks"] = checks
    report["status"] = _roll_up(c["status"] for c in checks)
    return report
