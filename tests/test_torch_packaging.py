"""The port as an installed package, on the CPU: the wheel built offline
holds every native source; installed with pip --target, the package imported
from outside the repo names its nine kernel libraries as the checkout does,
builds its native loader in its own build directory and starts its console
scripts; the six ``zipvoice-torch-*`` entries resolve into
zipvoice_tpu_torch, answer --help without JAX and exit 0 after a good run;
the build directory falls back to a per-user cache where the package's own
``build/`` cannot be made."""

import importlib
import json
import os
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import pytest
import torch

import chip_smoke
from zipvoice_tpu_torch.ops import build, native

# torch's CPU ops share one OpenMP pool a process; pytest-xdist runs a
# process a worker, and pools sized to every core oversubscribe the machine
# by the worker count, which slows torch's ops by orders of magnitude
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = Path(__file__).resolve().parent.parent
PORT_SCRIPTS = {
    "zipvoice-torch-infer": "zipvoice_tpu_torch.bin.infer_zipvoice:cli",
    "zipvoice-torch-infer-dialog": "zipvoice_tpu_torch.bin.infer_zipvoice_dialog:cli",
    "zipvoice-torch-train": "zipvoice_tpu_torch.bin.train_zipvoice:cli",
    "zipvoice-torch-export": "zipvoice_tpu_torch.bin.export_model:main",
    "zipvoice-torch-serve": "zipvoice_tpu_torch.bin.serve:main",
    "zipvoice-torch-golden": "zipvoice_tpu_torch.bin.golden_acceptance:main",
}
JAX_SCRIPTS = {
    "zipvoice-infer": "zipvoice_tpu.bin.infer_zipvoice:main",
    "zipvoice-infer-dialog": "zipvoice_tpu.bin.infer_zipvoice_dialog:main",
    "zipvoice-train": "zipvoice_tpu.bin.train_zipvoice:main",
    "zipvoice-export": "zipvoice_tpu.bin.export_model:main",
    "zipvoice-serve": "zipvoice_tpu.bin.serve:main",
    "zipvoice-golden": "zipvoice_tpu.bin.golden_acceptance:main",
}


def _scripts():
    return tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]


def _entry(target: str):
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """``chip_smoke.build_wheel``: the wheel built offline from a copy of
    the tree, checked to hold every native source."""
    pytest.importorskip("setuptools", reason="building the wheel needs setuptools")
    return chip_smoke.build_wheel(tmp_path_factory.mktemp("wheel"))


def test_wheel_holds_every_native_source(wheel):
    sources = chip_smoke.native_sources()
    assert len(sources) == 19 and len([n for n in sources if "/csrc/" in n]) == 18
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        entry_points = next(z.read(n).decode() for n in names
                            if n.endswith(".dist-info/entry_points.txt"))
    assert sources <= names, sorted(sources - names)
    assert not [n for n in names if n.endswith(".so") or "/build/" in n]
    for name, target in PORT_SCRIPTS.items():
        assert f"{name} = {target}" in entry_points


def test_installed_copy_builds_from_its_own_sources(wheel, tmp_path):
    """``chip_smoke.install_wheel`` (pip --target, then a probe from a
    directory outside the repo): the installed package's file, its build
    directory, the names of its nine libraries (equal to the checkout's,
    so every source and header is installed and identical) and its native
    loader, built by g++ in its own build/; the console scripts."""
    site = (tmp_path / "site").resolve()
    got = chip_smoke.install_wheel(wheel, site)
    assert sorted(p.name for p in (site / "bin").iterdir()) == sorted(
        [*PORT_SCRIPTS, *JAX_SCRIPTS])
    pkg = site / "zipvoice_tpu_torch"
    assert Path(got["file"]) == pkg / "__init__.py"
    assert Path(got["build_dir"]) == pkg / "build"
    assert got["names"] == {n: build.library_path(n).name for n in build.SOURCES}
    assert len(got["names"]) == 9
    assert got["native"] and Path(got["native_path"]) == pkg / "build" / native.library_path().name
    assert Path(got["native_path"]).exists()


def test_port_scripts_resolve_into_the_port():
    scripts = _scripts()
    for name, target in JAX_SCRIPTS.items():
        assert scripts[name] == target
    assert {k: v for k, v in scripts.items() if k.startswith("zipvoice-torch-")} == PORT_SCRIPTS
    for target in PORT_SCRIPTS.values():
        assert target.startswith("zipvoice_tpu_torch.bin.")
        assert callable(_entry(target))


_HELP = r"""
import json, sys
from importlib import import_module
module, attr = sys.argv[1].split(":")
sys.argv = [sys.argv[2], "--help"]
try:
    code = getattr(import_module(module), attr)()
except SystemExit as ex:
    code = ex.code
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zipvoice_tpu"))
print(json.dumps({"code": code, "jax": jax}))
"""


@pytest.fixture(scope="module")
def helps():
    """{script: (exit code, stdout)} of each port entry's --help, run as its
    console script runs it, all six processes at once."""
    procs = {name: subprocess.Popen([sys.executable, "-c", _HELP, target, name], cwd=REPO,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, target in PORT_SCRIPTS.items()}
    return {name: (p.wait(timeout=300), p.communicate()[0]) for name, p in procs.items()}


@pytest.mark.parametrize("name", list(PORT_SCRIPTS))
def test_help_exits_zero_without_jax(helps, name):
    rc, out = helps[name]
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res == {"code": 0, "jax": []}
    assert f"usage: {name}" in out


@pytest.mark.parametrize("name,returned", [
    ("zipvoice-torch-infer", [{"rtf": 0.1, "wav_seconds": 2.0}]),
    ("zipvoice-torch-infer-dialog", [{"rtf": 0.1, "wav_seconds": 2.0}]),
    ("zipvoice-torch-train", {"trainer": object(), "steps": [(1.0, 2.4)]}),
])
def test_entry_exits_zero_after_a_good_run(monkeypatch, name, returned):
    """The console script runs ``sys.exit(entry())``: an entry whose main
    returns metrics or a dict still exits 0 (``sys.exit`` on the value
    itself would print it and exit 1)."""
    module = importlib.import_module(PORT_SCRIPTS[name].split(":")[0])
    argv = []
    monkeypatch.setattr(module, "main", lambda a=None: argv.append(a) or returned)
    with pytest.raises(SystemExit) as ex:
        sys.exit(_entry(PORT_SCRIPTS[name])())
    assert ex.value.code == 0 and argv == [None]


def test_build_dir_is_the_package_build_in_the_checkout():
    want = REPO / "zipvoice_tpu_torch" / "build"
    assert build.build_dir() == want
    assert build.library_path("probs_apply").parent == want
    assert native.library_path().parent == want


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch, cache):
    """A package build/ under a regular file cannot be made, even as root:
    both libraries go to $XDG_CACHE_HOME (or ~/.cache)/zipvoice_tpu_torch/build."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    if cache == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "zipvoice_tpu_torch" / "build"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        want = tmp_path / "home" / ".cache" / "zipvoice_tpu_torch" / "build"
    assert build.build_dir(blocker / "build") == want
    assert want.is_dir() and blocker.is_file()
    monkeypatch.setattr(native, "_PREFERRED", blocker / "build")
    assert native.library_path().parent == want
