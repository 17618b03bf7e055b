"""An offline Hugging Face Hub cache for the tests of the port's fetching
(``io/model_dir.maybe_download``, the vocoders in ``bin/infer_zipvoice``).

``put`` lays a file out as the hub's cache holds a fetched one
(``models--<org>--<name>/refs/main`` naming a snapshot, the file under
``snapshots/<rev>/``).  ``offline`` points ``huggingface_hub`` at such a
cache with its offline mode on, so that ``hf_hub_download`` answers from
the cache or raises its own error, and makes any lookup of a host other
than this machine raise: no test contacts the network."""

import shutil
import socket
from pathlib import Path

REV = "0123456789abcdef0123456789abcdef01234567"  # a commit hash
_LOCAL = {"localhost", "127.0.0.1", "::1", "", None}


def put(cache: Path, repo_id: str, filename: str, src: Path) -> Path:
    """Copy ``src`` into ``cache`` as ``repo_id``'s ``filename`` at REV."""
    repo = Path(cache) / ("models--" + repo_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True, exist_ok=True)
    (repo / "refs" / "main").write_text(REV)
    dst = repo / "snapshots" / REV / filename
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)
    return dst


def snapshot(cache: Path, repo_id: str) -> Path:
    return Path(cache) / ("models--" + repo_id.replace("/", "--")) / "snapshots" / REV


def offline(monkeypatch, cache: Path):
    """``huggingface_hub`` on ``cache``, offline, for the rest of the test."""
    import huggingface_hub.constants as constants
    from huggingface_hub.utils import reset_sessions

    Path(cache).mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(constants, "HF_HUB_CACHE", str(cache))
    reset_sessions()  # a session made before holds no offline adapter
    lookup = socket.getaddrinfo

    def local_only(host, *args, **kw):
        if host not in _LOCAL:
            raise OSError(f"the tests contact no host: {host}")
        return lookup(host, *args, **kw)

    monkeypatch.setattr(socket, "getaddrinfo", local_only)


def offline_miss(err: BaseException, repo_id: str) -> bool:
    """Whether the hub's error ``err`` came from its offline mode refusing
    to ask the hub for a file of ``repo_id`` (no host was contacted)."""
    from huggingface_hub.errors import LocalEntryNotFoundError, OfflineModeIsEnabled

    cause = err.__cause__ or err.__context__
    return (isinstance(err, LocalEntryNotFoundError) and isinstance(cause, OfflineModeIsEnabled)
            and f"/{repo_id}/resolve/" in str(cause))
