"""Run-start manifests (the JAX package's ``obs/run_manifest.py``).

``manifest.json``, written beside ``metrics.jsonl``, makes the stream
self-describing: the config dataclass, the torch, CUDA and cuDNN
versions, the device's name, the process group's backend and world,
and the git commit when the package lives in a checkout. Rank 0 writes
it, atomically (a tmp file and ``os.replace``), so a crash never leaves
a torn manifest beside a valid stream.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import platform
import subprocess
import sys
from typing import Any, Mapping

import torch
import torch.distributed as dist

__all__ = ["build_manifest", "read_manifest", "write_manifest"]

MANIFEST_NAME = "manifest.json"


def _git_sha() -> str | None:
    """The commit of the checkout this package lives in, or None."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
                             text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _config_dict(config: Any) -> Any:
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return json.loads(json.dumps(dataclasses.asdict(config), default=str))
    if isinstance(config, Mapping):
        return json.loads(json.dumps(dict(config), default=str))
    return str(config)


def _group() -> tuple[str | None, int, int]:
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend()), dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def build_manifest(config: Any = None, device: Any = None, **extra: Any) -> dict[str, Any]:
    """The manifest as a dict; ``device`` is the run's ``torch.device``."""
    device = torch.device(device) if device is not None else None
    on_card = device is not None and device.type == "cuda"
    backend, world, rank = _group()
    manifest: dict[str, Any] = {
        "kind": "manifest",
        "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "argv": list(sys.argv),
        "python_version": platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cudnn_version": (torch.backends.cudnn.version()
                          if torch.backends.cudnn.is_available() else None),
        "device": None if device is None else str(device),
        "device_name": torch.cuda.get_device_name(device) if on_card else None,
        "device_count": torch.cuda.device_count() if on_card else 0,
        "backend": backend,
        "world_size": world,
        "rank": rank,
        "hostname": platform.node(),
        "git_sha": _git_sha(),
        "config": _config_dict(config),
    }
    manifest.update(extra)
    return manifest


def write_manifest(path: str, config: Any = None, device: Any = None,
                   **extra: Any) -> str | None:
    """Write ``manifest.json`` under directory ``path`` (or to ``path``
    when it ends in .json). Returns the file's path, None on ranks > 0."""
    if _group()[2] != 0:
        return None
    if path.endswith(".json"):
        target = path
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, MANIFEST_NAME)
    manifest = build_manifest(config=config, device=device, **extra)
    tmp = target + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, target)
    return target


def read_manifest(path: str) -> dict[str, Any]:
    """A manifest from its file or the directory that holds it."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    with open(path, encoding="utf-8") as f:
        return json.load(f)
