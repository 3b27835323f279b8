"""Calibrated-profile persistence: one JSON file per device kind.

Layout: ``<registry>/<device_kind>.json`` where ``<registry>`` is the
``REPRO_AUTOTUNE_REGISTRY`` env var or ``~/.cache/repro/autotune``.  Each
file carries the full :class:`LinkModel` field set plus free-form
calibration metadata (regret numbers, probe mode, observation count), so
a profile is self-describing:

    {"schema": 1, "device_kind": "nvidia-h100-80gb-hbm3",
     "profile": {"name": "...", "bandwidth": ..., ...},
     "meta": {"static_regret": ..., ...}}

The schema, the layout, the variable and the default directory are the
reference's (``repro/autotune/registry.py``), so a profile written by
either package loads in the other.  A CUDA device's kind is its name as
``torch.cuda.get_device_name`` gives it, sanitized by the reference's
rule; the CPU's is ``"cpu"``, the reference's CPU key.

Loading round-trips through the :class:`LinkModel` constructor, so the
``__post_init__`` validation rejects corrupt or hand-edited profiles with
a clear error instead of silently mis-costing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path

import torch

from repro_torch.core.constants import LinkModel

SCHEMA_VERSION = 1
_ENV_VAR = "REPRO_AUTOTUNE_REGISTRY"


def registry_dir(base: str | os.PathLike | None = None) -> Path:
    if base is not None:
        return Path(base)
    env = os.environ.get(_ENV_VAR)
    if env:
        return Path(env)
    return Path("~/.cache/repro/autotune").expanduser()


def _sanitize(kind: str) -> str:
    return re.sub(r"[^a-z0-9_.-]+", "-", str(kind).strip().lower()).strip("-") or "unknown"


def default_device_kind(device: str | torch.device | None = None) -> str:
    """Sanitized device kind of ``device`` (``cuda`` unless given): the
    CUDA device's name (``nvidia-h100-80gb-hbm3`` on an H100 SXM), or
    ``"cpu"`` for ``device="cpu"``.  Raises without a card rather than
    answering ``"cpu"``."""
    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return _sanitize(torch.cuda.get_device_name(dev))
    return _sanitize(dev.type)


def profile_path(device_kind: str | None = None,
                 base: str | os.PathLike | None = None) -> Path:
    kind = device_kind if device_kind is not None else default_device_kind()
    # an explicit kind is a filename token, never a path: reject
    # separators / dot-dirs so profiles cannot escape the registry
    if not re.fullmatch(r"[A-Za-z0-9_.-]+", kind) or set(kind) == {"."}:
        raise ValueError(
            f"invalid device kind {kind!r}: expected a plain name "
            f"(letters, digits, '_', '.', '-')")
    return registry_dir(base) / f"{kind}.json"


def profile_to_dict(link: LinkModel) -> dict:
    return dataclasses.asdict(link)


def profile_from_dict(d: dict) -> LinkModel:
    fields = {f.name for f in dataclasses.fields(LinkModel)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown LinkModel fields in profile: {sorted(unknown)}")
    # save_profile always writes the full field set; a truncated profile
    # must fail loudly rather than silently inherit shipped defaults
    missing = fields - set(d)
    if missing:
        raise ValueError(f"profile is missing LinkModel fields: {sorted(missing)}")
    return LinkModel(**d)  # __post_init__ validates


def save_profile(
    link: LinkModel,
    device_kind: str | None = None,
    base: str | os.PathLike | None = None,
    meta: dict | None = None,
) -> Path:
    kind = device_kind if device_kind is not None else default_device_kind()
    path = profile_path(kind, base)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "schema": SCHEMA_VERSION,
        "device_kind": kind,
        "profile": profile_to_dict(link),
        "meta": meta or {},
    }
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    tmp.replace(path)
    return path


def load_profile(
    device_kind: str | None = None,
    base: str | os.PathLike | None = None,
    with_meta: bool = False,
) -> LinkModel | tuple[LinkModel, dict]:
    kind = device_kind if device_kind is not None else default_device_kind()
    path = profile_path(kind, base)
    if not path.exists():
        raise FileNotFoundError(
            f"no calibrated profile for device kind {kind!r} at {path} — run "
            f"`python -m repro_torch.launch.calibrate` to create one"
        )
    doc = json.loads(path.read_text())
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: unsupported profile schema {doc.get('schema')!r}")
    link = profile_from_dict(doc["profile"])
    return (link, doc.get("meta", {})) if with_meta else link


def load_profile_or_default(
    device_kind: str | None = None,
    base: str | os.PathLike | None = None,
    default: LinkModel | None = None,
) -> LinkModel:
    """Load the calibrated profile, falling back to shipped constants.

    The reference's degradation contract: a *missing* profile is the
    normal cold-start case and falls back silently; a *corrupt* one —
    invalid JSON, wrong schema, truncated or alien field set, values
    rejected by ``LinkModel.__post_init__`` — emits a ``RuntimeWarning``
    naming the file and falls back, so a damaged registry degrades the
    cost model to the shipped ``PCIE3`` constants instead of taking the
    launcher down.  It concerns the file only: ``device_kind=None`` on a
    machine with no card raises."""
    import warnings

    from repro_torch.core.constants import PCIE3

    kind = device_kind if device_kind is not None else default_device_kind()
    fallback = default if default is not None else PCIE3
    try:
        return load_profile(kind, base)
    except FileNotFoundError:
        return fallback
    except (ValueError, KeyError, TypeError, AttributeError) as exc:
        warnings.warn(
            f"ignoring corrupt autotune profile "
            f"({profile_path(kind, base)}): {exc}; "
            f"falling back to shipped {fallback.name!r} constants",
            RuntimeWarning,
            stacklevel=2,
        )
        return fallback


def has_profile(device_kind: str | None = None,
                base: str | os.PathLike | None = None) -> bool:
    return profile_path(device_kind, base).exists()


def list_profiles(base: str | os.PathLike | None = None) -> dict[str, LinkModel]:
    root = registry_dir(base)
    out = {}
    if root.is_dir():
        for p in sorted(root.glob("*.json")):
            try:
                doc = json.loads(p.read_text())
                out[p.stem] = profile_from_dict(doc["profile"])
            except (ValueError, TypeError, KeyError, json.JSONDecodeError):
                continue  # skip corrupt entries; load_profile reports them
    return out
