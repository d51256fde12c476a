"""Config utilities (port of ``repro.config.base``: ``config_fingerprint``
only; the LM configs are not ported)."""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any


def config_fingerprint(cfg: Any) -> str:
    """Stable short hash of any (nested) dataclass config: the same 16
    hex characters as the reference's for an equal config."""

    def enc(o: Any) -> Any:
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {f.name: enc(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        if isinstance(o, (list, tuple)):
            return [enc(x) for x in o]
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        return o

    blob = json.dumps(enc(cfg), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
