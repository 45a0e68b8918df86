"""Keyring: entity name -> base64 secret (src/auth/KeyRing.cc role).

File format mirrors the reference's keyring ini shape::

    [osd.0]
        key = <base64>

The mon process loads the full keyring (it is the KDC); every other
daemon/client needs only its own entry.

The port's own copy of ``ceph_tpu/auth/keyring.py``; the files are
byte-equal.
"""
from __future__ import annotations

import base64
from typing import Dict, Optional

from .crypto import make_secret


class Keyring:
    def __init__(self) -> None:
        self.keys: Dict[str, bytes] = {}
        # entity -> {subsystem: capability string}; written as the
        # reference's `caps <subsys> = "<grant>"` keyring lines
        self.caps: Dict[str, Dict[str, str]] = {}

    def create(self, entity: str) -> bytes:
        """Generate-or-get a secret for *entity* (ceph auth get-or-create)."""
        if entity not in self.keys:
            self.keys[entity] = make_secret()
        return self.keys[entity]

    def get(self, entity: str) -> Optional[bytes]:
        return self.keys.get(entity)

    def set_caps(self, entity: str, caps: Dict[str, str]) -> None:
        """Replace the entity's full cap set (KeyRing::set_caps — the
        reference's --cap replaces all previous caps, cap-overwrite.t)."""
        self.caps[entity] = dict(caps)

    # ---- file io -----------------------------------------------------------
    def lines(self) -> list:
        out = []
        for entity in sorted(self.keys):
            out.append(f"[{entity}]")
            key64 = base64.b64encode(self.keys[entity]).decode()
            out.append(f"\tkey = {key64}")
            for subsys in sorted(self.caps.get(entity, {})):
                out.append(f'\tcaps {subsys} = '
                           f'"{self.caps[entity][subsys]}"')
        return out

    def save(self, path: str) -> None:
        lines = self.lines()
        with open(path, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))

    @classmethod
    def load(cls, path: str) -> "Keyring":
        kr = cls()
        entity = None
        with open(path) as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("[") and line.endswith("]"):
                    entity = line[1:-1]
                elif "=" in line and entity is not None:
                    k, v = (s.strip() for s in line.split("=", 1))
                    if k == "key":
                        kr.keys[entity] = base64.b64decode(v)
                    elif k.startswith("caps "):
                        subsys = k[len("caps "):].strip()
                        kr.caps.setdefault(entity, {})[subsys] = \
                            v.strip().strip('"')
        return kr
