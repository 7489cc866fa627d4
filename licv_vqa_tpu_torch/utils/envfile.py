"""Tiny ``.env`` loader (python-dotenv is not in the image).

The reference reads dataset/model roots from a ``.env`` file via
``load_dotenv()`` (reference: train.py:114, .env.example).  Same contract:
``KEY=value`` lines, ``#`` comments, existing environment wins unless
``override=True``.
"""

from __future__ import annotations

import os
from pathlib import Path


def load_dotenv(path: str | Path = ".env", override: bool = False) -> bool:
    path = Path(path)
    if not path.exists():
        return False
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        if override or key not in os.environ:
            os.environ[key] = value
    return True
