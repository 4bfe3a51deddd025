"""One lock for the port's module-level launch and build counters.

Each kernel module keeps its counts as module globals (``LAUNCHES`` and
the like), which the tests and ``chip_smoke.py`` read and set to 0. A
fleet's workers launch from several threads at once, so every bump goes
through :func:`inc`, under one lock, and none is lost. (The scan census,
``scan_engine.SCAN_STATS``, has its own lock and ``bump``.)"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_LOCK = threading.Lock()


def inc(namespace: Dict[str, Any], name: str, key: Optional[str] = None) -> None:
    """Add one to ``namespace[name]`` (a module's ``globals()``), or, where
    ``key`` is given, to ``namespace[name][key]``."""
    with _LOCK:
        if key is None:
            namespace[name] += 1
        else:
            counts = namespace[name]
            counts[key] = counts.get(key, 0) + 1
