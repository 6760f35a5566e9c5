"""Small INI settings shim for GUI options, a copy of the JAX package's
``utils/settings.py``.

The reference reads only ``[INTERACTIVE] gui_radius`` and ``dark_mode``
from its (otherwise vestigial) ``config.ini``
(``minihex/interactive/interactive.py:25-26``); this preserves that knob.
"""

from __future__ import annotations

import configparser
import os

DEFAULTS = {"radius": 40, "dark_mode": False}


def gui_settings(path: str = "config.ini") -> dict:
    out = dict(DEFAULTS)
    if os.path.exists(path):
        cfg = configparser.ConfigParser()
        cfg.read(path)
        if cfg.has_section("INTERACTIVE"):
            out["radius"] = cfg.getint("INTERACTIVE", "gui_radius", fallback=out["radius"])
            out["dark_mode"] = cfg.getboolean(
                "INTERACTIVE", "dark_mode", fallback=out["dark_mode"]
            )
    return out
