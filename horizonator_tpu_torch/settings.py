"""Persistent user settings: reference-compatible ``settings.xml``.

The port's own copy of horizonator_tpu.settings (that package imports JAX).

The reference's florb layer keeps a singleton key->string map persisted as
XML at ``~/.horizonator/settings.xml`` (orb_settings.cpp:27-139) with
defaults ``osm::tileserver`` = the OSM tile server and zoom limits 0..18
(orb_settings.cpp:41-43); values are parsed from strings on access
(orb_settings.hpp:37-67 templates). This module is the same contract in
~60 lines of stdlib Python: existing user files keep working, and typed
access mirrors the template getter.

Layout written/read (matching the reference's tinyxml structure):

    <settings>
      <entry key="osm::tileserver">https://tile.openstreetmap.org/</entry>
      ...
    </settings>
"""

from __future__ import annotations

import os
import threading
import xml.etree.ElementTree as ET

DEFAULTS = {
    "osm::tileserver": "https://tile.openstreetmap.org/",   # orb_settings.cpp:41
    "osm::zoommin": "0",                                    # :42
    "osm::zoommax": "18",                                   # :43
}

_PATH = "~/.horizonator/settings.xml"
_lock = threading.Lock()


class Settings:
    """Key->string map persisted as settings.xml; typed get/set."""

    def __init__(self, path: str | None = None):
        self.path = os.path.expanduser(path or _PATH)
        self._kv = dict(DEFAULTS)
        self._load()

    def _load(self):
        try:
            root = ET.parse(self.path).getroot()
        except (OSError, ET.ParseError):
            return
        for e in root.iter("entry"):
            k = e.get("key")
            if k is not None:
                self._kv[k] = e.text or ""

    def save(self):
        root = ET.Element("settings")
        for k in sorted(self._kv):
            e = ET.SubElement(root, "entry", key=k)
            e.text = self._kv[k]
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        ET.ElementTree(root).write(tmp, encoding="unicode",
                                   xml_declaration=True)
        os.replace(tmp, self.path)

    def get(self, key: str, default=None, type=str):
        v = self._kv.get(key)
        if v is None:
            return default
        try:
            if type is bool:
                return v.strip().lower() in ("1", "true", "yes")
            return type(v)
        except (TypeError, ValueError):
            return default

    def set(self, key: str, value) -> None:
        self._kv[key] = str(value)

    def __contains__(self, key):
        return key in self._kv


_instance: Settings | None = None


def instance() -> Settings:
    """The singleton (orb_settings.cpp:135-139)."""
    global _instance
    with _lock:
        if _instance is None:
            _instance = Settings()
        return _instance
