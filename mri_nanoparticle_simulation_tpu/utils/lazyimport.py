"""PEP-562-style lazy module proxy.

The pallas modules are touched only at KERNEL-CONSTRUCTION time: a warm
AOT-cache CLI run (engine/aot.py) deserializes the compiled executable
and never traces, so it should never pay their import.  Modules that
only use pallas inside function bodies bind these proxies at module
scope; the first attribute access triggers the real import once.
"""

from __future__ import annotations

import importlib


class LazyModule:
    def __init__(self, name: str):
        self._name = name
        self._mod = None

    def __getattr__(self, attr):
        if self._mod is None:
            self._mod = importlib.import_module(self._name)
        return getattr(self._mod, attr)
