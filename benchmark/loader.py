"""Modules of the benchmark found by name: ``load("metrics", "iters")`` is
``benchmark/metrics/iters.py``.  What belongs to one operator, one entry,
one metric or one reference method sits in a file of its own, which the
harness finds by the name that a configuration, a traffic mix or
``BENCHMARK.json`` gives, so that a later cell adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
_loaded = {}


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark's folder."""
    key = (folder, name)
    if key not in _loaded:
        path = os.path.join(HERE, folder, name + ".py")
        if not os.path.isfile(path):
            raise KeyError(f"the benchmark has no {folder}/{name}.py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_" + re.sub(r"\W", "_", f"{folder}/{name}"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]
