"""
Find the benchmark's parts by the names that ``BENCHMARK.json``, a
configuration or a traffic mix gives them: ``load(kind, name)`` is the
module ``gpbench/<kind>/<name>.py``, loaded from its path, so that adding a
part is adding a file. The kinds: ``loops``, ``fields``, ``scans``,
``targets``, ``reference`` and ``metrics``.
"""

import importlib
import importlib.util
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = ["load", "entry"]

_LOADED = {}


def load(kind, name):
    """The module of part ``name`` of ``kind``, loaded once a process."""
    key = (kind, name)
    if key not in _LOADED:
        path = os.path.join(HERE, kind, name + ".py")
        if not os.path.isfile(path):
            raise FileNotFoundError("no %s named %r (%s)" % (kind, name,
                                                             path))
        spec = importlib.util.spec_from_file_location(
            "gpbench_%s_%s" % (kind, re.sub(r"\W", "_", name)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def entry(dotted):
    """The program's object named ``package.module.attribute``."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)
