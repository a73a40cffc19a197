"""The benchmark of the PyTorch and CUDA port: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Every part that belongs to one traffic mix, one model family or one data
set is a module of its own, found by the name a data file gives:
``drivers/<traffic kind>.py``, ``systems/<config system>.py``,
``reference/<config reference>.py`` and ``datasets/<config data kind>.py``.
"""

import importlib
import re


def load(package: str, name: str):
    """The module ``benchmark.<package>.<name>``, ``name`` as a data file
    gives it."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", str(name)):
        raise ValueError(f"{name!r} names no module of benchmark/{package}")
    return importlib.import_module(f"{__name__}.{package}.{name}")
