"""The C entries declared in ``ops/_build.py`` against the sources in
``csrc/``: every entry is defined in its library's source with the same
arguments, type by type, so ctypes passes each one as the kernel reads it.
Runs on the CPU (it reads the sources; it builds nothing)."""

import ctypes
import re

import pytest

from neuralvolumetricreconstructionformedicalimages_torch.ops import _build

_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_arguments(name: str, symbol: str):
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf"^int {symbol}\(([^)]*)\)", src, re.M)
    assert m, f"{symbol} is not defined in csrc/{name}.cu"
    types = []
    for arg in m.group(1).split(","):
        decl = " ".join(arg.split())
        ctype = re.sub(r"\s*\w+$", "", decl).replace(" *", "*")
        assert ctype in _CTYPE, f"{symbol}: unexpected argument {decl!r}"
        types.append(_CTYPE[ctype])
    return types


@pytest.mark.parametrize("symbol", sorted(_build.ENTRIES))
def test_entry_argtypes_match_the_source(symbol):
    name, argtypes = _build.ENTRIES[symbol]
    assert name in _build.SOURCES
    assert _c_arguments(name, symbol) == argtypes
    assert argtypes[-1] is ctypes.c_void_p       # the stream, appended by launch


def test_every_source_entry_is_declared():
    declared = {sym for sym, (name, _) in _build.ENTRIES.items()}
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        found = set(re.findall(r"^int (nvr_\w+)\(", src, re.M)) - {"nvr_error_string"}
        assert found <= declared, f"csrc/{name}.cu: {sorted(found - declared)}"
