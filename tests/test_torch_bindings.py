"""The ctypes signatures of utils/cuda.py against the C entry points of
csrc/*.cu: each entry's parameters, one by one, as pointer, int, unsigned
or float.  A mismatch passes arguments in the wrong registers on the card
and nothing on the CPU would notice, so it is read from the sources here.
"""

import ctypes
import re

import pytest

from rtrt_tpu_torch.utils import cuda

_DEF = re.compile(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', re.S)


def _entries() -> dict:
    out = {}
    for path in sorted(cuda.CSRC.glob("*.cu")):
        for name, params in _DEF.findall(path.read_text()):
            out[name] = [p.strip() for p in params.split(",")]
    return out


def _kind(param: str) -> str:
    """The kind of one C parameter, from its type (the words before the
    name)."""
    if "*" in param:
        return "pointer"
    typ = param.rsplit(None, 1)[0].removeprefix("const ")
    return {"float": "float", "int": "int", "unsigned": "unsigned",
            "unsigned int": "unsigned", "uint32_t": "unsigned"}[typ]


def _ctype_kind(t) -> str:
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_float: "float", ctypes.c_uint: "unsigned",
            ctypes.c_int: "int"}[t]


ENTRIES = _entries()


def test_every_signature_has_an_entry_point():
    assert set(cuda._SIGNATURES) <= set(ENTRIES), \
        set(cuda._SIGNATURES) - set(ENTRIES)


@pytest.mark.parametrize("name", sorted(cuda._SIGNATURES))
def test_signature_matches_the_source(name):
    want = [_kind(p) for p in ENTRIES[name]]
    got = [_ctype_kind(t) for t in cuda._SIGNATURES[name]]
    assert got == want, (name, ENTRIES[name])
