"""The ctypes bindings of the CUDA kernels against their C declarations.

``build.LIBRARIES`` gives each C entry point its ``argtypes``, and ctypes
trusts them: a pointer declared ``c_int`` is cut to 32 bits with no
error. These tests parse every ``extern "C"`` block of each library's
sources and check each entry's argtypes parameter by parameter: one
``c_void_p`` per pointer (the stream included), one ``c_int`` per int,
one ``c_float`` per float. They read the sources only, so they run
without ``nvcc`` or a GPU."""
import ctypes
import os
import re

import pytest

from repro_torch.kernels import build

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _extern_c_blocks(text: str):
    """The bodies of the ``extern "C" { ... }`` blocks of a source."""
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        yield text[m.end():i - 1]


def _declarations(library: str) -> dict:
    """{entry: [parameter declarations]} over the library's sources."""
    out = {}
    for src in build.LIBRARIES[library][0]:
        with open(os.path.join(build.CSRC, src)) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for block in _extern_c_blocks(text):
            for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
                out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    return _C_TYPES[param.split()[0]]


ENTRIES = [(lib, entry) for lib, (_, sigs) in build.LIBRARIES.items()
           for entry in sigs]


@pytest.mark.parametrize("library,entry", ENTRIES)
def test_argtypes_match_the_c_declaration(library, entry):
    params = _declarations(library)[entry]
    argtypes = build.LIBRARIES[library][1][entry]
    assert len(argtypes) == len(params), (entry, params)
    for param, argtype in zip(params, argtypes):
        assert argtype is _ctype(param), (entry, param, argtype)


@pytest.mark.parametrize("library", sorted(build.LIBRARIES))
def test_every_c_entry_is_bound(library):
    """No entry point of a source goes without argtypes."""
    declared = _declarations(library)
    assert declared, library
    assert set(declared) == set(build.LIBRARIES[library][1])


def test_parser_reads_pointers_ints_and_floats():
    text = ('extern "C" {\n// a comment (int x)\nint f(const void* a, int b,'
            ' float c, void* stream) {\n  return (int)g(a);\n}\n}')
    (block,) = _extern_c_blocks(text)
    m = re.search(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block)
    params = [p.strip() for p in m.group(2).split(",")]
    assert [_ctype(p) for p in params] == [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def test_build_targets_sm90a_and_reports_registers():
    """The kernels use mma.sync and cp.async for sm_90a; -Xptxas -v feeds
    the registers and spills that chip_smoke.py reports."""
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-Xptxas -v" in flags


def test_ssd_forward_state_entry_takes_a_state_in_and_out():
    """The forward state pass's C entry carries the initial state and the
    final state beside the per-chunk states, each a pointer (null: start
    from 0, keep no final state)."""
    params = _declarations("ssd")["repro_ssd_fwd_state"]
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[:7] == ["x", "dt", "A", "bm", "init", "states",
                         "final_state"]
    argtypes = build.LIBRARIES["ssd"][1]["repro_ssd_fwd_state"]
    assert argtypes[4:7] == [ctypes.c_void_p] * 3


@pytest.mark.parametrize("library,entry,name", [
    ("flash_decode", "repro_flash_decode", "split"),
    ("flash_decode", "repro_flash_decode_paged", "split")])
def test_tuned_knob_is_the_int_before_the_scale(library, entry, name):
    """The autotuned knob reaches the kernels as a C int: the decode
    split, just before the float scale."""
    params = _declarations(library)[entry]
    names = [p.split()[-1].lstrip("*") for p in params]
    i = names.index(name)
    assert params[i].split()[0] == "int"
    assert names[i + 1] == "scale"
    argtypes = build.LIBRARIES[library][1][entry]
    assert argtypes[i:i + 2] == [ctypes.c_int, ctypes.c_float]


def test_decode_workspace_is_sized_by_the_split():
    params = _declarations("flash_decode")["repro_flash_decode_workspace"]
    assert [p.split()[-1] for p in params] == ["b", "h", "d", "capacity",
                                               "split"]
