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


def _all_declarations(library: str) -> list:
    """[(entry, [parameter declarations])] over the library's sources, one
    item per definition."""
    out = []
    for src in build.LIBRARIES[library][0]:
        with open(os.path.join(build.CSRC, src)) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        for block in _extern_c_blocks(text):
            for m in re.finditer(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
                out.append((m.group(1),
                            [p.strip() for p in m.group(2).split(",")]))
    return out


def _declarations(library: str) -> dict:
    """{entry: [parameter declarations]} over the library's sources."""
    return dict(_all_declarations(library))


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


@pytest.mark.parametrize("library", sorted(build.LIBRARIES))
def test_every_c_entry_is_defined_once_over_the_sources(library):
    """A library split over several sources still defines each C entry
    in exactly one of them (two would fail the link, or bind the wrong
    one)."""
    names = [entry for entry, _ in _all_declarations(library)]
    assert sorted(names) == sorted(build.LIBRARIES[library][1]), names


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


@pytest.mark.parametrize("library", sorted(build.LIBRARIES))
def test_sources_exist_and_each_cu_compiles_to_its_own_object(library):
    """The compile plan: one ``nvcc -c`` per ``.cu`` (a header is compiled
    where it is included), each with ``NVCC_FLAGS`` but ``-shared``, each
    into its own object; then one link of exactly those objects with
    ``NVCC_FLAGS``. Built without running nvcc."""
    sources = [os.path.join(build.CSRC, s)
               for s in build.LIBRARIES[library][0]]
    assert all(os.path.isfile(s) for s in sources), sources
    cus = [s for s in sources if s.endswith(".cu")]
    compiles, link = build.compile_plan("nvcc", sources, "/objs",
                                        "/out/lib.so")
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    assert len(flags) == len(build.NVCC_FLAGS) - 1
    assert len(compiles) == len(cus)
    objects = []
    for cmd, src in zip(compiles, cus):
        assert cmd[0] == "nvcc" and cmd[-1] == src
        assert cmd[1:1 + len(flags)] == flags
        assert "-shared" not in cmd
        rest = cmd[1 + len(flags):-1]
        assert rest[0] == "-c" and rest[1] == "-o" and len(rest) == 3
        assert os.path.dirname(rest[2]) == "/objs"
        assert rest[2].endswith(".o")
        objects.append(rest[2])
    assert len(set(objects)) == len(objects)
    assert link == ["nvcc", *build.NVCC_FLAGS, "-o", "/out/lib.so",
                    *objects]


def _instances(path: str, extern: bool) -> list:
    """The ``Kernels<...>`` instantiations a source defines (or, with
    ``extern``, declares ``extern template``)."""
    with open(os.path.join(build.CSRC, path)) as f:
        text = f.read()
    kind = r"extern template" if extern else r"template"
    return re.findall(r"^" + kind + r" struct (\w+)::Kernels<([^>]*)>;",
                      text, re.M)


# the libraries split over several sources: a header, the C entries'
# source, the instances' sources
SPLIT = sorted(name for name, (sources, _) in build.LIBRARIES.items()
               if len(sources) > 1)


def test_the_decode_library_is_split():
    assert SPLIT == ["flash_decode"]


@pytest.mark.parametrize("library", SPLIT)
def test_each_instance_is_compiled_in_exactly_one_source(library):
    """A split library's header holds its kernels; its entry source
    declares every ``Kernels<...>`` instance ``extern template`` and so
    compiles no kernel; each other source defines its instances, and
    each instance is defined in exactly one source. The entry's dispatch
    names exactly the declared instances."""
    sources = build.LIBRARIES[library][0]
    assert sources[:2] == [f"{library}.cuh", f"{library}.cu"]
    declared = _instances(f"{library}.cu", extern=True)
    assert declared and len(set(declared)) == len(declared)
    assert not _instances(f"{library}.cu", extern=False)
    defined = []
    for src in sources[2:]:
        assert src.startswith(f"{library}_") and src.endswith(".cu")
        here = _instances(src, extern=False)
        assert here, src
        assert not _instances(src, extern=True), src
        defined += here
    assert sorted(defined) == sorted(declared)
    with open(os.path.join(build.CSRC, f"{library}.cu")) as f:
        text = f.read()
    dispatched = re.findall(r"return Kernels<([^>]*)>::", text)
    assert sorted(dispatched) == sorted(args for _, args in declared)


def test_flash_decode_sources_are_one_per_dtype_and_head_dim():
    """The decode library's 128 split kernels and 8 merges, the longest
    compile, are cut into one source per (dtype, head_dim)."""
    for src in build.LIBRARIES["flash_decode"][0][2:]:
        ((_, args),) = _instances(src, extern=False)
        t, d = args.split(", ")
        assert src == ("flash_decode_" + ("f32" if t == "float" else "bf16")
                       + f"_{d}.cu")
    assert len(build.LIBRARIES["flash_decode"][0]) == 2 + 8


def test_library_digest_covers_every_source(tmp_path, monkeypatch):
    """An edit to any source of a library, a header included, names
    another library file, so it is rebuilt."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    made = []
    monkeypatch.setattr(build, "_compile", lambda name, srcs, out: (
        made.append(out), open(out, "w").close(),
        {"seconds": 0.0, "log": "", "steps": {}})[-1])
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: None)
    files = []
    for name in ("a.cuh", "a.cu", "a_1.cu"):
        path = tmp_path / name
        path.write_text(f"// {name}\n")
        files.append(str(path))
    first = build.Library("a", files, {}).path
    assert build.Library("a", files, {}).path == first and len(made) == 1
    paths = {first}
    for path in files:
        with open(path, "a") as f:
            f.write("// edited\n")
        paths.add(build.Library("a", files, {}).path)
    assert len(paths) == 4 and len(made) == 4


@pytest.mark.parametrize("library", sorted(build.LIBRARIES))
def test_flash_bitwise_builds_another_tree_from_all_its_sources(
        library, tmp_path):
    """``flash_bitwise.py`` builds another tree's library from the entry
    source it is given and the sources beside it that share its name: for
    this tree that is every source of the library; for a tree of one file
    per library, that file alone."""
    import shutil
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import flash_bitwise
    sources = build.LIBRARIES[library][0]
    entry = os.path.join(build.CSRC, f"{library}.cu")
    got = flash_bitwise.other_sources(entry)
    assert got[0] == entry
    assert sorted(os.path.basename(p) for p in got) == sorted(sources)
    single = tmp_path / f"{library}.cu"
    shutil.copy(entry, single)
    (tmp_path / "other.cu").write_text("")
    assert flash_bitwise.other_sources(str(single)) == [str(single)]
