"""The PyTorch port stands on its own: it carries byte-equal copies of the
JAX package's host C++ sources and constant tables, reads no file of
`plass_tpu`, ships those copies as package data, names its host library by
the sources' bytes, and runs from a directory that holds only
`plass_tpu_torch/`."""
import ast
import glob
import importlib.util
import json
import os
import re
import shutil
import tomllib

import pytest
import torch

from plass_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "plass_tpu_torch")
JAX = os.path.join(ROOT, "plass_tpu")

# (directory in the port, directory in the JAX package, pattern)
COPIES = (("native", "native", "*.cpp"),
          ("constants/data", "constants/data", "*"))


def _names(d, pattern):
    return {os.path.basename(p) for p in glob.glob(os.path.join(d, pattern))
            if os.path.isfile(p)}


def _copied_files():
    cases = []
    for port_dir, jax_dir, pattern in COPIES:
        names = (_names(os.path.join(PORT, port_dir), pattern)
                 | _names(os.path.join(JAX, jax_dir), pattern))
        cases += [(f"{port_dir}/{n}", f"{jax_dir}/{n}") for n in sorted(names)]
    return cases


COPIED = _copied_files()


def test_every_copy_is_listed():
    """11 host sources and 19 tables, the host library's sources among
    them."""
    port = [p for p, _ in COPIED]
    assert sum(p.startswith("native/") for p in port) == 11
    assert sum(p.startswith("constants/data/") for p in port) == 19
    assert {f"native/{s}" for s in native._SOURCES} <= set(port)


@pytest.mark.parametrize("port_file,jax_file", COPIED,
                         ids=[p for p, _ in COPIED])
def test_copy_is_byte_equal_to_the_jax_package(port_file, jax_file):
    """Both directories list the same names, and each file is the JAX
    package's byte for byte."""
    port_path = os.path.join(PORT, port_file)
    jax_path = os.path.join(JAX, jax_file)
    assert os.path.isfile(port_path), f"missing in the port: {port_file}"
    assert os.path.isfile(jax_path), f"not in the JAX package: {jax_file}"
    with open(port_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()


# a JAX site named in chip_smoke.py's kernel table: file:line, not a path
# that is read
_SITE = re.compile(r"plass_tpu/[\w/]+\.py:\d+")
# `plass_tpu` as a component of a path: the whole string, or between
# separators
_JAX_PATH = re.compile(r"(?:^|[/\\])plass_tpu(?:[/\\]|$)")


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                out.add(id(first.value))
    return out


def test_no_path_into_the_jax_package():
    """No module of the port, and not chip_smoke.py, names REFERENCE_DIR,
    refers to a `plass_tpu` name, or holds a string (outside docstrings)
    that has the `plass_tpu` directory as a path component, but for the JAX
    sites of the printed kernel table."""
    files = [p for p in glob.glob(os.path.join(PORT, "**", "*.py"),
                                  recursive=True)
             if "_build" not in p.split(os.sep)]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 70
    found, sites = [], 0
    for path in files:
        text = open(path).read()
        rel = os.path.relpath(path, ROOT)
        if "REFERENCE_DIR" in text:
            found.append(f"{rel}: REFERENCE_DIR")
        tree = ast.parse(text)
        docs = _docstrings(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id == "plass_tpu":
                found.append(f"{rel}:{node.lineno}: the name plass_tpu")
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and _JAX_PATH.search(node.value)):
                if _SITE.fullmatch(node.value):
                    sites += 1
                else:
                    found.append(f"{rel}:{node.lineno}: {node.value!r}")
    assert not found, found
    assert sites == 5   # chip_smoke.py's kernel table: K1, K2, B9, B10, B12


def test_package_data_ships_the_copies_and_kernels():
    """pyproject.toml's package-data globs for plass_tpu_torch match every
    file under native/ (but its module), constants/data/ and csrc/."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        cfg = tomllib.load(fh)
    globs = cfg["tool"]["setuptools"]["package-data"]["plass_tpu_torch"]
    shipped = {os.path.relpath(p, PORT) for g in globs
               for p in glob.glob(os.path.join(PORT, g)) if os.path.isfile(p)}
    wanted = set()
    for d in ("native", "constants/data", "csrc"):
        for base, dirs, files in os.walk(os.path.join(PORT, d)):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            wanted |= {os.path.relpath(os.path.join(base, f), PORT)
                       for f in files if not f.endswith((".py", ".pyc"))}
    assert len(wanted) == 11 + 19 + 3
    assert wanted <= shipped, sorted(wanted - shipped)
    scripts = cfg["project"]["scripts"]
    assert scripts["plass-torch"] == "plass_tpu_torch.cli.plass:main"
    assert scripts["penguin-torch"] == "plass_tpu_torch.cli.penguin:main"


@pytest.mark.parametrize("source", native._SOURCES)
def test_host_library_tag_follows_the_sources_bytes(tmp_path, source):
    """The tag hashes content, not paths: a copy of the sources elsewhere
    has the same tag, and one byte changed in any source changes it."""
    for s in native._SOURCES:
        shutil.copy2(os.path.join(native.SOURCE_DIR, s), tmp_path)
    assert native.library_tag(str(tmp_path)) == native.library_tag()
    path = tmp_path / source
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    path.write_bytes(bytes(data))
    assert native.library_tag(str(tmp_path)) != native.library_tag()


def test_host_library_tag_follows_the_flags(monkeypatch):
    """The loaded library carries the tag; other compile flags give
    another."""
    tag = native.library_tag()
    assert os.path.basename(native.lib()._name) == f"libplass_host-{tag}.so"
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-DNDEBUG"])
    assert native.library_tag() != tag
    monkeypatch.undo()
    assert native.library_tag() == tag
    monkeypatch.setattr(native, "_AVX2_SOURCES", {"pssm.cpp"})
    assert native.library_tag() != tag


# every table loader, run in the tree and in the port-only directory; each
# result is reduced to a sha256
TABLES = r'''
import hashlib
import numpy as np


def _feed(obj, h):
    if isinstance(obj, np.ndarray):
        h.update(f"a{obj.dtype.str}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, dict):
        h.update(f"d{len(obj)}".encode())
        for k in sorted(obj, key=repr):
            _feed(k, h)
            _feed(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(f"l{len(obj)}".encode())
        for x in obj:
            _feed(x, h)
    elif obj is None or isinstance(obj, (str, bytes, int, float,
                                         np.generic)):
        h.update(repr(obj).encode())
    else:
        _feed({k: v for k, v in vars(obj).items()
               if not k.startswith("_")}, h)


def table_digests():
    from plass_tpu_torch import constants
    from plass_tpu_torch.ops import profilestates, rescore
    loaders = {
        "blosum62": constants.blosum62, "vtml80_8": constants.vtml80_8,
        "blosum62_pref": constants.blosum62_pref,
        "nucleotide": constants.nucleotide,
        "genetic_codes": constants.genetic_codes,
        "coding_filter_weights": constants.coding_filter_weights}
    for size in (3, 7, 13):
        loaders[f"reduced({size})"] = lambda s=size: constants.reduced(s)
    for name in ("blosum62_ungapped", "blosum62_11_1", "nucleotide_7_1",
                 "nucleotide_ungapped", "nucleotide_gapped_5_2"):
        loaders[f"evalue_params({name})"] = (
            lambda n=name: constants.evalue_params(n))
    for name in ("blosum62", "blosum62_pref", "coding_filter",
                 "evalue_params", "genetic_codes", "nucleotide", "reduced3",
                 "reduced7", "reduced13", "vtml80_8", "vtml80_reduced13"):
        loaders[f"_load({name})"] = lambda n=name: constants._load(n)
    for states in (8, 32, 219, 255):
        loaders[f"ProfileStates({states})"] = (
            lambda k=states: profilestates.ProfileStates(k))
    for mode in (rescore.COV_MODE_BIDIRECTIONAL, rescore.COV_MODE_TARGET):
        loaders[f"parse_precision_lib({mode})"] = lambda m=mode: [
            rescore.parse_precision_lib(m, sid / 20, cov)
            for sid in range(10, 21) for cov in (0.0, 0.5, 0.8, 0.9)]
    out = {}
    for name, load in loaders.items():
        h = hashlib.sha256()
        _feed(load(), h)
        out[name] = h.hexdigest()
    return out
'''


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_runs_from_a_directory_without_the_jax_package(tmp_path):
    """chip_smoke.py's standalone phase on the CPU: plass_tpu_torch/ alone
    (with its _build/, so the host library is not built again) as the
    working directory and only PYTHONPATH entry of a process, where
    plass_tpu cannot be found, the package and its host library load from
    there, and both fixture assemblies equal their goldens byte for byte
    (the phase raises otherwise); then every table loader there returns
    what it returns in the tree."""
    native.lib()
    stdout = _chip_smoke().phase_standalone(
        torch.device("cpu"), str(tmp_path),
        TABLES + '\nprint("TABLES " + json.dumps(table_digests()))\n')
    lines = [ln for ln in stdout.splitlines() if ln.startswith("TABLES ")]
    assert len(lines) == 1, stdout[-4000:]
    ns = {}
    exec(TABLES, ns)
    want = ns["table_digests"]()
    assert len(want) == 31
    assert json.loads(lines[0][len("TABLES "):]) == want
