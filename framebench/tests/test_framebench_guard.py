"""The no-JAX check and the reference's independence from the program."""

import ast
import os
import subprocess
import sys

import pytest

from fbench import guard, manifest

HERE = manifest.HERE
PROGRAM = ("rtrt_tpu_torch",)
BANNED = ("jax", "jaxlib", "flax", "rtrt_tpu")


@pytest.mark.parametrize("mods,found", [
    (["rtrt_tpu_torch", "rtrt_tpu_torch.engine.frame", "numpy"], []),
    (["rtrt_tpu", "numpy"], ["rtrt_tpu"]),
    (["rtrt_tpu.engine.engine"], ["rtrt_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "rtrt_tpu_tools"], []),
])
def test_top_level_names_compared_whole(mods, found):
    assert guard.banned_modules(mods) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*parts):
    base = os.path.join(HERE, *parts)
    if base.endswith(".py"):
        yield base
        return
    for d, _, files in os.walk(base):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


REFERENCE = [p for part in (("fbref",), ("fbench", "reference.py"),
                            ("fbench", "compare.py"), ("fbench", "scene.py"),
                            ("fbench", "terrain"), ("fbench", "pan.py"))
             for p in _sources(*part)]


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[os.path.relpath(p, HERE) for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    bad = set(_imports(path)) & set(PROGRAM + BANNED)
    assert not bad, f"{path} imports {bad}"


def test_harness_sources_import_no_jax():
    for path in _sources("."):
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(_imports(path)) & set(BANNED), path


def test_reference_loads_no_program_module():
    """Building the reference and its frame constants in a fresh process
    loads no module of the program, JAX or the JAX package."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "import torch\n"
        "from fbench import manifest\n"
        "from fbench.reference import Reference\n"
        "from fbench.scene import make_mesh\n"
        "cfg = dict(json.load(open(manifest.HERE + "
        "'/configs/terrain_sah4.json')))\n"
        "cfg['terrain'] = dict(cfg['terrain'], chunks_x=1, chunks_z=1)\n"
        "ref = Reference(cfg, dict(width=480, height=270), "
        "make_mesh(cfg['terrain']), 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True,
                         cwd=os.path.dirname(HERE))
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(PROGRAM + BANNED), loaded & set(PROGRAM + BANNED)
