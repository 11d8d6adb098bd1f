"""The port stands alone: ``disco_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and nothing imports ``triton`` when a
module is imported (a Triton kernel imports it where it launches)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "disco_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "disco_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def _imports(tree):
    """(top-level package, at module level) of every import in ``tree``."""
    top_level = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in top_level


def test_no_jax_or_jax_package_imports():
    assert len(_sources()) > 15
    for path in _sources():
        for top, _ in _imports(ast.parse(path.read_text(), str(path))):
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {top}"


def test_no_module_level_triton_import():
    for path in _sources():
        for top, at_module_level in _imports(ast.parse(path.read_text(), str(path))):
            assert not (top == "triton" and at_module_level), path.relative_to(ROOT)


def test_fresh_interpreter_imports_every_module_without_jax():
    """Every port module imports in a fresh interpreter in which JAX and
    the JAX package cannot be imported, and leaves no ``jax`` module
    loaded."""
    code = f"""
import importlib, importlib.abc, json, sys
BLOCKED = {FORBIDDEN!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for mod in {_modules()!r}:
    importlib.import_module(mod)
import torch
print(json.dumps({{"jax": "jax" in sys.modules,
                   "tf32": [torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"jax": False, "tf32": [False, False]}


def test_chip_smoke_needs_a_card_and_the_repo(tmp_path):
    """``chip_smoke.py`` fails, printing no result, when it stands alone in
    a directory, and in the checkout when there is no CUDA device."""
    import torch

    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(tmp_path, lone)]
    if not torch.cuda.is_available():
        runs.append((ROOT, ROOT / "chip_smoke.py"))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_sweep_covers_the_linter_and_the_race_analyzer():
    """The sweeps above walk every module of the port, the linter's rules
    and the thread-contract analyzer included."""
    mods = set(_modules())
    for name in ("disco_tpu_torch.analysis.cli", "disco_tpu_torch.analysis.rules.fence",
                 "disco_tpu_torch.analysis.rules.fusedsolver",
                 "disco_tpu_torch.analysis.race.callgraph", "disco_tpu_torch.analysis.race.cli"):
        assert name in mods, name


def test_serve_client_loads_torch_through_the_package_root():
    """The serve client's files name no torch (DL005), but importing the
    client runs ``disco_tpu_torch/__init__.py``, which imports torch to turn
    TF32 off; ROADMAP records this transitive import, and this test sees a
    change to it either way."""
    code = ("import sys\nimport disco_tpu_torch.serve.client\n"
            "print('torch' in sys.modules, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


#: the corpus acquisition and the kernels' build cache seam
HOST_MODULES = ("datagen/download.py", "cli/download.py", "utils/compile_cache.py")


@pytest.mark.parametrize("rel", HOST_MODULES)
def test_host_modules_import_nothing_of_the_jax_package(rel):
    path = PORT / rel
    tops = {top for top, _ in _imports(ast.parse(path.read_text(), str(path)))}
    assert not tops & set(FORBIDDEN), (rel, tops & set(FORBIDDEN))
    assert f"disco_tpu_torch.{rel[:-3].replace('/', '.')}" in _modules()


@pytest.mark.parametrize("rel", HOST_MODULES)
def test_host_modules_name_no_torch(rel):
    """The downloader, its CLI and the cache seam are host code: they import
    torch nowhere, not even inside a function."""
    path = PORT / rel
    tops = {top for top, _ in _imports(ast.parse(path.read_text(), str(path)))}
    assert "torch" not in tops and "triton" not in tops, rel
    assert "import torch" not in path.read_text()
