"""The port's serve entry point on the CPU, and the port's import hygiene.

``src/repro_torch`` and ``chip_smoke.py`` must import neither JAX nor the
JAX package ``repro``: the port keeps its own copy of what it needs.
"""

import ast
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, smoke_variant

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "starcoder2-3b",
                                  "rwkv6-1.6b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "qwen2-vl-72b"])
def test_serve_main_smoke_on_cpu(arch, capsys):
    kernels = [k for family in serve.PATH_KERNELS.values()
               for k in family.values()]
    before = [k.launches for k in kernels]
    toks = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "3", "--prompt-len", "10", "--gen", "5"])
    assert isinstance(toks, np.ndarray) and toks.shape == (3, 5)
    assert toks.min() >= 0 and toks.max() < 256
    out = capsys.readouterr().out
    assert "prefill 3x10 tokens" in out and "tok/s" in out
    assert [k.launches for k in kernels] == before


def test_serve_refuses_unported_family():
    """hubert-xlarge (audio) is ported for training only: encoder-only, its
    one entry point is ``Model.loss``.  It has no decode cache, and serve
    exits on it before it builds a model."""
    cfg = smoke_variant(get_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="no decode cache"):
        Model(cfg, device="cpu").make_cache(1, 4)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):      # f"pkg.{name}"
                arg = arg.values[0]
            if isinstance(arg, ast.Constant):
                yield str(arg.value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
