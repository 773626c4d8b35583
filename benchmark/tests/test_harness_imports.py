"""Nothing under benchmark/ imports JAX or the JAX package (whole top-level
names, so the port's name does not match), and the reference imports
nothing of the port."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "audio_pattern_discovery_tpu"}
PORT = "audio_pattern_discovery_tpu_torch"


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = [p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not (imported(p) & FORBIDDEN), p


def test_reference_imports_nothing_of_the_port():
    files = list((HERE / "reference").glob("*.py"))
    assert files
    for p in files:
        assert PORT not in imported(p), p
        assert "benchmark.traffic" not in p.read_text()


def test_whole_name_comparison():
    assert PORT.split(".")[0] not in FORBIDDEN
