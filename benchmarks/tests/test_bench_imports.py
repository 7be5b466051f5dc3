"""Nothing under benchmarks/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast

import harness

PORT = "gsplatloc_tpu_torch"


def imported(path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources():
    return sorted(harness.HERE.rglob("*.py"))


def test_no_jax_anywhere():
    for path in sources():
        bad = imported(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_and_yardstick_take_nothing_of_the_port():
    free = [p for p in sources()
            if p.parent.name in ("plainref", "ops", "models", "opt", "paths",
                                 "gen", "layouts", "rooflines")
            or p.name in ("bounds.py", "check.py")]
    assert any(p.parent.name == "plainref" for p in free)
    assert any(p.parent.name == "paths" for p in free)
    assert any(p.parent.name == "rooflines" for p in free)
    for path in free:
        assert PORT not in imported(path), f"{path} imports the port"


def test_whole_name_comparison():
    import sys

    assert "gsplatloc_tpu" not in harness.forbidden_modules() or (
        "gsplatloc_tpu" in {n.split(".")[0] for n in sys.modules})
    sys.modules["gsplatloc_tpu_torch_probe"] = sys
    try:
        assert "gsplatloc_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["gsplatloc_tpu_torch_probe"]
