"""Nothing under portbench/ imports JAX, the JAX package or (in the plain
reference) the port, and nothing names the JAX package's benchmark."""

import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "animatablegaussians_tpu"}
PORT = "animatablegaussians_torch"


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Top-level names of every module the file imports (relative imports
    resolve inside portbench)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: _imported(p) & FORBIDDEN for p in _modules()}
    assert not {p: s for p, s in bad.items() if s}


def test_top_level_names_compare_whole():
    # the port's name begins with the JAX package's stem; only whole names
    # count
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "animatablegaussians_tpu" in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert PORT not in _imported(os.path.join(ref, f)), f


def test_no_file_names_the_jax_benchmark():
    words = ("bench" + ".py", "bench" + "marks/", "BENCH" + "_")
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith((".py", ".json")):
                with open(os.path.join(d, f)) as fh:
                    text = fh.read()
                assert not [w for w in words if w in text], f
