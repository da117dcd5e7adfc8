"""The benchmark's imports: nothing of JAX or of the JAX package
(``repro``) or its old ``benchmarks/``, and a reference that reaches
nothing of the program.  Top-level module names are compared whole:
``repro_torch`` begins with ``repro``."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imports(path: Path):
    """Every module ``path`` imports, absolute, as dotted names."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(BENCH.parent).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg.split(".")[:len(pkg.split(".")) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def module_path(name: str):
    p = BENCH.parent.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def closure(path: Path):
    """The modules ``path`` imports, and those of every bench module it
    reaches."""
    seen, todo, out = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in imports(p):
            out.add(name)
            if name.split(".")[0] == "bench":
                q = module_path(name)
                if q is not None:
                    todo.append(q)
    return out


def top(names):
    return {n.split(".")[0] for n in names}


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = top(imports(path)) & FORBIDDEN
        assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_the_reference_reaches_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        reached = top(closure(path))
        assert "repro_torch" not in reached, path
        assert not reached & FORBIDDEN, path


def test_top_level_names_are_compared_whole():
    assert top({"repro_torch.serve"}) & FORBIDDEN == set()
    assert top({"repro.core"}) & FORBIDDEN == {"repro"}
