"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the port; the run's own check of
``sys.modules`` compares top-level names whole."""

import ast
import os
import sys

from benchmark.harness.main import FORBIDDEN, forbidden_modules

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sources(sub=""):
    base = os.path.join(PKG, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imports(path):
    """(top-level name, level, dotted name) of every import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            yield mod.split(".", 1)[0], node.level, mod
            if node.level:      # a name may be a module of the package
                for a in node.names:
                    yield "", node.level, ".".join(filter(None, (mod,
                                                                 a.name)))


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p, name) for p in sources() for name, level, _ in imports(p)
           if level == 0 and name in FORBIDDEN]
    assert bad == []


def test_the_reference_imports_nothing_of_the_port():
    """The reference's files and every benchmark module they reach by a
    relative import."""
    seen, todo = set(), list(sources("reference"))
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name, level, mod in imports(p):
            assert not (level == 0 and name in
                        FORBIDDEN + ("samd_tpu_torch",)), (p, mod)
            if level:
                base = os.path.dirname(p)
                for _ in range(level - 1):
                    base = os.path.dirname(base)
                target = os.path.join(base, *mod.split(".")) if mod else base
                for cand in (target + ".py",
                             os.path.join(target, "__init__.py")):
                    if os.path.exists(cand):
                        todo.append(cand)
    assert any(p.endswith(os.path.join("harness", "draws.py")) for p in seen)


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "samd_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "samd_tpu.fused_sam", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["jax", "samd_tpu"]
