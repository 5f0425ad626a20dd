"""The port is complete: every public name of samd_tpu has its counterpart
in samd_tpu_torch, or a row in one of the tables below.

The scan imports every module of ``samd_tpu`` (JAX on the CPU) and the
port's module of the same path (``ops/pallas_attention.py`` maps to
``ops/flash_attention.py``).  A module's public names are the functions,
classes and jitted callables it defines, the names in its ``__all__``, its
upper-case constants, and each class's public methods, properties,
upper-case class constants and dataclass or named-tuple fields.  For each
name exactly one of these holds:

  * the port has it (``hasattr`` following inheritance, or a field);
  * ``RENAMED`` maps it to a port name of the same module that exists;
  * ``NOT_PORTED`` gives the reason it has none, naming the port code that
    does its work where there is some.

A failure here means a name of samd_tpu lost or never had its counterpart:
add the counterpart to the port, or a row with its reason.  A row whose name
is gone from samd_tpu, or which the port now has under the same name,
fails too, so the tables cannot go stale.
"""

import ast
import dataclasses
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = "samd_tpu"
PORT_PKG = "samd_tpu_torch"
MODULE_MAP = {
    "samd_tpu.ops.pallas_attention": "samd_tpu_torch.ops.flash_attention"}

# Files of the reference outside what the port has to match.
OUT_OF_SCOPE = {
    "samd_tpu/testing.py":
        "force_cpu pins JAX to the host CPU backend; the port's entry points "
        "take device= (samd_tpu_torch/device.resolve_device), and its tests "
        "pass device='cpu'",
    "bench.py":
        "the reference's TPU benchmark, which is not ported: the port's "
        "benchmark is its own later work, and chip_smoke.py drives every "
        "path of the port on the card",
}

# JAX name -> the port's name in the mapped module.
RENAMED = {
    "samd_tpu.ops.ngram_index:NgramIndex.tables": "NgramIndex.table",
    "samd_tpu.ops.ngram_index:NgramIndex.latest_tables": "NgramIndex.latest",
    "samd_tpu.ops.quant:int4_requant_from_int8_init": "int4_from_int8_params",
    "samd_tpu.profiling:xla_trace": "torch_trace",
}

_PYTREE = ("a jax.tree_util pytree hook; the port's containers are plain "
           "dataclasses of tensors")

# JAX name -> why the port has no counterpart.
NOT_PORTED = {
    **{f"{mod}:{cls}.{hook}": _PYTREE
       for mod, cls in (("samd_tpu.cache", "QuantizedKV"),
                        ("samd_tpu.ops.ngram_index", "NgramIndex"),
                        ("samd_tpu.ops.quant", "QuantizedTensor"),
                        ("samd_tpu.ops.quant", "Int4Tensor"),
                        ("samd_tpu.paged_kv", "PagedKV"))
       for hook in ("tree_flatten", "tree_unflatten")},
    "samd_tpu.fused_base:make_retrieval_draft":
        "a jit closure over the corpus; the port passes the corpus and its "
        "index as arguments (samd_tpu_torch/fused_base."
        "_retrieval_draft_argform)",
    "samd_tpu.fused_base:make_retrieval_partial":
        "the jax.tree_util.Partial form of make_retrieval_draft; the port "
        "uses samd_tpu_torch/fused_base._retrieval_draft_argform",
    "samd_tpu.paged_kv:PagedAux.interpret":
        "chooses the Pallas interpret mode; the port's kernel wrappers take "
        "the plain version for a CPU tensor",
    "samd_tpu.ops.int4_matmul:DEFAULT_VARIANT":
        "chooses among Pallas unpack bodies; the port has one CUDA kernel "
        "(samd_tpu_torch/csrc/int4_matmul.cu)",
    "samd_tpu.paged_kv:paged_forward":
        "a jitted paged forward; the port's is the paged mode of "
        "samd_tpu_torch/models/llama.forward "
        "(samd_tpu_torch/paged_kv.py:13-17)",
    "samd_tpu.ops.paged_attention:scatter_block_t":
        "the jitted page write; the port's is samd_tpu_torch/paged_kv."
        "paged_write_block",
    "samd_tpu.paged_kv:quantize_rows":
        "the int8 pool's row quantizer; the port's pool writes quantize "
        "through samd_tpu_torch/cache.quantize_kv_block",
    "samd_tpu.paged_kv:scatter_block":
        "the v1 gather path's page write, which nothing in samd_tpu calls",
    "samd_tpu.paged_kv:gather_request":
        "the v1 gather path's page read, which nothing in samd_tpu calls",
    "samd_tpu.fused_hybrid:FusedHybridConfig.approx_harvest":
        "chooses TPU's approximate top-k (jax.lax.approx_max_k) for the "
        "harvest; the port's harvest is the exact top-k "
        "(samd_tpu_torch/engine.harvest_topk)",
    "samd_tpu.token_recycle_fused:FusedTokenRecycleConfig.approx_harvest":
        "chooses TPU's approximate top-k; the port's harvest is exact "
        "(samd_tpu_torch/engine.harvest_topk)",
    "samd_tpu.sam.native:best_sam_class":
        "falls back to the Python automaton when the native one cannot be "
        "built; the port refuses fallbacks (samd_tpu_torch/drafters/"
        "sam_drafter.py, SamdConfig.use_native_sam chooses)",
    "samd_tpu.config:SamdConfig.tree_model_path":
        "nothing in samd_tpu reads it; the EAGLE weights reach make_drafter "
        "as eagle_net_params",
}

# NOT_PORTED names that samd_tpu's own code calls on its paths: the jit,
# pytree and Pallas forms, TPU's approximate top-k, and the fallback that
# the port refuses.  Any other row must name something that
# nothing in samd_tpu uses.
ON_PATH = {
    "tree_flatten", "tree_unflatten", "make_retrieval_partial", "interpret",
    "DEFAULT_VARIANT", "paged_forward", "scatter_block_t", "quantize_rows",
    "approx_harvest", "best_sam_class",
}

CONST = re.compile(r"[A-Z][A-Z0-9_]*$")


def jax_module_names():
    for p in sorted((ROOT / JAX_PKG).rglob("*.py")):
        rel = p.relative_to(ROOT).as_posix()
        if rel in OUT_OF_SCOPE:
            continue
        parts = list(p.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def port_module_name(jax_name: str, jax_pkg=JAX_PKG, port_pkg=PORT_PKG):
    if jax_name in MODULE_MAP:
        return MODULE_MAP[jax_name]
    return port_pkg + jax_name[len(jax_pkg):]


def class_members(cls):
    """A class's own public methods, properties, upper-case constants and
    its dataclass or named-tuple fields."""
    out = set()
    for k, v in vars(cls).items():
        if k.startswith("_"):
            continue
        if (inspect.isfunction(v) or CONST.match(k)
                or isinstance(v, (staticmethod, classmethod, property))):
            out.add(k)
    if dataclasses.is_dataclass(cls):
        out |= {f.name for f in dataclasses.fields(cls)
                if not f.name.startswith("_")}
    out |= {f for f in getattr(cls, "_fields", ()) if not f.startswith("_")}
    return out


def public_names(mod):
    """The module's public names: ``Name`` and ``Class.member``."""
    exported = set(getattr(mod, "__all__", ()))
    names = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        own = getattr(obj, "__module__", None) == mod.__name__
        if inspect.isclass(obj) or callable(obj):
            if not (own or name in exported):
                continue
            names.add(name)
            if inspect.isclass(obj) and own:
                names |= {f"{name}.{m}" for m in class_members(obj)}
        elif CONST.match(name) or name in exported:
            names.add(name)
    return names


def has(mod, dotted: str) -> bool:
    """Whether ``mod`` has ``Name`` or ``Class.member`` (a dataclass field
    without a default, or an annotation anywhere in the class's MRO,
    counts)."""
    obj = mod
    for part in dotted.split("."):
        if hasattr(obj, part):
            obj = getattr(obj, part)
            continue
        if inspect.isclass(obj) and (
                (dataclasses.is_dataclass(obj) and part in
                 {f.name for f in dataclasses.fields(obj)})
                or any(part in getattr(c, "__annotations__", {})
                       for c in inspect.getmro(obj))):
            return True
        return False
    return True


def unmatched(jax_mod, port_mod, renamed=RENAMED, not_ported=NOT_PORTED):
    """The public names of ``jax_mod`` with no counterpart in ``port_mod``
    and no row in either table, as ``module:name`` keys."""
    out = []
    for name in sorted(public_names(jax_mod)):
        key = f"{jax_mod.__name__}:{name}"
        if key in not_ported:
            continue
        if key in renamed:
            if not has(port_mod, renamed[key]):
                out.append(f"{key} (renamed to missing {renamed[key]})")
            continue
        if not has(port_mod, name):
            out.append(key)
    return out


@pytest.fixture(scope="module")
def modules():
    """Every module of samd_tpu with its port module."""
    pairs = {}
    for name in jax_module_names():
        pairs[name] = (importlib.import_module(name),
                       importlib.import_module(port_module_name(name)))
    return pairs


JAX_MODULES = list(jax_module_names())


def test_every_module_scanned():
    assert len(JAX_MODULES) > 60
    for rel in ("samd_tpu.fused_sam", "samd_tpu.evaluation.bench_emit",
                "samd_tpu.ops.pallas_attention", "samd_tpu.parallel.sharding",
                "samd_tpu.sam.native", "samd_tpu.models.llama"):
        assert rel in JAX_MODULES, rel
    assert "samd_tpu.testing" not in JAX_MODULES


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_has_counterparts(modules, name):
    jax_mod, port_mod = modules[name]
    missing = unmatched(jax_mod, port_mod)
    assert not missing, (
        f"public names of {name} with no counterpart in "
        f"{port_mod.__name__}: {missing} (add the counterpart, or a "
        f"RENAMED or NOT_PORTED row with its reason)")


@pytest.mark.parametrize("table", ["RENAMED", "NOT_PORTED"])
def test_table_rows_are_live(modules, table):
    """Each row names a public name of samd_tpu that the port does not have
    under that name."""
    rows = RENAMED if table == "RENAMED" else NOT_PORTED
    assert rows
    for key, value in rows.items():
        mod, dotted = key.split(":")
        assert mod in modules, key
        jax_mod, port_mod = modules[mod]
        assert dotted in public_names(jax_mod), f"{key}: not in samd_tpu"
        assert not has(port_mod, dotted), \
            f"{key}: the port has it now; drop the row"
        assert isinstance(value, str) and len(value) > 10, key


def test_out_of_scope_files_exist():
    for rel, why in OUT_OF_SCOPE.items():
        assert (ROOT / rel).is_file(), rel
        assert len(why) > 20
    assert not (ROOT / PORT_PKG / "testing.py").exists()


def names_used(path: Path):
    """Names a source file loads, reads as attributes, passes as keywords
    or imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            yield node.id
        elif isinstance(node, ast.Attribute) and isinstance(node.ctx,
                                                            ast.Load):
            yield node.attr
        elif isinstance(node, ast.keyword) and node.arg:
            yield node.arg
        elif isinstance(node, ast.ImportFrom):
            yield from (a.name for a in node.names)


def test_not_ported_names_are_off_the_paths():
    """No NOT_PORTED name outside ``ON_PATH`` is used anywhere in
    samd_tpu's engines, CLIs and tools; every ``ON_PATH`` name is a row."""
    last = {k.split(".")[-1].split(":")[-1] for k in NOT_PORTED}
    assert ON_PATH <= last, ON_PATH - last
    used = {}
    for p in (ROOT / JAX_PKG).rglob("*.py"):
        for n in names_used(p):
            used.setdefault(n, set()).add(p.relative_to(ROOT).as_posix())
    for key in NOT_PORTED:
        name = key.split(".")[-1].split(":")[-1]
        if name not in ON_PATH:
            assert name not in used, f"{key} is used in {sorted(used[name])}"


JAX_SRC = '''
import dataclasses

LIMIT = 4


def kept(x):
    return x


def dropped(x):
    return x


@dataclasses.dataclass
class Box:
    size: int
    label: str = ""

    def open(self):
        return self.size

    @property
    def area(self):
        return self.size ** 2
'''

PORT_SRC = '''
import dataclasses


def kept(x):
    return x


@dataclasses.dataclass
class Box:
    label: str = ""

    @property
    def area(self):
        return 0
'''


def _module(name, src, monkeypatch):
    mod = types.ModuleType(name)
    monkeypatch.setitem(sys.modules, name, mod)
    exec(compile(src, name, "exec"), mod.__dict__)
    return mod


def test_planted_missing_names_fail(monkeypatch):
    """A pair of throwaway modules: each name the port module lacks is
    reported, and a table row silences it."""
    jax_mod = _module("planted_jax", JAX_SRC, monkeypatch)
    port_mod = _module("planted_port", PORT_SRC, monkeypatch)
    assert port_module_name("planted_jax.sub", "planted_jax",
                            "planted_port") == "planted_port.sub"
    want = ["planted_jax:Box.open", "planted_jax:Box.size",
            "planted_jax:LIMIT", "planted_jax:dropped"]
    assert unmatched(jax_mod, port_mod, {}, {}) == want
    assert unmatched(jax_mod, port_mod, {}, {k: "why" for k in want}) == []
    renamed = {"planted_jax:dropped": "kept",
               "planted_jax:LIMIT": "MISSING"}
    assert unmatched(jax_mod, port_mod, renamed, {}) == [
        "planted_jax:Box.open", "planted_jax:Box.size",
        "planted_jax:LIMIT (renamed to missing MISSING)"]
    port_mod.dropped = port_mod.kept
    assert "planted_jax:dropped" not in unmatched(jax_mod, port_mod, {}, {})
