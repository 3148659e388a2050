"""The seam between the port's kernel families, read from the source: no
module of ``pde_opt_tpu_torch/ops`` imports another ``ops`` module's
underscore name, and the ``ops`` modules import one another without a
cycle (``kernels`` <- ``cas_common`` <- the families <- ``steppers``).
And the launch counters that importing the port registers, each module
its own, are the fixed set that ``chip_smoke.py`` and the benchmark read.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pde_opt_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]
OPS = ROOT / "pde_opt_tpu_torch" / "ops"
PACKAGE = "pde_opt_tpu_torch.ops"


def _module_name(path: Path) -> str:
    parts = path.relative_to(OPS).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join((PACKAGE, *parts))


MODULES = {_module_name(p): p for p in sorted(OPS.rglob("*.py"))}


def _imports(name: str):
    """``(module, imported name or None)`` for every import of ``name``'s
    source, function-level ones included, relative ones resolved."""
    path = MODULES[name]
    package = name if path.name == "__init__.py" else name.rpartition(".")[0]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, None
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = package.split(".")
                anchor = anchor[:len(anchor) - node.level + 1]
                base = ".".join(anchor + ([node.module] if node.module else []))
            for alias in node.names:
                if f"{base}.{alias.name}" in MODULES:           # a submodule
                    yield f"{base}.{alias.name}", None
                else:
                    yield base, alias.name


def _ops_edges(name: str):
    return {module for module, _ in _imports(name) if module in MODULES and module != name}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_no_ops_module_imports_another_ones_private_name(name):
    private = sorted(f"{module}.{imported}" for module, imported in _imports(name)
                     if module in MODULES and module != name and imported
                     and imported.startswith("_"))
    assert not private, f"{name} imports {private}"


@pytest.mark.parametrize("name", sorted(MODULES))
def test_ops_imports_have_no_cycle(name):
    """No chain of imports among the ``ops`` modules leads from ``name``
    back to itself."""
    seen, todo = set(), [(m, (name, m)) for m in _ops_edges(name)]
    while todo:
        module, chain = todo.pop()
        assert module != name, " -> ".join(chain)
        if module not in seen:
            seen.add(module)
            todo.extend((m, chain + (m,)) for m in _ops_edges(module))


# Every launch counter of the port: the kernels' and their paths', and the
# env fleet's reset pass.
LAUNCH_COUNTERS = [
    "ac_cas_macro", "ac_cas_macro_ep", "ac_sif_macro", "bv_cc_macro", "bv_cc_macro.tiled",
    "bv_cc_macro_ep", "ch3d_rhs_fd", "ch_cas_macro", "ch_cas_macro.onchip",
    "ch_cas_macro.onchip_fold", "ch_cas_macro_bwd", "ch_cas_macro_ep", "ch_rhs_fd",
    "ch_sif_macro", "gpe_strang_macro", "gpe_strang_macro_ep", "sbm_bv_macro", "sbm_bv_macro_ep",
    "vector_env.fleet_reset",
]


def test_importing_the_port_registers_every_launch_counter():
    """In a fresh process, ``import pde_opt_tpu_torch`` leaves
    ``launch_counts()`` with exactly :data:`LAUNCH_COUNTERS`, all zero."""
    code = ("import json, pde_opt_tpu_torch\n"
            "from pde_opt_tpu_torch.ops.kernels import launch_counts\n"
            "print(json.dumps(launch_counts()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    counts = json.loads(out.strip().splitlines()[-1])
    assert sorted(counts) == LAUNCH_COUNTERS
    assert not any(counts.values())


def test_count_launch_refuses_a_name_nobody_registered():
    before = kernels.launch_counts()
    with pytest.raises(KeyError):
        kernels.count_launch("no_such_kernel")
    assert kernels.launch_counts() == before
