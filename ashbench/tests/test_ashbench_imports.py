"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(compared by whole top-level name: ``repro_torch`` begins with
``repro``), and the reference loads nothing of ``repro_torch``."""
import json
import pathlib
import subprocess
import sys

import pytest

from ashbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
PROBE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _tops(body: str) -> set:
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_system():
    tops = _tops("import ashbench.reference, ashbench.check")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_harness_and_the_system_load_no_jax():
    tops = _tops("from ashbench import harness, sweep, control, spec\n"
                 "import repro_torch.index, repro_torch.serving\n"
                 "from ashbench.spec import Cell\n"
                 "for c in ('t2i-10m-flat.online',"
                 " 'deep-10m-ivf.batch1024'):\n    cell = Cell(c)\n"
                 "    [cell.reader(m['name']) for m in cell.metrics(True)"
                 " + cell.metrics(False)]")
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("mods,found", [
    (["repro_torch", "repro_torch.index", "reprox"], []),
    (["repro", "repro.index"], ["repro"]),
    (["jax._src.core", "flax"], ["flax", "jax"]),
])
def test_the_check_compares_whole_top_level_names(monkeypatch, mods, found):
    for m in mods:
        monkeypatch.setitem(sys.modules, m, object())
    assert [x for x in harness.forbidden_modules()
            if x in {m.split(".")[0] for m in mods}] == found
