"""The control on the card at a size a test holds: the reference in the
system's place one precision lower (TF32) fails the comparison, and the
reference itself in the system's place passes it.  Skips without a
card (TF32 exists only there); at the cells' own sizes it runs as
``python3 ashbench/control.py``."""
import json

import pytest

from ashbench import control, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["t2i-10m-flat.batch1024",
                                  "deep-10m-ivf.batch1024"])
def test_control_fails_and_the_reference_passes(card, tiny, cell):
    root, bench = tiny
    for p in (root / "configs").glob("*.json"):  # enough rows to tie less
        cfg = json.loads(p.read_text())
        p.write_text(json.dumps({**cfg, "n": 20000}))
    c = spec.Cell(cell, root=root, bench_path=bench)
    limits = c.config["limits"]
    for seed in (1, 2, 3):
        same = control.readings(c, seed, 1.0, device=card, tf32=False)
        assert all(v <= limits[k] for k, v in same.items()), same
        lower = control.readings(c, seed, 1.0, device=card, tf32=True)
        assert any(v > limits[k] for k, v in lower.items()), lower
