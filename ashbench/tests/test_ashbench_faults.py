"""The rest of a run with the timed path broken underneath (the look
for a card skipped): ``correct`` comes out false for each fault a
search cell can have."""
import json

import pytest
import torch

from ashbench import harness, spec
from repro_torch.index import api

CELLS = ["t2i-10m-flat.batch1024", "deep-10m-ivf.batch1024",
         "t2i-10m-flat.online", "deep-10m-ivf.online"]


def altered_id(scores, ids):
    """An answer altered where it is produced: one id moved."""
    ids = ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % 2000
    return scores, ids


def half_left_out(scores, ids):
    """Half of the batch left out: its rows get the other half's
    answers."""
    h = (ids.shape[0] + 1) // 2
    return (torch.cat([scores[:h], scores[:ids.shape[0] - h]]),
            torch.cat([ids[:h], ids[:ids.shape[0] - h]]))


def dropped_rows(scores, ids):
    """A shortlist cut short: the last five ranks come back empty."""
    scores, ids = scores.clone(), ids.clone()
    scores[:, -5:], ids[:, -5:] = float("-inf"), -1
    return scores, ids


@pytest.mark.parametrize("fault", [altered_id, half_left_out, dropped_rows])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    for name in ("search", "search_prepped"):
        real = getattr(api.AshIndex, name)

        def broken(self, *a, _real=real, **kw):
            return fault(*_real(self, *a, **kw))
        monkeypatch.setattr(api.AshIndex, name, broken)
    root, bench = tiny
    lines = []
    rc = harness.run(spec.Cell(cell, root=root, bench_path=bench), 99, 0.5,
                     False, device="cpu", emit=lines.append,
                     log=lambda s: None)
    assert rc == 0
    result = json.loads(lines[-1])
    assert result["correct"] is False
    assert result["checks"]["answers"]["value"] > \
        result["checks"]["answers"]["limit"]
