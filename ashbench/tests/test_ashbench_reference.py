"""The plain reference agrees with the system on the CPU (where the
system runs its plain versions), and the comparison separates a sound
answer from a wrong one."""
import numpy as np
import pytest
import torch

from ashbench import check, data
from ashbench import reference as R
from repro_torch.core.types import ASHConfig
from repro_torch.index import AshIndex

CASES = [
    ("flat", "dot", dict(b=2, d=16, n_landmarks=8), {}),
    ("ivf", "l2", dict(b=4, d=16, n_landmarks=32), {"landmark_sample": 900}),
]


def _both(backend, metric, ash, train, seed=7):
    X = data.embedding_rows(3000, 32, seed=seed, device="cpu")
    Q = data.embedding_rows(40, 32, seed=seed + 1, device="cpu",
                            spectrum_pow=0.35)
    idx = AshIndex.build(torch.Generator().manual_seed(seed), X,
                         ASHConfig(**ash), backend=backend, metric=metric,
                         device="cpu", keep_raw=True, **train)
    with R.precision():
        model = R.train(torch.Generator().manual_seed(seed), X, **ash,
                        **train)
        payload = R.encode(model, X)
    return X, Q, idx, model, payload


def _outputs(idx, Q, scores, ids, ivf):
    return check.Outputs(
        W=idx.model.W, landmarks=idx.model.landmarks,
        codes=idx.payload.codes, scale=idx.payload.scale,
        offset=idx.payload.offset, cluster=idx.payload.cluster,
        row_ids=idx._state.ids if ivf else None,
        probe=(idx._backend.probe_sets(idx._state, idx.prepare(Q), 8)
               if ivf else None),
        scores=scores.numpy(), ids=ids.numpy())


@pytest.mark.parametrize("backend,metric,ash,train", CASES)
def test_reference_equals_the_system(backend, metric, ash, train):
    X, Q, idx, model, payload = _both(backend, metric, ash, train)
    ivf = backend == "ivf"
    s, i = idx.search(Q, k=10, rerank=50, nprobe=8)
    out = _outputs(idx, Q, s, i, ivf)
    assert check.setup_numbers(out, model, payload) == {"model": 0.0,
                                                        "codes": 0.0}
    nprobe = 8 if ivf else None
    gaps, probes = check.answer_gaps(out, model, payload,
                                     X.to(torch.bfloat16), Q, metric, 50,
                                     1e-5, nprobe)
    assert gaps.max() == 0.0 and probes in (None, 0.0)
    short = R.shortlists(model, payload, X.to(torch.bfloat16),
                         R.prepare(model, Q), metric, 50, nprobe=nprobe)
    rs, ri = R.answers(short, 10, 50)
    assert torch.equal(ri.int(), i) and torch.equal(rs, s)


@pytest.mark.parametrize("backend,metric,ash,train", CASES)
def test_wrong_answers_read_far_above_sound_ones(backend, metric, ash,
                                                 train):
    X, Q, idx, model, payload = _both(backend, metric, ash, train)
    ivf = backend == "ivf"
    s, i = idx.search(Q, k=10, rerank=50, nprobe=8)
    raw = X.to(torch.bfloat16)
    nprobe = 8 if ivf else None

    def gap(scores, ids):
        out = _outputs(idx, Q, scores, ids, ivf)
        return check.answer_gaps(out, model, payload, raw, Q, metric, 50,
                                 1e-5, nprobe)[0].max()

    altered = i.clone()
    altered[3, 0] = (i[3, 0] + 1) % 3000  # an id altered where produced
    assert gap(s, altered) > 1e-3
    half = torch.cat([i[:20], i[:20]])  # half the rows answered for others
    assert gap(torch.cat([s[:20], s[:20]]), half) > 1e-3
    swapped = i.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]  # not best first
    assert gap(s, swapped) > 1e-4
    missing = i.clone()
    missing[5, 4] = -1
    assert gap(s, missing) == check.FAIL


def test_a_different_model_fails_the_setup_numbers():
    X, Q, idx, model, payload = _both(*CASES[0])
    with R.precision():
        other = R.train(torch.Generator().manual_seed(8), X,
                        **CASES[0][2])
        other_p = R.encode(other, X)
    out = check.Outputs(W=other.W, landmarks=other.landmarks,
                        codes=other_p.codes, scale=other_p.scale,
                        offset=other_p.offset, cluster=other_p.cluster,
                        row_ids=None, probe=None, scores=np.zeros((0, 10)),
                        ids=np.zeros((0, 10)))
    nums = check.setup_numbers(out, model, payload)
    assert nums["model"] > 0.1 and nums["codes"] > 0.5


def test_stream_seeds_take_any_whole_number():
    seeds = {data.stream_seed(s, k) for s in (0, 1, 2**31 + 5, 2**40)
             for k in (1, 2, 3, 4, 5)}
    assert len(seeds) == 20 and all(0 <= s < 2**63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))
