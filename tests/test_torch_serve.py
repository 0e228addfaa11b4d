"""The port's serving launcher, ``repro_torch.launch.serve``, in process
on the CPU at a tiny size (``--device cpu``): the sequential stream and
its printed recall against direct search of the saved index, a WAL run
and its recovery, the concurrent mode with background compaction, the
sharded and tiered backends, the HTTP API against direct search, the
isotropy diagnostics against the JAX package, the data's two
independent draws (index rows and queries, as the reference's two keys),
and the refusal to run on the CPU unasked.
"""
import json
import re
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import (  # noqa: E402
    isotropy_diagnostics as j_isotropy,
)
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    embedding_dataset, isotropy_diagnostics,
)
from repro_torch.index import AshIndex, recall_curve  # noqa: E402
from repro_torch.index import metrics as MET  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import QueryEngine  # noqa: E402

TINY = ["--n", "1000", "--dim", "16", "--landmarks", "8", "--queries",
        "64", "--buckets", "8,32", "--device", "cpu"]


def _run(capsys, *extra):
    assert serve.main([*TINY, *extra]) == 0
    out = capsys.readouterr().out
    return out, {ln.split("]")[0] + "]" for ln in out.splitlines()
                 if ln.startswith("[")}


def test_sequential_run_recall_equals_direct_search(capsys, tmp_path):
    out, tags = _run(capsys, "--save-dir", str(tmp_path / "idx"))
    assert {"[data]", "[config]", "[build]", "[save]", "[serve]",
            "[latency]", "[engine]", "[prep-cache]", "[queue]",
            "[recall]"} <= tags
    assert "QPS on the CPU" in out
    printed = re.search(r"10-recall@10=([0-9.]+) 10-recall@100=([0-9.]+)",
                        out).groups()
    X, Q = serve.dataset(1000, 16, 64, 0, "cpu")
    index = AshIndex.load(tmp_path / "idx", device="cpu")
    _, ids = index.search(Q, k=100, nprobe=8)
    _, gt = MET.exact_topk(Q, X, k=10)
    rec = recall_curve(ids, gt, Rs=(10, 100))
    assert printed == (f"{rec[10]:.4f}", f"{rec[100]:.4f}")


def test_wal_run_then_recovery_replays_nothing(capsys, tmp_path):
    wal = ["--wal", str(tmp_path / "dur"), "--fsync", "always",
           "--mutate-fraction", "0.3", "--engine", "ivf"]
    out, tags = _run(capsys, *wal)
    assert {"[wal]", "[mutations]", "[durability]", "[checkpoint]"} <= tags
    seq = int(re.search(r"\[checkpoint\] seq=(\d+)", out).group(1))
    assert seq > 0
    out2, tags2 = _run(capsys, *wal)
    assert "[recovery]" in tags2 and "[wal]" not in tags2
    m = re.search(r"\[recovery\] checkpoint seq=(\d+) replayed=(\d+) "
                  r"adds/(\d+) dels", out2)
    assert m.groups() == (str(seq), "0", "0")
    seq2 = int(re.search(r"\[checkpoint\] seq=(\d+)", out2).group(1))
    assert seq2 > seq  # the second run's mutations are logged after it


def test_concurrent_with_auto_compact(capsys, tmp_path):
    out, tags = _run(capsys, "--concurrent", "4", "--auto-compact", "0.001",
                     "--mutate-fraction", "0.5", "--queries", "128",
                     "--wal", str(tmp_path / "dur"))
    assert "via 4 closed-loop clients" in out
    assert {"[latency]", "[compaction]", "[checkpoint]"} <= tags
    runs = int(re.search(r"background runs=(\d+)", out).group(1))
    assert runs >= 1


@pytest.mark.parametrize("extra,tag", [
    (("--engine", "sharded"), "[recall]"),
    (("--tiered", "--hot-bytes", "4096", "--rerank", "32"), "[tier]"),
])
def test_sharded_and_tiered(capsys, extra, tag):
    out, tags = _run(capsys, *extra)
    assert {tag, "[recall]", "[serve]"} <= tags
    backend = "tiered_ivf" if "--tiered" in extra else "sharded"
    assert f"backend='{backend}'" in out


def test_http_api_equals_direct_search():
    X, Q = serve.dataset(600, 16, 16, 3, "cpu")
    index = AshIndex.build(torch.Generator().manual_seed(3), X,
                           ASHConfig(b=2, d=8, n_landmarks=8), device="cpu")
    engine = QueryEngine(index, batch_buckets=(8, 32))
    srv = serve.HttpServer(engine, {"nprobe": 8, "rerank": 0}, 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        body = json.dumps({"queries": Q[:8].tolist(), "k": 10}).encode()
        req = urllib.request.Request(
            url + "/search", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.loads(r.read())
        s, ids = index.search(Q[:8], k=10)
        assert np.array_equal(np.asarray(got["ids"]), ids.numpy())
        assert np.array_equal(np.asarray(got["scores"], np.float32),
                              s.numpy())
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] == 1 and "compiled_buckets" in stats
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(url + "/nowhere", timeout=30)
    finally:
        srv.close()
    th.join(10.0)
    assert not th.is_alive()


def test_isotropy_diagnostics_match_reference():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((300, 24)) * np.arange(1, 25) ** -0.7
         + 0.5).astype(np.float32)
    got = isotropy_diagnostics(torch.from_numpy(X), sample=256)
    want = j_isotropy(jnp.asarray(X), sample=256)
    assert got.keys() == want.keys()
    for key in want:  # fp32 norms and products in another order
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6)


def test_dataset_queries_are_an_independent_draw():
    X, Q = serve.dataset(500, 16, 40, 7, "cpu")
    assert X.shape == (500, 16) and Q.shape == (40, 16)
    qs = serve.stream_seed(7, 2)
    assert len({serve.stream_seed(7, 1), qs, serve.stream_seed(8, 1),
                serve.stream_seed(8, 2)}) == 4 and 0 <= qs < 2**63
    assert torch.equal(X, embedding_dataset(500, 16, device="cpu",
                                            seed=serve.stream_seed(7, 1)))
    assert torch.equal(Q, embedding_dataset(40, 16, device="cpu", seed=qs))
    # not held-out rows of one draw of n + queries rows
    for seed in (7, serve.stream_seed(7, 1)):
        one = embedding_dataset(540, 16, device="cpu", seed=seed)
        assert not torch.equal(one[500:], Q)
    # its own covariance and centers: another mean than X's
    assert float((Q.mean(0) - X.mean(0)).abs().max()) > 0.1


def test_main_refuses_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)


@pytest.mark.parametrize("extra", [
    ("--engine", "sharded", "--tiered"),
    ("--shortlist", "8"),
    ("--row-budget", "100"),
])
def test_flag_errors(capsys, extra):
    with pytest.raises(SystemExit):
        serve.main([*TINY, *extra])
