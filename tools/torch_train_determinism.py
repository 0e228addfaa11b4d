#!/usr/bin/env python3
"""Which stage of the port's training is not bit-reproducible on a card.

    PYTHONPATH=src python tools/torch_train_determinism.py [--n N]

Runs every stage of ``repro_torch.core.ash.train`` twice on the same
inputs on the CUDA device and prints, as one JSON line, whether the two
results are bit-identical: the segment sum of the Lloyd step by
``index_add_`` (float atomics) and by ``learning.segment_sum``, the
cluster assignment, k-means++ seeding, k-means, PCA, the random
rotation, one ITQ step, the rotation's alternation, and the whole
training (W and landmarks).  Data: ``embedding_dataset(n, 256,
seed=0)``, ASHConfig(b=2, d=128, n_landmarks=64), as in
``chip_smoke.py``.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    from repro_torch.core import ash as A
    from repro_torch.core import learning as L
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    X = embedding_dataset(args.n, 256, seed=0, device=dev)
    C = 64

    def twice(fn):
        a, b = fn(), fn()
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return bool(torch.equal(a, b))

    def gen():
        return torch.Generator().manual_seed(0)

    cent = L._kmeanspp_init(gen(), X, C)
    assign = L.assign_clusters(X, cent).long()
    xt, _, _ = L.normalized_residuals(X[:4096], cent)
    P = L.pca_topd(xt, 128)
    Z = xt @ P.T
    R0 = L.random_rotation(gen(), 128, dev)
    cfg = ASHConfig(b=2, d=128, n_landmarks=C)
    out = {
        "index_add_": twice(lambda: torch.zeros(C, 256, device=dev)
                            .index_add_(0, assign, X)),
        "segment_sum": twice(lambda: L.segment_sum(X, assign, C)),
        "assign_clusters": twice(lambda: L.assign_clusters(X, cent)),
        "kmeanspp_init": twice(lambda: L._kmeanspp_init(gen(), X, C)),
        "kmeans": twice(lambda: L.kmeans(gen(), X, C)),
        "pca_topd": twice(lambda: L.pca_topd(xt, 128)),
        "random_rotation": twice(lambda: L.random_rotation(gen(), 128, dev)),
        "itq_step": twice(lambda: tuple(L.itq_step(R0, Z, b=2))),
        "learn_rotation": twice(lambda: L.learn_rotation(gen(), Z, 2)[0]),
        "train": twice(lambda: (lambda m: (m.W, m.landmarks))(
            A.train(gen(), X, cfg, device=dev)[0])),
    }
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bit_identical_twice": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
