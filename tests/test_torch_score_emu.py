"""Kernels 1 and 2's CUDA source run on the CPU.

``csrc/ash_score.cu`` compiles for the card only.  Here the materializing
scan (kernel 1) and the register-tiled fused scan (kernel 2, with its
selection ``tiled_span_topk`` of ``csrc/ash_select.cuh``), with nothing
changed but their launches and the shared-memory declaration, run as a
C++ program:
``coarse_emu/cuda_runtime.h`` stands in for the CUDA runtime (a thread
per CUDA thread, barriers, shuffles, ballots and votes through a warp's
exchange buffer, shared atomics, a guard past the end of a block's
shared memory), and ``coarse_emu/score_emu.cpp`` makes
one case's operands, runs both kernels and writes kernel 1's scores and
kernel 2's key strip.  The strip must EQUAL ``ref.span_strip_ref`` of
kernel 1's scores, key for key, at the wrapper's span geometry: both
tiles (8 and 32 queries a block), every bitrate and metric, ragged n and
m, a mask, k_tilde < k (one span a tile), rows whose scores rise with
the row (every key beats the bound: the slots overflow every tile) and
rows all tied (ids decide).  Needs g++ with C++20; skips without it.
"""
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref as TR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "coarse_emu"
# no sanitizers: built with them, the stand-in's 128 to 512 threads a
# block misread their warps' exchanges or overflowed their stacks, and the
# parent commit's kernel 2, right on the card, failed there too; the
# stand-in guards the end of a block's shared memory instead
FLAGS = ["-std=c++20", "-O1", "-g", "-ffp-contract=off",
         "-Wno-unknown-pragmas", "-pthread"]
METRIC = {"dot": 0, "l2": 1, "cos": 2}


def rewrite(text: str) -> str:
    """``ash_score.cu`` with its launches made calls of the stand-in and
    its dynamic shared memory the stand-in's block buffer."""
    text, n = re.subn(r"extern __shared__ float4 smem_f4\[\];",
                      "float4* smem_f4 = reinterpret_cast<float4*>"
                      "(emu_smem());", text)
    assert n == 2
    text, n = re.subn(
        r"(ash_score\w*_kernel<[^>]*>)\s*<<<grid, ([^,]+), smem, stream>>>"
        r"\((.*?)\);",
        r"emu_launch(grid, \2, smem, [=] { \1(\3); });", text, flags=re.S)
    assert n == 2
    assert "<<<" not in text and "asm" not in text
    return text


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("score_emu")
    (d / "probe.cpp").write_text("#include <barrier>\nint main() {}\n")
    if subprocess.run([gxx, *FLAGS, str(d / "probe.cpp"), "-o",
                       str(d / "probe")], capture_output=True,
                      timeout=300).returncode or subprocess.run(
                          [str(d / "probe")], capture_output=True,
                          timeout=60).returncode:
        pytest.skip("needs g++ with C++20 <barrier>")
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, d)
    for f in ("cuda_runtime.h", "score_emu.cpp"):
        shutil.copy(EMU / f, d)
    (d / "score.cu").write_text(rewrite((CSRC / "ash_score.cu").read_text()))
    r = subprocess.run([gxx, *FLAGS, "-I", str(d), str(d / "score_emu.cpp"),
                        "-o", str(d / "score_emu")], capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return d / "score_emu"


def block_threads(chunk):
    """Threads a block of kernel 2 takes at ``chunk`` queries: a tile's
    rows, one a thread (narrow), or the source's wide thread tile,
    TOPK_ROWS rows x MT queries."""
    if chunk == TR.MT:
        return TR.TOPK_BLOCK_N
    rows = int(re.search(r"constexpr int TOPK_ROWS = (\d+);",
                         (CSRC / "ash_score.cu").read_text())[1])
    return chunk // TR.MT * TR.TOPK_BLOCK_N // rows


def run_case(emu, tmp_path, b, d_pad, n, m, C, metric, k, k_tilde, chunk,
             masked, order, seed, n_sm=3):
    wd = d_pad * b // 32
    n_spans, per, L = TR.dense_span_geometry(n, m, k, k_tilde, chunk, n_sm)
    r = subprocess.run(
        [str(emu), *map(str, (b, wd, n, m, C, METRIC[metric], chunk, L, per,
                              n_spans, int(masked), order, seed, tmp_path))],
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    got = dict(kv.split("=") for kv in r.stdout.split()[1:])
    scores = torch.from_numpy(
        np.fromfile(tmp_path / "scores", np.float32).reshape(m, n))
    mask = torch.from_numpy(np.fromfile(tmp_path / "mask", np.int32)) != 0
    strip = torch.from_numpy(
        np.fromfile(tmp_path / "strip", np.int64).reshape(m, -1))
    want = TR.make_keys(*TR.span_strip_ref(
        scores, mask, k, k_tilde, TR.dense_target_spans(m, chunk, n_sm)))
    return got, strip, want, scores, (n_spans, per, L)


# (b, d_pad, n, m, C, metric, k, k_tilde, masked, order): n never a
# multiple of 512; the chunk is the wrapper's for m (both for m <= 8)
CASES = [
    (2, 128, 1500, 33, 64, "dot", 10, None, False, 0),
    (2, 64, 1100, 9, 16, "l2", 40, None, True, 0),
    (1, 64, 700, 32, 8, "cos", 5, None, False, 0),
    (4, 32, 1300, 8, 4, "dot", 100, None, True, 0),
    (8, 16, 600, 3, 4, "l2", 7, None, False, 0),
    (2, 32, 1100, 40, 4, "dot", 8, 4, False, 0),  # one span a tile
    (4, 32, 900, 17, 4, "cos", 64, None, False, 1),  # every key passes
    (2, 32, 1030, 12, 4, "dot", 33, None, True, 2),  # all tied
    (1, 32, 800, 1, 4, "dot", 20, 16, True, 1),
    (2, 32, 1400, 12, 4, "l2", 200, None, False, 0),  # lists past 128
]


@pytest.mark.parametrize("b,d_pad,n,m,C,metric,k,k_tilde,masked,order",
                         CASES)
def test_kernel2_source_on_cpu_equals_span_strip(emu, tmp_path, b, d_pad, n,
                                                 m, C, metric, k, k_tilde,
                                                 masked, order):
    L = min(k, k if k_tilde is None else k_tilde)
    chunks = {TR.dense_query_chunk(m, d_pad, L)} | (
        {TR.MT, TR.WIDE_CHUNK} if m <= TR.MT and L <= TR.WIDE_MAX_L
        else set())
    for chunk in sorted(chunks):
        got, strip, want, scores, _ = run_case(
            emu, tmp_path, b, d_pad, n, m, C, metric, k, k_tilde, chunk,
            masked, order, seed=b * 1000 + n + chunk)
        assert got["launches"] == "2"
        assert int(got["block"]) == block_threads(chunk)
        assert int(got["grid"].split(",")[1]) == -(-m // chunk)
        assert torch.equal(strip, want), f"chunk {chunk}"
        if order == 2:  # ties: every query's span lists its first rows
            assert bool((scores == scores[:, :1]).all())
