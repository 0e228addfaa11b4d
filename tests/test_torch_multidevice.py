"""Kernel launches on several cards: each under its operands' device.

A sharded index launches the scan kernels for tensors on ``cuda:s``
from one process.  Two things make that work, and both are held here
on the CPU:

* every wrapper calls its C entry point through
  ``ash_score.launch_on``, which makes the tensor's device the CUDA
  current device and passes that device's current stream (a mock of
  ``torch.cuda`` records both);
* the launch helpers' caches in ``csrc/ash_common.cuh`` are kept per
  device: ``set_smem_once`` (the shared-memory attribute, a property of
  a kernel on one device) is built with g++ against the CUDA stand-in
  of ``tests/coarse_emu/``, whose ``cudaGetDevice`` reports a device
  the program sets and whose ``cudaFuncSetAttribute`` counts its calls.

The same launches on two real cards are in ``tests/cuda`` (skipped
below two cards).
"""
import ast
import contextlib
import pathlib
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ash_kv_attn, ash_score  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "coarse_emu"

PROGRAM = r"""
#include "ash_common.cuh"
int emu_device = 0;
int emu_attribute_calls = 0;
__global__ void kern_a() {}
__global__ void kern_b() {}

static int step(int device, size_t smem, size_t* done) {
  emu_device = device;
  const int rc = set_smem_once(kern_a, smem, done);
  if (rc) std::printf("rc=%d\n", rc);
  return emu_attribute_calls;
}

int main() {
  static size_t done_a[MAX_DEVICES] = {};
  static size_t done_b[MAX_DEVICES] = {};
  // (device, bytes, attribute calls so far)
  const int cases[][3] = {
      {0, 40000, 0},    // below 48 KB: no attribute needed
      {0, 100000, 1},   // first need on device 0
      {0, 100000, 1},   // cached
      {0, 90000, 1},    // smaller: still covered
      {1, 100000, 2},   // device 1 has its own attribute
      {1, 100000, 2},
      {0, 200000, 3},   // more on device 0 only
      {1, 150000, 4},
      {3, 49153, 5},
      {70, 100000, 6},  // past the table: served, not cached
      {70, 100000, 7},
  };
  for (const auto& c : cases)
    if (step(c[0], (size_t)c[1], done_a) != c[2]) {
      std::printf("device %d bytes %d: %d calls, want %d\n", c[0], c[1],
                  emu_attribute_calls, c[2]);
      return 1;
    }
  // another kernel instance keeps its own table
  emu_device = 0;
  if (set_smem_once(kern_b, 100000, done_b) || emu_attribute_calls != 8) {
    std::printf("kern_b: %d calls\n", emu_attribute_calls);
    return 1;
  }
  for (int d = 0; d < MAX_DEVICES; ++d)
    if (done_a[d] != (d == 0 ? 200000u : d == 1 ? 150000u
                      : d == 3 ? 49153u : 0u)) {
      std::printf("done_a[%d] = %zu\n", d, done_a[d]);
      return 1;
    }
  std::printf("keyed\n");
  return 0;
}
"""


def test_set_smem_once_is_kept_per_device(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, tmp_path)
    shutil.copy(EMU / "cuda_runtime.h", tmp_path)
    (tmp_path / "keying.cpp").write_text(PROGRAM)
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-pthread", "-I", str(tmp_path), str(tmp_path / "keying.cpp"),
         "-o", str(tmp_path / "keying")],
        capture_output=True, text=True, timeout=300)
    if r.returncode and "barrier" in r.stderr:
        pytest.skip("needs g++ with C++20 <barrier>")
    assert r.returncode == 0, r.stderr[-4000:]
    r = subprocess.run([str(tmp_path / "keying")], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "keyed", (
        r.stdout + r.stderr)


class _FakeCuda:
    """Records the CUDA current device across ``torch.cuda.device``."""

    def __init__(self):
        self.current = 0
        self.calls = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev).index
        try:
            yield
        finally:
            self.current = prev

    def current_stream(self, dev):
        class S:
            cuda_stream = 1000 + torch.device(dev).index
        return S()

    def entry(self, *args):
        self.calls.append((self.current, args))
        return 0


def test_launches_run_under_the_operands_device(monkeypatch):
    fake = _FakeCuda()
    monkeypatch.setattr(torch.cuda, "device", fake.device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake.current_stream)

    class Lib:
        def __getattr__(self, name):
            return fake.entry

    monkeypatch.setattr(ash_score, "_kernels", lambda source="x": Lib())
    ash_score.reset_launch_counts()
    dev1 = torch.device("cuda", 1)
    ash_score._launch("ash_score", "ash_score_topk_launch", "ash_score_topk",
                      dev1, 11, 12)
    ash_score._launch("ash_coarse", "ash_coarse_topk_launch",
                      "ash_score_coarse_topk", torch.device("cuda", 2), 13)
    assert fake.calls == [(1, (11, 12, 1001)), (2, (13, 1002))]
    assert fake.current == 0  # restored after each launch
    assert ash_score.launch_counts["ash_score_topk"] == 1
    assert ash_score.launch_counts["ash_score_coarse_topk"] == 1
    ash_score.reset_launch_counts()


def test_every_entry_point_call_goes_through_launch_on():
    """No wrapper calls a C entry point or reads a stream on its own:
    the only ``current_stream`` is ``launch_on``'s, and every
    ``*_launch`` attribute of a loaded library is handed to it."""
    for mod in (ash_score, ash_kv_attn):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "current_stream":
                fn = [d for d in ast.walk(tree)
                      if isinstance(d, ast.FunctionDef)
                      and any(c is node for c in ast.walk(d))]
                assert [d.name for d in fn] == ["launch_on"], mod.__name__
            if isinstance(f, ast.Attribute) and f.attr.endswith("_launch"):
                pytest.fail(f"{mod.__name__}: {f.attr} called directly")
