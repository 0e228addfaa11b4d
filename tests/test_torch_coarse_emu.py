"""Kernel 5's CUDA source run on the CPU.

``csrc/ash_coarse.cu`` compiles for the card only.  Here its kernel 5
(``ash_coarse_launch`` -> ``ash_coarse_kernel``), with nothing changed
but its asm statements and its launch, runs as a C++ program built with
AddressSanitizer and UndefinedBehaviorSanitizer: ``coarse_emu/
cuda_runtime.h`` stands in for the CUDA runtime (a thread per CUDA
thread, barriers for ``__syncthreads`` and ``__syncwarp``, ``mma.sync``
by the PTX ISA's m16n8k32 fragment tables, ``cp.async`` as a copy that
must be aligned, stay inside shared memory and take its source address
from inside an operand even when it reads nothing), and
``coarse_emu/emu.cpp`` drives one case and holds every score bit for
bit against a plain integer scan with the same epilogue.  Cases: every
bitrate and metric; rows of one chunk and of several (the last ragged,
wd not a multiple of 4); a codes base only 4-byte aligned (4-byte
copies); C = 1 and 2000 (ipq from device memory); m across query
chunks; d_pad = 28,000, where a block takes 4 queries; and the shared
memory a block cut below the card's, so that a block gets fewer warps
and fewer queries.  Needs g++ with C++20 and the sanitizers; skips
without them.
"""
import pathlib
import re
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EMU = pathlib.Path(__file__).resolve().parent / "coarse_emu"
SMEM = 232448  # shared memory a block on sm_90
FLAGS = ["-std=c++20", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-Wno-unknown-pragmas",
         "-pthread"]


def _sub(pattern, repl, text, flags=0):
    out, n = re.subn(pattern, repl, text, flags=flags)
    assert n == 1, pattern
    return out


def rewrite(text: str) -> str:
    """``ash_coarse.cu`` with its CUDA-only statements replaced by the
    stand-in's calls; the other kernels' launches are compiled, not
    run."""
    text = text.replace("extern __shared__ int4 smem_i4[];",
                        "int4* smem_i4 = emu_smem();")
    text = _sub(r"constexpr size_t SMEM_BLOCK_MAX = \d+;",
                "size_t SMEM_BLOCK_MAX = 0;", text)
    text = _sub(r'asm\("mma\.sync.*?\);\n',
                "emu_mma(c, a0, a1, a2, a3, b0, b1);\n", text, re.S)
    text = _sub(r'if \(CH == 16\)\s*asm volatile\("cp\.async\.cg.*?'
                r'else\s*asm volatile\("cp\.async\.ca.*?\);\n',
                "emu_cp_async(dst, src, CH, bytes);\n", text, re.S)
    text = _sub(r'asm\("dp4a.*?\);', "d = 0;", text, re.S)
    text = re.sub(r'asm volatile\("cp\.async\.(commit|wait)_group.*?\);',
                  "(void)0;", text, flags=re.S)
    text = _sub(r"(ash_coarse_kernel<B, METRIC, SPLIT>)<<<grid, warps \* 32, "
                r"smem, stream>>>\((.*?)\);",
                r"emu_launch(grid, warps * 32, smem, [=] { \1(\2); });",
                text, re.S)
    text = re.sub(r"<<<[^>]*>>>", "", text)
    assert "asm" not in re.sub(r"emu_\w+", "", text)
    return text


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("coarse_emu")
    (d / "probe.cpp").write_text("#include <barrier>\nint main() {}\n")
    if subprocess.run([gxx, *FLAGS, str(d / "probe.cpp"), "-o",
                       str(d / "probe")], capture_output=True,
                      timeout=300).returncode or subprocess.run(
                          [str(d / "probe")], capture_output=True,
                          timeout=60).returncode:
        pytest.skip("needs g++ with C++20 <barrier> and the sanitizers")
    for f in CSRC.glob("*.cuh"):
        shutil.copy(f, d)
    for f in ("cuda_runtime.h", "emu.cpp"):
        shutil.copy(EMU / f, d)
    (d / "coarse.cu").write_text(rewrite((CSRC / "ash_coarse.cu")
                                         .read_text()))
    r = subprocess.run([gxx, *FLAGS, "-I", str(d), str(d / "emu.cpp"), "-o",
                        str(d / "emu")], capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return d / "emu"


METRIC = {"dot": 0, "l2": 1, "cos": 2}
# (b, d, n, m, C, metric, offset, shared memory a block, blocks' shape):
# the shape is (threads a block, queries a block) where the case cuts
# them, else None
CASES = [
    (2, 128, 5000, 8, 64, "dot", 0, SMEM, (256, 8)),  # the main path's
    (2, 48, 1001, 17, 16, "l2", 1, SMEM, None),
    (1, 100, 3001, 3, 16, "cos", 0, SMEM, None),
    (4, 72, 1500, 11, 1, "dot", 0, SMEM, None),
    (8, 20, 700, 1, 2000, "cos", 0, SMEM, None),
    (8, 128, 2000, 9, 16, "l2", 0, SMEM, None),  # one chunk of 32 words
    (8, 132, 999, 9, 16, "dot", 0, SMEM, None),  # two, the last of 1 word
    (8, 200, 515, 3, 16, "l2", 1, SMEM, None),  # two, 4-byte copies
    (4, 1000, 333, 9, 64, "cos", 0, SMEM, None),  # wd = 125
    (8, 2048, 300, 9, 64, "dot", 0, SMEM, None),  # 16 chunks
    (4, 4096, 200, 17, 16, "l2", 0, SMEM, None),
    (1, 4000, 130, 8, 16, "dot", 1, SMEM, None),
    (8, 28000, 40, 9, 64, "l2", 0, SMEM, (160, 4)),  # fewer queries
    (2, 128, 2000, 9, 64, "dot", 0, 30000, (160, 8)),  # fewer warps
    (4, 1000, 333, 9, 64, "cos", 0, 30000, (32, 4)),
    (1, 4000, 130, 8, 16, "dot", 1, 30000, (32, 1)),
    (8, 200, 515, 17, 16, "l2", 1, 60000, (64, 8)),
]


@pytest.mark.parametrize("b,d,n,m,C,metric,offset,smem,shape", CASES)
def test_kernel5_source_on_cpu_equals_plain(emu, b, d, n, m, C, metric,
                                            offset, smem, shape):
    wd = -(-d * b // 32)
    r = subprocess.run(
        [str(emu), *map(str, (b, d, wd, n, m, C, METRIC[metric], offset,
                              smem, b * 1000 + d))],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    got = dict(kv.split("=") for kv in r.stdout.split()[1:])
    assert r.stdout.startswith("equal ") and got["launches"] == "1"
    assert int(got["copies"]) > 0
    if shape is not None:
        threads, mq = shape
        assert int(got["block"]) == threads
        assert int(got["grid"].split(",")[1]) == -(-m // mq)
