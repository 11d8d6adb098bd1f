#!/usr/bin/env python3
"""The bf16 STFT kernel's geometry, timed on the card.

``csrc/stft_bf16.cu`` takes a tile of 256 frames and a slab of 64 bins a
block (4 warpgroups of 64 frames, ``wgmma``), its table through a ring of
``kStages`` shared-memory stages, the frames in eight phases.  This script
builds ``stft_bf16.cu`` once for each variant below (constants replaced, or
a part of the kernel cut out, in a copy of the source), and times each
straight through the library (CUDA events, an L2 flush before each call, as
``chip_smoke.py``; the mean of 20) on the rows of ``chip_smoke.py``'s
north-star clip stack (96 rows of 160000 samples) and of its 16-clip batch
(1536 rows), with the magnitude.  Variants that keep the kernel's function
are held to ``stft_matmul(..., precision='bf16')`` within 1e-4 of the output
scale; the cut-out ones ("no ...") are timed only, to show what each part
costs.  A last build stamps thread 0 of the first 64 blocks with clock64()
at points of the phase loop and prints the median cycles between them at
the clip.  Run on the card from the root of the checkout::

    python3 exp/stft_bf16_variants.py

It prints one JSON line a variant and shape, then one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: name -> [(pattern, replacement)] applied to the source; "keeps" marks the
#: variants that compute the kernel's function
VARIANTS = {
    "as built": ([], True),
    "no raw rows or conversion": ([(r"auto issue_raw = \[&\]\(const int p\) \{",
                                    "auto issue_raw = [&](const int p) { return;"),
                                   (r"auto convert = \[&\]\(const int p\) \{",
                                    "auto convert = [&](const int p) { return;")], False),
    "no conversion": ([(r"auto convert = \[&\]\(const int p\) \{",
                        "auto convert = [&](const int p) { return;")], False),
    "no products": ([(r"for \(int ks = 0; ks < kQuarter / 16; \+\+ks\)",
                      "for (int ks = 0; ks < 0; ++ks)")], False),
    "no stores": ([(r"spec\[o\] = val;", "if (val.x == 12345.f) spec[o] = val;"),
                   (r"if \(mag != nullptr\) mag\[o\] = sqrtf\(val",
                    "if (mag != nullptr && val.y == 12345.f) mag[o] = sqrtf(val")], False),
    "no bin 256": ([(r"add_pairs\(a, b, nyq\.z, nyq\.w\);", "(void)0;"),
                    (r"add_pairs\(a, b, nyq\.x, nyq\.y\);", "(void)0;")], False),
    "kStages=3": ([(r"constexpr int kStages = \d+;", "constexpr int kStages = 3;")], True),
    "kStages=2": ([(r"constexpr int kStages = \d+;", "constexpr int kStages = 2;")], True),
    "no async-proxy fence": ([(r"fence_async_smem\(\);  // for the products' reads", "")],
                             False),
    "no bin-256 sums, no zeroing": ([(r"add_pairs\(a, b, nyq\.z, nyq\.w\);", "(void)0;"),
                                     (r"add_pairs\(a, b, nyq\.x, nyq\.y\);", "(void)0;"),
                                     (r"if \(!\(fl & 2\)\) a = b = make_uint2\(0u, 0u\);", ""),
                                     (r"if \(!\(fl & 1\)\) a = b = make_uint2\(0u, 0u\);", "")],
                                    False),
    "kRawBufs=3": ([(r"constexpr int kRawBufs = \d+;", "constexpr int kRawBufs = 3;")], True),
}

#: clock64() stamps of thread 0 of the first blocks at points of the phase
#: loop (the "traced" build; stamp 8 p + k of phase p, then the epilogue's)
TRACE_POINTS = ["phase start", "LO chunk ready", "HI chunk ready", "products issued",
                "raw rows ready", "converted", "products done", "phase end"]
TRACE = [
    (r'#include "common.cuh"\n',
     '#include "common.cuh"\n__device__ long long g_trace[64][72];\n'
     '#define TR(i) if (threadIdx.x == 0 && blockIdx.x < 64) g_trace[blockIdx.x][i] = clock64();\n'
     'extern "C" int disco_trace_read(void* out) { return (int)cudaMemcpyFromSymbol(out, '
     'g_trace, sizeof(g_trace)); }\n'),
    (r"\n  convert\(0\);\n", "\n  TR(64) convert(0); TR(65)\n"),
    (r"\n    wgmma_fence\(\);\n", "\n    TR(8 * p) wgmma_fence();\n"),
    (r"mbar_wait\(full \+ st, \(c / kStages\) & 1\);",
     "mbar_wait(full + st, (c / kStages) & 1); TR(8 * p + 1 + h)"),
    (r"\n    wgmma_commit\(\);\n", "\n    wgmma_commit(); TR(8 * p + 3)\n"),
    (r"\n      convert\(p \+ 1\);\n", "\n      TR(8 * p + 4) convert(p + 1); TR(8 * p + 5)\n"),
    (r"\n    wgmma_wait_all\(\);\n", "\n    wgmma_wait_all(); TR(8 * p + 6)\n"),
    (r"group_sync\(wg\);  // phase p \+ 1's tiles built; phase p's raw rows free",
     "group_sync(wg); TR(8 * p + 7)"),
    (r"__syncthreads\(\);  // every warp is done with the frame buffers and the ring",
     "TR(66) __syncthreads(); TR(67)"),
    (r"extern __shared__ __align__\(1024\) unsigned char smem\[\];",
     "TR(68) extern __shared__ __align__(1024) unsigned char smem[];"),
    (r"(if \(mag != nullptr\) mag\[o\] = sqrtf\(val\.x \* val\.x \+ val\.y \* val\.y\);\n  \})",
     "\\1 TR(69)"),
]


def build(name: str, subs, out: Path):
    """Start nvcc on a copy of stft_bf16.cu with ``subs`` applied."""
    from disco_tpu_torch.ops import _build

    src = (_build.CSRC / "stft_bf16.cu").read_text()
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n == 0:
            raise RuntimeError(f"variant {name!r}: {pat!r} not in the source")
    tag = re.sub(r"\W+", "_", name)
    cu = out / f"stft_bf16_{tag}.cu"
    cu.write_text(src)
    lib = out / f"libstft_bf16_{tag}.so"
    cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-I", str(_build.CSRC), str(cu), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stft_bf16_variants: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from disco_tpu_torch.ops import stft_ops

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "disco_tpu_torch" / "csrc" / "stft_bf16.cu").read_text()
    for name, (subs, _) in VARIANTS.items():  # every variant applies before any build starts
        for pat, _rep in subs:
            if len(re.findall(pat, src)) != 1:
                raise RuntimeError(f"variant {name!r}: {pat!r} not once in the source")
    jobs = {name: (build(name, subs, out), keeps) for name, (subs, keeps) in VARIANTS.items()}
    traced = build("traced", TRACE, out)
    dev = torch.device("cuda")
    y, s, n = (torch.from_numpy(a).to(dev)
               for a in cs.scene(cs.K, cs.C, int(cs.DUR_S * cs.FS), noise_scale=cs.NOISE_SCALE))
    clip = torch.stack([y, s, n]).reshape(-1, y.shape[-1]).contiguous()     # (96, L)
    rows = {"clip": clip, "batch": clip.repeat(cs.BATCH, 1)}
    win = stft_ops.hann_periodic(512, device=dev)
    frag = stft_ops.dft_fragments(512, str(dev))
    nyq = stft_ops.nyquist_table(512, str(dev))
    want = stft_ops.stft_matmul(clip, with_mag=True, precision="bf16")
    res = {"card": torch.cuda.get_device_name(0), "variants": {}}
    for name, ((lib_path, proc), keeps) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log) + re.findall(r"(\d+) bytes spill stores", log)
        lib = ctypes.CDLL(str(lib_path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.disco_stft_bf16.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        for label, x in rows.items():
            B, L = x.shape
            T = 1 + L // 256
            spec = torch.empty((B, 257, T), dtype=torch.complex64, device=dev)
            mag = torch.empty((B, 257, T), dtype=torch.float32, device=dev)

            def run():
                rc = lib.disco_stft_bf16(x.data_ptr(), win.data_ptr(), frag.data_ptr(),
                                         nyq.data_ptr(), spec.data_ptr(), mag.data_ptr(), B, L,
                                         512, 256, T, None)
                assert rc == 0, rc

            ms = cs.time_ms(run, reps=20)
            row = {"variant": name, "shape": label, "ms": ms, "registers": regs}
            if label == "clip":
                run()
                torch.cuda.synchronize()
                err = max(cs.max_abs(spec, want[0]) / float(want[0].abs().max()),
                          cs.max_abs(mag, want[1]) / float(want[1].abs().max()))
                row["max_abs_of_scale"] = err
                if keeps:
                    cs.require(err <= cs.TOL["stft_bf16"], (name, err))
            res["variants"][f"{name} {label}"] = row
            print(json.dumps(row), flush=True)
    # the traced build at the clip: median cycles between the stamps of the
    # first 64 blocks' thread 0
    log = traced[1].communicate()[0].decode()
    if traced[1].returncode != 0:
        raise RuntimeError(f"nvcc failed for the traced build:\n{log}")
    lib = ctypes.CDLL(str(traced[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.disco_stft_bf16.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
    lib.disco_trace_read.argtypes = [P]
    x = rows["clip"]
    B, L = x.shape
    T = 1 + L // 256
    spec = torch.empty((B, 257, T), dtype=torch.complex64, device=dev)
    mag = torch.empty((B, 257, T), dtype=torch.float32, device=dev)
    for _ in range(3):
        lib.disco_stft_bf16(x.data_ptr(), win.data_ptr(), frag.data_ptr(), nyq.data_ptr(),
                            spec.data_ptr(), mag.data_ptr(), B, L, 512, 256, T, None)
    torch.cuda.synchronize()
    stamps = torch.zeros((64, 72), dtype=torch.int64)
    assert lib.disco_trace_read(stamps.data_ptr()) == 0
    med = lambda a: float(a.double().median())
    trace = {"start to prologue": med(stamps[:, 64] - stamps[:, 68]),
             "prologue (convert 0)": med(stamps[:, 65] - stamps[:, 64]),
             "phases end to stores done": med(stamps[:, 69] - stamps[:, 63]),
             "epilogue barrier wait": med(stamps[:, 67] - stamps[:, 66]),
             "phases 0-7": med(stamps[:, 63] - stamps[:, 0])}
    for k in range(1, 8):
        trace[f"to {TRACE_POINTS[k]}"] = med(sum(
            stamps[:, 8 * p + k] - stamps[:, 8 * p + k - 1] for p in range(7)) / 7)
    res["trace_cycles"] = trace
    print(json.dumps({"traced clip, median cycles (per phase for the phase points)": trace}),
          flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
