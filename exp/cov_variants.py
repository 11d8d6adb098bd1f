#!/usr/bin/env python3
"""The covariance kernel's frame tile and slice count, timed on the card.

``csrc/cov.cu`` gives each (b, f) bin ``kSlices`` threads per upper-triangle
pair and copies ``kTile`` frames of the bin's rows at a time into shared
memory, double-buffered.  This script builds ``cov.cu`` once for each
(kTile, kSlices) below (the constants replaced in a copy of the source),
and times each straight through the library (CUDA events, an L2 flush
before each call, as ``chip_smoke.py``) on the step-1 (C = 4) and step-2
(D = 11) spectra of ``chip_smoke.py``'s north-star clip and of its 16-clip
batch (the clip repeated), each held to ``masked_covariances_folded``.
Run on the card from the root of the checkout::

    python3 exp/cov_variants.py

It prints one JSON object.
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

#: (kTile, kSlices)
VARIANTS = ((64, 4), (64, 2), (64, 8), (128, 2), (128, 4), (256, 2))


def clip_spectra(dev):
    """(step-1 spectra (K, C, F, T), step-2 stack (K, D, F, T), mask
    (K, F, T)) of chip_smoke.py's clip, through the port's STFT kernel."""
    import torch

    import chip_smoke as cs
    from disco_tpu_torch.core.masks import tf_mask_mag
    from disco_tpu_torch.enhance.tango import others_index
    from disco_tpu_torch.ops import stft_ops

    y, s, n = (torch.from_numpy(a).to(dev)
               for a in cs.scene(cs.K, cs.C, int(cs.DUR_S * cs.FS), noise_scale=cs.NOISE_SCALE))
    spec, mag = stft_ops.stft_kernel(torch.stack([y, s, n]), with_mag=True)
    m = tf_mask_mag(mag[1][:, 0], mag[2][:, 0], "irm1")
    oth = torch.as_tensor(others_index(cs.K), device=dev)
    return spec[0], torch.cat([spec[0], spec[0][:, 0][oth]], dim=1), m


def build(tile: int, slices: int, out: Path):
    """Start nvcc on cov.cu with kTile and kSlices replaced."""
    from disco_tpu_torch.ops import _build

    src = (_build.CSRC / "cov.cu").read_text()
    src = re.sub(r"constexpr int kTile = \d+;", f"constexpr int kTile = {tile};", src)
    src = re.sub(r"constexpr int kSlices = \d+;", f"constexpr int kSlices = {slices};", src)
    cu = out / f"cov_{tile}_{slices}.cu"
    cu.write_text(src)
    lib = out / f"libcov_{tile}_{slices}.so"
    cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
           "-I", str(_build.CSRC), str(cu), "-o", str(lib)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cov_variants: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from disco_tpu_torch.ops import cov_ops

    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {v: build(*v, out) for v in VARIANTS}
    dev = torch.device("cuda")
    Y, in_y, m = clip_spectra(dev)
    shapes = {"clip step1": (Y, m), "clip step2": (in_y, m)}
    shapes["batch step1"] = tuple(x[None].expand(cs.BATCH, *x.shape).contiguous() for x in (Y, m))
    shapes["batch step2"] = tuple(x[None].expand(cs.BATCH, *x.shape).contiguous()
                                  for x in (in_y, m))
    res = {"card": torch.cuda.get_device_name(0), "variants": {}}
    for (tile, slices), (lib_path, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tile, slices}:\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.disco_masked_cov.argtypes = [P, P, P, P, I, I, I, I, I, P]
        for label, (yy, mm) in shapes.items():
            *lead, C, F, T = yy.shape
            rs = torch.empty(tuple(lead) + (F, C, C), dtype=torch.complex64, device=dev)
            rn = torch.empty_like(rs)
            B = int(torch.tensor(lead).prod())

            def run():
                rc = lib.disco_masked_cov(yy.data_ptr(), mm.data_ptr(), rs.data_ptr(),
                                          rn.data_ptr(), B, C, F, T, 0, None)
                assert rc == 0, rc

            ms = cs.time_ms(run, reps=20)
            ps, pn = cov_ops.masked_covariances_folded(yy, mm)
            err = max(cs.max_rel(rs, ps), cs.max_rel(rn, pn))
            key = f"{label} kTile={tile} kSlices={slices}"
            res["variants"][key] = {"ms": ms, "max_rel": err}
            print(json.dumps({"variant": key, "ms": ms, "max_rel": err}), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
