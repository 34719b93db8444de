"""Benchmark: seeded 4-frame panoramas end to end on one GPU.

Frames come from utils/synth.py (seed 0): 4 x 512x384, the shape of the
reference's Input/ set, and 4 x 1440x1080, the BASELINE north star. Each
size is stitched once cold (compiling every stage) and then 8 times warm;
each run is wall time from host u8 frames to the u8 panorama on the host.

The reference stitches its own Input/ photographs (4 x 384x512) in 1.83 s
on an i9-9900K (16340028.md:728-744, BASELINE.md); vs_baseline is that
time over our median at the same frame shape (the scene differs).

Prints the card's name and power limit (nvidia-smi), then one JSON line per
size. Exits non-zero without a GPU: there is no CPU fallback.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

BASELINE_MS = 1830.0
SIZES = (("panorama_4img_512x384_e2e_ms", (512, 384)),
         ("panorama_4img_1440x1080_e2e_ms", (1440, 1080)))


def main() -> int:
    import jax
    import numpy as np

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(json.dumps({"ok": False,
                          "error": f"no GPU (first device: "
                                   f"{devs[0].platform})"}))
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    from computervisionimagestich2_tpu.models.stitcher import Stitcher
    from computervisionimagestich2_tpu.utils.cache import enable_compile_cache
    from computervisionimagestich2_tpu.utils.synth import render_sweep

    enable_compile_cache()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    for metric, hw in SIZES:
        frames = render_sweep(0, 4, *hw).frames
        st = Stitcher()
        t0 = time.perf_counter()
        st.stitch(frames)
        cold = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            out = st.stitch(frames)
            times.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(times))
        line = {"metric": metric, "value": med, "unit": "ms",
                "min_ms": min(times), "cold_ms": cold,
                "canvas": list(out.shape[:2]), "device": device,
                "card": card}
        if hw == (512, 384):
            line["vs_baseline"] = BASELINE_MS / med
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
