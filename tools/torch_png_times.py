"""Times of the port's PNG reading on this host's CPU.

    python3 tools/torch_png_times.py [--root DIR] [--repeats N]

chip_smoke.py's phase-8 frame (``png_frame(CAPTURE_H, CAPTURE_W)``, a
960-row, 540-column RGB ramp with noise) written by ``chip_smoke.png_file``
with every row Paeth, every row Average, Adam7-interlaced with Paeth rows,
and every row Up (the filter of the port's own writer); each file read by
``utils_io.decode_png`` (the path without Pillow) and by Pillow
(``np.asarray(Image.open(...))``) where it imports, the median of N reads
printed, and every array held to the frame.  ``--root DIR`` times the
``dgmesh_torch`` of another checkout (e.g. a parent unpacked with ``git
archive``); a reader that refuses a file is printed as such.
"""

from __future__ import annotations

import argparse
import io
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = {"Paeth": (4, False), "Average": (3, False), "Adam7 Paeth": (4, True), "Up": (2, False)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE, help="the checkout whose dgmesh_torch to time")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))
    from dgmesh_torch import utils_io
    try:
        from PIL import Image
    except ImportError:
        Image = None
    img = chip_smoke.png_frame(chip_smoke.CAPTURE_H, chip_smoke.CAPTURE_W)
    print(f"dgmesh_torch from {os.path.dirname(utils_io.__file__)}; frame {img.shape}; "
          f"{os.cpu_count()} host cores")
    ok = True
    for name, (ft, interlace) in FILES.items():
        blob = chip_smoke.png_file(img, ft, interlace)
        readers = {"decode_png": lambda: utils_io.decode_png(blob)}
        if Image is not None:
            readers["Pillow"] = lambda: np.asarray(Image.open(io.BytesIO(blob)))
        line = []
        for way, read in readers.items():
            secs = []
            try:
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    a = read()
                    secs.append(time.perf_counter() - t0)
            except ValueError as e:
                line.append(f"{way} refuses it ({e})")
                continue
            same = np.array_equal(a, img)
            ok = ok and same
            line.append(f"{way} {statistics.median(secs):.4f} s (median of {args.repeats}; "
                        f"{', '.join(f'{t:.4f}' for t in secs)}), equal to the frame {same}")
        print(f"{name} ({len(blob)} bytes): " + "; ".join(line))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
