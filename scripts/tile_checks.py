#!/usr/bin/env python3
"""The tile kernels (K1 drain, K2 drain + flight recorder, K3 executor)
against their plain versions, with their times, alone: ``chip_smoke.py``'s
tile phase without the serve runs.

    python3 scripts/tile_checks.py                  # this checkout
    python3 scripts/tile_checks.py --root DIR       # another checkout

``--root`` imports ``chip_smoke.py`` and ``src/repro_torch`` from another
checkout (an unpacked earlier commit), so two versions of the kernels can
be timed in turns on one card, each by its own tree's checks: run it for
the old tree, the new, the new and the old again. Builds only
``persistent.cu``. Needs one CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="checkout whose chip_smoke.py and kernels to run")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("tile_checks: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        raise SystemExit(f"imported {cs.__file__}, not {root}")
    print(f"[tile_checks] root={root} | {cs.smi_line()}", flush=True)
    src = Path(cs.PK.kernel.SOURCE)
    t0 = time.perf_counter()
    cs._build.build_all([src])
    log = cs._build.library_path(src)
    log = log.with_name(log.name + ".log")
    print(f"[tile_checks] built {src.name} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for line in log.read_text().splitlines() if log.exists() else ():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            print(f"[tile_checks] ptxas {line.strip()}")
    cs.tile_kernel_checks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
