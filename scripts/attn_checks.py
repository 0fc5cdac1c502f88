#!/usr/bin/env python3
"""The attention kernels (K5 prefill flash attention, K4 flash decoding)
against their plain versions, with their times, alone: ``chip_smoke.py``'s
attention checks without the serve runs.

    python3 scripts/attn_checks.py                  # this checkout
    python3 scripts/attn_checks.py --root DIR       # another checkout

``--root`` imports ``chip_smoke.py`` and ``src/repro_torch`` from another
checkout (an unpacked earlier commit), so two versions of the kernels can
be timed in turns on one card, each by its own tree's checks: run it for
the old tree, the new, the new and the old again. ``--prefill`` also
times full-width llama3-8b prefilling one 2048-token prompt (random
weights from seed 0; host clock around synchronized calls, after two
warm-up calls), the end-to-end view of K5's share. Every case prints the
kernel's device time (CUDA-graph replay), an eager call's host time, the
plain version's and SDPA's device time and the bound. Builds only
``flash_attention.cu`` and ``decode_attention.cu``, and prints their ptxas
report. Needs one CUDA device; imports no JAX.
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
    ap.add_argument("--prefill", action="store_true",
                    help="also time a full-width llama3-8b 2048-token "
                         "prefill")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("attn_checks: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        raise SystemExit(f"imported {cs.__file__}, not {root}")
    print(f"[attn_checks] root={root} | {cs.smi_line()}", flush=True)
    srcs = [Path(sys.modules[cs.KERNELS[n]["wrapper"].__module__].SOURCE)
            for n in cs.ATTENTION]
    t0 = time.perf_counter()
    cs._build.build_all(srcs)
    print(f"[attn_checks] built {' '.join(s.name for s in srcs)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for src in srcs:
        log = cs._build.library_path(src)
        log = log.with_name(log.name + ".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line or "arning" in line:
                print(f"[attn_checks] ptxas {src.stem}: {line.strip()}")
    cs.kernel_checks()
    if args.prefill:
        prefill_ms(cs)
    return 0


def prefill_ms(cs, calls: int = 5) -> list:
    """Wall time of full-width llama3-8b prefilling one 2048-token prompt
    through this tree's model (K5 in every layer)."""
    import numpy as np
    import torch
    cfg = cs.get_config("llama3-8b")
    model = cs.build(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 2048)).astype(np.int32)).cuda()
    for _ in range(2):
        model.prefill(params, {"tokens": prompt}, 2049)
    times = []
    for _ in range(calls):
        cs.zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompt}, 2049)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n = cs.flash_attention.launches
    print(f"[attn_checks] llama3-8b 2048-token prefill: "
          f"{' '.join(f'{t:.2f}' for t in times)} ms (min {min(times):.2f}, "
          f"median {sorted(times)[calls // 2]:.2f}); flash_attention "
          f"launches a prefill {n}", flush=True)
    return times


if __name__ == "__main__":
    sys.exit(main())
