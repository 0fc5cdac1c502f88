"""Roofline of the dry run's cells on NVIDIA H100s — the port of
``repro.launch.roofline``, with the H100's own figures.

Hardware model, per GPU (NVIDIA's H100 SXM data sheet, dense, at the 700 W
power limit):

* ``PEAK_FLOPS`` 989 TFLOP/s, bf16 on the tensor cores;
* ``HBM_BW`` 3.35 TB/s, HBM3;
* ``LINK_BW`` 50 GB/s a direction: one 400 Gb/s NDR InfiniBand NIC a GPU
  (a DGX H100 node has eight, one a GPU). NVLink joins only the 8 GPUs of a
  node (450 GB/s a direction each); the production meshes' model axis of
  16 spans two nodes, so a collective over it is held by the NIC hop, the
  slowest link on its ring.

The dry run's numbers are per device (rank 0's local blocks), so the terms
are computed directly:

  compute_term    = flops / PEAK_FLOPS              [s]
  memory_term     = bytes_accessed / HBM_BW         [s]
  collective_term = collective_bytes / LINK_BW      [s]

``bytes_accessed`` is the port's count (``launch/dryrun.py``): the inputs
and outputs of every non-view op and kernel call, each once — an upper
estimate of a fused program's traffic. MODEL_FLOPS (useful) is 2 N_active
D a step for inference and 6 N_active D for a train step (forward and
backward over its 4096 x 256 tokens), per device; the ratio MODEL_FLOPS / flops flags
waste (replicated kv projections, head padding, attention over the whole
cache).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # B/s / GPU
LINK_BW = 50e9               # B/s a direction / GPU: one 400 Gb/s NIC


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    traced_flops: float = 0.0
    useful_ratio: float = 0.0
    peak_gib: float = 0.0
    note: str = ""


def model_flops_per_device(rec: dict) -> float:
    """Useful FLOPs per device for this cell's step."""
    chips = rec["chips"]
    n_act = rec["active_params"]
    if rec["shape"] == "train_4k":
        # forward and backward: 6 N_active D over the step's tokens
        return 6.0 * n_act * 4096 * 256 / chips
    tokens = {"prefill_32k": 32768 * 32, "decode_32k": 128,
              "long_500k": 1}.get(rec["shape"])
    if tokens is None:
        raise ValueError(f"{rec['shape']} has no roofline")
    return 2.0 * n_act * tokens / chips


def analyse(rec: dict) -> RooflineRow:
    row = RooflineRow(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                      status=rec["status"])
    if rec["status"] != "OK":
        row.note = rec.get("reason", rec.get("error", ""))[:120]
        return row
    flops = rec["cost"]["flops"]
    byts = rec["cost"]["bytes_accessed"]
    coll = rec["collectives"]["total_bytes"]
    row.compute_s = flops / PEAK_FLOPS
    row.memory_s = byts / HBM_BW
    row.collective_s = coll / LINK_BW
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s}
    row.dominant = max(terms, key=terms.get)
    row.traced_flops = flops
    row.model_flops = model_flops_per_device(rec)
    row.useful_ratio = row.model_flops / flops if flops else 0.0
    row.peak_gib = rec["memory"]["peak_bytes_per_device"] / 2**30
    return row


WHAT_WOULD_HELP = {
    "compute": ("cut non-useful FLOPs: shard the kv projections, un-padded "
                "head sharding, attention over the live cache only"),
    "memory": ("raise arithmetic intensity: fuse elementwise chains, bf16 "
               "intermediates, fewer layout copies"),
    "collective": ("overlap or shrink traffic: keep the model axis inside "
                   "one NVLink node, fewer resharding boundaries"),
}


def load_rows(out_dir: str) -> list[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rows.append(analyse(json.load(f)))
    return rows


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | status | compute s | memory s | "
           "collective s | dominant | useful ratio | peak GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.status != "OK":
            lines.append(f"| {r.arch} | {r.shape} | {r.mesh} | {r.status} "
                         f"| - | - | - | - | - | - |")
            continue
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | OK "
            f"| {r.compute_s:.4g} | {r.memory_s:.4g} "
            f"| {r.collective_s:.4g} | **{r.dominant}** "
            f"| {r.useful_ratio:.3f} | {r.peak_gib:.2f} |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--md", default=None, help="write markdown table here")
    args = ap.parse_args(argv)
    rows = load_rows(args.results)
    print(markdown_table(rows))
    ok = [r for r in rows if r.status == "OK"]
    for r in ok:
        print(f"# {r.arch}/{r.shape}/{r.mesh}: dominant={r.dominant} -> "
              f"{WHAT_WOULD_HELP[r.dominant][:80]}...")
    if args.md:
        with open(args.md, "w") as f:
            f.write(markdown_table(rows))


if __name__ == "__main__":
    main()
