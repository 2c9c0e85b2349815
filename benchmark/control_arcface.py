"""The readings that the ArcFace cell's correctness limits are set from, as
:mod:`benchmark.control` gives them for the triplet cells (not run by the
benchmark itself):

    python3 benchmark/control_arcface.py --workload vit-b16-arcface-train \
        --seeds 1,2,3 [--program] [--control] [--faults unchanged,half]

For each seed it prints one JSON line per reading: ``program`` (the
program as the cell runs it against the plain float32 reference),
``control`` (the reference computed in fp8 put in the program's place) and
each named fault planted in the program. The readings come from the set-up
epoch's recorded steps; no window runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed, device, program, control, faults):
    from benchmark.drivers import arcface_epochs as ae
    from benchmark.reference.precision import Quant

    out = []
    runs = ([None] if program or control else []) + list(faults)
    for fault in runs:
        r = ae.Run(cell, seed, device, fault=fault)
        try:
            r.warm()
            prog = r.program_readings()
            r.release()
            ref = r.reference_readings()
            w0 = r.initial_params()
            if fault is not None:
                out.append((fault, ae.compare(prog, ref, w0)))
                continue
            if program:
                out.append(("program", ae.compare(prog, ref, w0)))
            if control:
                out.append(("control", ae.compare(
                    r.reference_readings(quant=Quant()), ref, w0)))
        finally:
            r.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(args.workload)
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for kind, numbers in readings(cell, seed, args.device, args.program,
                                      args.control, faults):
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
