"""The readings that the correctness limits are set from (not run by the
benchmark itself):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--program] [--control] [--faults half,...]

For each seed it prints one JSON line per reading: ``program`` (the program
as the cell runs it against the plain float32 reference), ``control`` (the
reference computed in fp8, the next precision below the configuration's
bf16, put in the program's place) and each named fault planted in the
program (``unchanged``, ``half``). The readings need no window: they come
from the set-up's recorded steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train_readings(cell, seed, device, program, control, faults):
    from benchmark.drivers import train_epochs as te
    from benchmark.reference.precision import Quant

    out = []
    if program or control:
        r = te.Run(cell, seed, device)
        try:
            r.warm()
            prog = r.program_readings()
            r.release()
            ref = r.reference_readings()
            w0 = r.initial_params()
            if program:
                out.append(("program", te.compare(prog, ref, w0)))
            if control:
                out.append(("control", te.compare(
                    r.reference_readings(quant=Quant()), ref, w0)))
        finally:
            r.close()
    for fault in faults:
        r = te.Run(cell, seed, device, fault=fault)
        try:
            r.warm()
            prog = r.program_readings()
            r.release()
            out.append((fault, te.compare(prog, r.reference_readings(),
                                          r.initial_params())))
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
        got = train_readings(cell, seed, args.device, args.program,
                             args.control, faults)
        for kind, numbers in got:
            print(json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                              **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
