"""The readings that the limits of ``correct`` are set from, on the card.

    python -m benchmarks.calibrate --workload <name> --seeds 1,2,3 [--control 3]
        [--seconds 2] [--out calibration.jsonl]

One process sets the cell up once, then for every seed runs a short window
of the cell's own traffic at its own size and compares the sampled lanes
with the float64 reference, as a run does; for the first ``--control``
seeds it also puts the reference computed in bfloat16 (the control) in the
program's place on the same inputs.  Each reading is one JSON line.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmarks import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]

    spec = R.load_spec()
    wl, config, cell, traffic = R.load_cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    run = R.Run(wl, config, cell, seeds[0], args.seconds, False, device=torch.device("cuda", 0))
    st = traffic.setup(run)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        st.reseed(seed)
        run.seed = seed
        traffic.window(run, st)
        held = traffic.release(run, st)
        t = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "calls": run.calls,
               "rate": run.items / (run.t1 - run.t0),
               "program": {c["name"]: c["value"] for c in traffic.check(run, held)},
               "check_s": time.perf_counter() - t, "record": run.counters.get("record")}
        rows = [row]
        if i < args.control:
            rows.append({"workload": args.workload, "seed": seed,
                         "control_bf16": traffic.control(run, held)})
        for r in rows:  # the program's reading first: a control that fails leaves it
            print(json.dumps(r), flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
