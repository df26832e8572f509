"""Readings for a cell's limits, on the card at the cell's own size; the
benchmark's runs never run this.

    python3 xbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 15 [--control 1,2,3] [--witness 1,2] \
        [--fault one_slot_corrupted] [--out readings.jsonl]

For each seed, in one process: draw the inputs, serve a short window of
the cell's traffic at the cell's load (long enough for the mix's
longest answer to finish), and read the check's numbers for the
program; for the seeds listed under ``--control``, also the control's:
the float32 reference's gap at the token that the reference computed
with float8 e4m3 products puts first; under ``--witness``, the same for
the reference with bfloat16 operands. ``--fault`` plants one of
``xbench/faults.py``'s faults in the program first, so the program's
numbers are those of the broken path. One JSON line a seed.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--witness", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    from xbench import check, harness
    from xbench.faults import FAULTS
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell), bench.mix(cell)
    count = int(bench.limits(cell)["sample_requests"])
    control = {int(s) for s in args.control.split(",") if s}
    witness = {int(s) for s in args.witness.split(",") if s}
    if args.fault:
        FAULTS[args.fault](setattr, int(mix["clients"]))
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run, tree = harness.serve(cfg, mix, seed, args.seconds, device=dev)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        read = check.compare(run, tree, cfg, seed, count,
                             control=seed in control,
                             witness=seed in witness)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault or None,
                "serve_s": t1 - t0, "check_s": time.perf_counter() - t1,
                "completed": sum(s.completed for s in run.requests.values()),
                **read}
        print(json.dumps(line), flush=True)
        if out is not None:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run, tree
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
