"""The readings that a cell's limits are set from, at the cell's own size:

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \\
        [--system program|control] [--fault <name>] [--seconds 3]

runs the cell once a seed in this process (the program, the fp8 control,
or the program with a fault of ``faults.py`` planted), each with a short
window, and prints one JSON line a run with each compared number. The
benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

from benchmark import core, faults, traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--system", default="program",
                    choices=("program", "control"))
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mix", action="append", default=[],
                    help="key=value (a JSON value) replacing a key of the "
                         "cell's traffic mix, for a probe")
    args = ap.parse_args(argv)
    man = core.manifest()
    w = next(x for x in man["workloads"] if x["name"] == args.workload)
    kind = traffic.load(w["traffic"])["kind"]
    mix = {k: json.loads(v) for k, v in (m.split("=", 1) for m in args.mix)}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = (faults.planted(args.fault, kind) if args.fault
               else contextlib.nullcontext())
        with ctx:
            r = core.run(args.workload, seed, args.seconds, False, "cuda:0",
                         time.perf_counter(), system=args.system, man=man,
                         mix_over=mix)
        _print(args, seed, r)
    return 0


def _print(args, seed, r) -> None:
    print(json.dumps({"workload": args.workload, "seed": seed,
                      "system": args.system, "fault": args.fault,
                      "correct": r["correct"], "failed": r["failed"],
                      "attempted": r["attempted"],
                      "checks": {k: v for k, (v, _) in r["checks"].items()},
                      "numbers": r["numbers"],
                      "values": r["values"], "notes": r["notes"]}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
