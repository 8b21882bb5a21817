"""The readings that the limits of ``portbench/limits/`` are set from: the
program's numbers on many seeds and the control's on a few, in one
process, each seed a whole run of the cell with a short window.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--seconds 3] [--out <file.json>]

The control is the plain reference computed in TF32, put in the
program's place. This script is not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run as R  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    p.add_argument("--fault", default=None,
                   help="plant this fault of the driver in every run")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        R.log("readings need a CUDA device")
        return 2
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    seeds = [int(s) for s in a.seeds.split(",")]
    rows = []
    for seed in seeds + sorted(ctl - set(seeds)):
        res = R.run(a.workload, seed, a.seconds, False,
                    control=seed in ctl, readings=True, fault=a.fault)
        row = dict(seed=seed, correct=res["correct"],
                   attempted=res["attempted"], failed=res["failed"],
                   program=res["numbers"],
                   control=res.get("control"),
                   metrics={k: v["value"] for k, v in res["metrics"].items()})
        R.log(json.dumps(row))
        # the leaves' norms behind a train cell's numbers, for the file
        row["leaves"] = res.get("leaves")
        rows.append(row)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    out = dict(workload=a.workload, fault=a.fault, device=R.power_limit(),
               rows=rows)
    for key in rows[0]["program"]:
        prog = [r["program"][key] for r in rows if r["seed"] in seeds]
        ctrl = [r["control"][key] for r in rows if r["control"]]
        out[key] = dict(lower=max(prog), upper=min(ctrl) if ctrl else None)
    text = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
