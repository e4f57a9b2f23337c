"""The readings that the output check's limits are set from, on the card at a
cell's own size: the program's compared numbers over many seeds (the lower
readings), and those of the control and of each planted fault (the upper
readings). The benchmark's own runs never run this.

    python3 kge_bench/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--seconds 2] [--out FILE]

Every run is one line of JSON on standard output (and in ``--out``): its
kind (``sound``, ``control`` or ``fault:<name>``), seed and readings. The
control is the reference in the lower precision, read beside each sound
run, or, where the configuration names the program's own lower-precision
path, the program with that path on. Last, the lower and upper reading of
every number.
"""

import argparse
import json
import sys
import time
import traceback

import run as bench_run


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench_run.use_checkout()
    import torch

    from kge_bench import faults
    from kge_bench.harness import spec

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.load_config(bench_run.ROOT, bench, cell["config"])
    kind = spec.load_json(bench_run.ROOT, "traffic", cell["traffic"])["kind"]
    control = cfg["control"][kind]
    runs = [("sound", s, {}) for s in _seeds(args.seeds)]
    if control["side"] == "program":
        runs += [("control", s, {"overrides": {"precision": control["precision"]}})
                 for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{f}", s, {"plant": f}) for f in faults.FAULTS[kind]
             for s in _seeds(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    lines = []
    for what, seed, kw in runs:
        t = time.perf_counter()
        try:
            r = bench_run.run(args.workload, seed, args.seconds, False, device,
                              controls=(what == "sound"), t0=time.perf_counter(), **kw)
            line = {"kind": what, "seed": seed, "readings": r["readings"],
                    "correct": r["correct"], "metrics": r["metrics"], "marks": r["marks"]}
        except Exception:  # a control or fault that crashes gives no number
            line = {"kind": what, "seed": seed, "crashed": traceback.format_exc()[-2000:]}
        line["seconds"] = time.perf_counter() - t
        lines.append(line)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": {}, "upper": {}}
    for line in lines:
        for name, value in line.get("readings", {}).items():
            if line["kind"] == "sound" and not name.startswith("control."):
                summary["lower"][name] = max(value, summary["lower"].get(name, value))
            else:
                key = line["kind"] + ":" + name if line["kind"] != "sound" else name
                summary["upper"][key] = min(value, summary["upper"].get(key, value))
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
