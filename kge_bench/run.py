"""Run one cell of the benchmark once, and print its result as the last line.

    python3 kge_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by name
(``harness/spec.py``). With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
trace's breakdown. Every run checks what its timed path produced against
the plain reference and prints each compared number beside its limit, last
on standard error and last in the result. It needs CUDA and as many cards
as the cell asks for, and exits with an error otherwise.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "knowledgegraphembedding_tpu")
#: fixed directories inside the checkout for every compile cache
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def use_checkout(root: str = ROOT) -> None:
    """Import from the checkout (not from the benchmark's folder), and keep
    compile caches at fixed paths inside it."""
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    if root not in sys.path:
        sys.path.insert(0, root)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(root, "kge_bench", ".cache", sub)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, device, root: str = ROOT,
        overrides=None, plant=None, controls: bool = False, t0: float = T0) -> dict:
    """One run of ``workload`` on ``device`` (a torch.device): the result's
    keys, and ``readings``, every number the output check read."""
    import torch

    from kge_bench.harness import spec
    from kge_bench.harness.context import Ctx

    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, workload)
    cfg = spec.load_config(root, bench, cell["config"], overrides)
    mix = spec.load_json(root, "traffic", cell["traffic"])
    limits = spec.load_json(root, "limits", workload)
    ctx = Ctx(root=root, cell=workload, cfg=cfg, mix=mix, seed=seed, seconds=seconds,
              trace=trace, device=device, t0=t0,
              model_ref=spec.reference_model(root, cfg["model"]),
              counts=spec.model_counts(root, cfg["model"]), peaks=spec.peaks(root),
              limits={k: v["limit"] for k, v in limits.items()}, controls=controls)
    runner = spec.kind(root, mix["kind"])
    if plant is None:
        out = runner.run(ctx)
    else:
        from kge_bench import faults

        with faults.planted(plant, mix["kind"]):
            out = runner.run(ctx)

    metrics = {}
    if trace:
        for m in spec.per_layer_of(bench, workload):
            value = spec.metric(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": out["setup_s"], **out["e2e"]}
        for m in spec.end_to_end_of(bench, workload):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": out["readings"][name], "limit": limit}
              for name, limit in ctx.limits.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if trace and ctx.traced is not None:
        dev["busy_s"] = ctx.traced.busy_s
        dev["window_s"] = ctx.traced.window_s
        result["breakdown"] = {"device_ops": ctx.traced.device_ops(),
                               "idle_gaps": ctx.traced.idle_gaps()}
    result["checks"] = checks
    result["readings"] = out["readings"]
    result["marks"] = ctx.marks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout()
    import torch

    if torch.cuda.is_available():
        torch.cuda.init()
    print(f"kge_bench: imports and CUDA set up at {time.perf_counter() - T0:.2f} s",
          file=sys.stderr)

    from kge_bench.harness import spec

    chips = spec.workload(spec.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kge_bench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"kge_bench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    marks = result.pop("marks")
    del result["readings"]
    print("kge_bench: seconds since start at the end of "
          + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
