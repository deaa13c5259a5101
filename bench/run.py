"""Benchmark of the port: its batched GP-EI sweep engine and its training step.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file named there (``bench/configs/``), which names
its system (``bench/systems/<system>.py``: ``sweep`` or ``train``) and, for
a sweep, its generator (``bench/generators/``), its traffic mix in
``bench/traffic/<traffic>.json``,
its comparison limits in ``bench/checks/<cell>.json`` and each metric's
reader in ``bench/metrics/<metric>.py``.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones.  The last line of
standard output is the result, a JSON object; the numbers compared with
the reference, each beside its limit, close standard error and the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names no benchmark process may hold: JAX and the JAX
#: package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (``repro_torch`` is not ``repro``)."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in a cell: listed there, or everywhere
    when it lists no cells."""
    return metric.get("workloads") is None or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> dict:
    """The cell ``name`` and everything it names, from files alone."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["config"] = json.loads((root / entry["file"]).read_text())
    cell["traffic"] = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    cell["checks"] = json.loads((root / "bench" / "checks" / f"{name}.json").read_text())
    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m, name)]
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m, name)]
    return cell


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str = "cuda", simulate=None,
         out=None, err=None) -> int:
    """One run.  ``device="cpu"`` and ``simulate`` (the program's entry that
    the cell's system drives; by default the system's own) are for the
    harness's own tests and controls."""
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    cell = load_cell(root, args.workload)
    # build and kernel caches of the program stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / "bench" / sub))
    sys.path.insert(0, str(root / "src"))
    import torch

    from bench import load_module

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
        return 2
    dev = torch.device(device)
    system = load_module(root / "bench" / "systems" / f"{cell['config']['system']}.py",
                         f"bench_system_{cell['config']['system']}")
    ctx = system.run(root, cell, args.seed, args.seconds, bool(args.trace), dev,
                     simulate, T_START)

    metrics = {}
    for m in cell["per_layer"] if args.trace else cell["end_to_end"]:
        value = load_module(root / "bench" / "metrics" / f"{m['name']}.py",
                            f"bench_metric_{m['name']}").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell["chips"], "memory_peak_bytes": ctx["window"]["peak_bytes"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = {"correct": False, "attempted": ctx["attempted"], "failed": ctx["failed"],
            "metrics": metrics, "device": info}
    if ctx["profile"]:
        info["busy_s"] = ctx["profile"]["busy_s"]
        info["window_s"] = ctx["profile"]["window_s"]
        line["breakdown"] = ctx["profile"]["breakdown"]
    checks = {k: {"value": v, "limit": cell["checks"][k]} for k, v in ctx["checks"].items()}
    # the count of what was compared, under the system's own name
    counted = ctx["checked"]
    checks[counted["name"]] = {"value": counted["value"], "limit": counted["limit"]}
    line["correct"] = (ctx["failed"] == 0 and counted["value"] == counted["limit"]
                       and all(c["value"] <= c["limit"] for k, c in checks.items()
                               if k != counted["name"]))
    line["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=err)
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
