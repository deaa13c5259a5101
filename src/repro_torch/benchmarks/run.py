"""Paper-figure driver of the port: one section per figure, on the card.

Prints ``name,us_per_call,derived`` CSV rows (``derived`` packs each
figure's figure of merit as ``key=value`` pairs joined by ``;``), the JAX
drivers' rows.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [section ...] [--seeds S]

Sections (default: all):
  fig2      single-device policy comparison, Azure + DeepLearning
  fig3      device-count sweep for MM-GP-EI
  fig4      policy comparison on four devices
  fig5      synthetic Matérn near-linear-speedup sweep

Each section also records its rows to ``BENCH_torch_<section>.json`` in the
working directory, stamped with the card's name, count, CUDA version, and
driver version and power limit.  Every episode runs on the card; without
one the sections fail (the driver functions take ``device="cpu"``).

Flags (forwarded to the figure modules):
  --engine {event,batched}   ``event`` is the host event loop; ``batched``
                             raises NotImplementedError (the batched sweep
                             engine is not ported yet).
  --seeds S                  seeds (fig5: repeats) per configuration.

Set BENCH_FAST=1, or pass --smoke, for a quick pass (fewer seeds and device
counts).
"""

from __future__ import annotations

import argparse
import sys
import traceback

from . import common
from .common import positive_int

SECTIONS = ("fig2", "fig3", "fig4", "fig5")

# section -> BENCH_<suite>.json written next to the CSV; named apart from
# the JAX drivers' BENCH_fig*.json
SUITE_NAMES = {s: f"torch_{s}" for s in SECTIONS}


def _parse_args():
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sections", nargs="*", metavar="section",
                   help=f"sections to run: {', '.join(SECTIONS)} (default: all)")
    p.add_argument("--engine", choices=("event", "batched"), default="event",
                   help="episode engine (default: event)")
    p.add_argument("--seeds", type=positive_int, default=None,
                   help="seeds per configuration")
    p.add_argument("--smoke", action="store_true",
                   help="fewer seeds and device counts (sets BENCH_FAST=1 "
                        "before the figure modules import)")
    args = p.parse_args()
    bad = [s for s in args.sections if s not in SECTIONS]
    if bad:
        p.error(f"unknown section(s) {bad}; choose from {', '.join(SECTIONS)}")
    return args


def main() -> None:
    args = _parse_args()
    if args.smoke:
        # must precede the lazy section imports: they bind common.FAST then
        common.set_fast(True)
    want = list(args.sections) or list(SECTIONS)
    print("name,us_per_call,derived")
    failures = []
    for section in want:
        try:
            if section == "fig2":
                from . import fig2_single_device as m
            elif section == "fig3":
                from . import fig3_multi_device as m
            elif section == "fig4":
                from . import fig4_four_devices as m
            else:
                from . import fig5_synthetic_speedup as m
            common.begin_suite(SUITE_NAMES[section])
            m.main()
            path = common.end_suite()
            if path is not None:
                print(f"# wrote {path}", file=sys.stderr)
        except Exception:
            common.abort_suite()   # partial rows are not written
            failures.append(section)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"benchmark sections failed: {failures}")


if __name__ == "__main__":
    main()
