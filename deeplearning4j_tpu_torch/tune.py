"""Measure the kernel-vs-generic crossovers on the card and write the
tuning table (the port's ``tools/tune.py``).

    python -m deeplearning4j_tpu_torch.tune [--smoke] [--ops OP ...]
        [--out deeplearning4j_tpu_torch/ops/tuning_tables/<kind>.json]
        [--report build/tune_report.json]

Without ``--out`` or ``--smoke`` the table lands in the cache directory
(``ops/tuning.py`` ``cache_path``), which overlays the checked-in table
for every later run in this checkout. ``--out`` writes it only where it
can be checked in: ``ops/tuning_tables/<device kind>.json`` is read on
every card of that kind. ``--smoke`` leaves no cache file either, so its
tiny-ladder crossovers never route a later run. ``--report`` keeps the
table and every point's kernel and generic times.
"""

from __future__ import annotations

import argparse
import json
import sys

from deeplearning4j_tpu_torch.ops import tuning


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny ladders (checks the code path)")
    ap.add_argument("--ops", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--report", default=None)
    a = ap.parse_args(argv)
    table, report = tuning.autotune(ops=a.ops, smoke=a.smoke,
                                    save=not (a.smoke or a.out))
    doc = {"table": table.to_dict(), "report": report.to_dict()}
    if a.out:
        table.save(a.out)
    if a.report:
        with open(a.report, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
