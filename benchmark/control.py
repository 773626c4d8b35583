"""Readings of a cell's checks for sound runs of the program and for its control.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--sound-only]
                                 [--fault <name>]

For each seed, in one process: the cell's set-up, one job of the timed path
at the cell's own size (the sound reading), then the control in the
program's place (the cell's driver's ``control``: the reference computed
in bfloat16), each held to the cell's checks.  One JSON line a seed:
``{"seed", "sound": {check: value}, "control": {check: value}}`` (no ``"control"`` with
``--sound-only``).  The cell runs on its own cards, as ``benchmark/run.py``
runs it.  The
benchmark's own runs never run the control; the limits in the cell's file
lie between the largest sound reading and the smallest control reading.
With ``--fault`` (``benchmark/faults.py``) the fault is planted for the
whole run and a line holds its readings instead: ``{"seed", "fault":
{check: value}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.faults import FAULTS, planted  # noqa: E402
from benchmark.run import HERE, load_json, load_module, make_ctx  # noqa: E402


def readings(name: str, seed: int, devices, overrides: dict | None = None,
             fault: str | None = None, control: bool = True) -> dict:
    """{"seed", "sound", "control"} of one seed of cell ``name`` ("control"
    only with ``control``), or with ``fault`` {"seed", "fault"}, on
    ``devices`` (a list, or one device: see ``run.cell_devices``)."""
    tmp = Path(tempfile.mkdtemp(prefix="apd_control_", dir=os.environ.get("TMPDIR")))
    try:
        ctx = make_ctx(name, seed, devices, tmp, overrides)
        driver = load_module(HERE / "traffic" / f"{ctx.cell['driver']}.py")
        if fault:
            with planted(fault):
                state = driver.setup(ctx)
                _, out = driver.run_job(state)
            driver.release(state)
            return {"seed": seed, "fault": {n: v for n, v, _ in driver.check(ctx, out)}}
        state = driver.setup(ctx)
        _, out = driver.run_job(state)
        ctl = driver.control(ctx, state) if control else None
        driver.release(state)
        got = {"seed": seed, "sound": {n: v for n, v, _ in driver.check(ctx, out)}}
        del out
        if control:
            got["control"] = {n: v for n, v, _ in driver.check(ctx, ctl)}
        return got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound-only", action="store_true", help="no control readings")
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args()
    import torch

    chips = int(load_json(HERE / "workloads" / f"{args.workload}.json")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, torch.device("cuda", 0),
                                  fault=args.fault, control=not args.sound_only)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
