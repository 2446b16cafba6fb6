"""Where does ``chip_smoke.py``'s wall time go?  Runs the smoke in this
process while a thread samples the main thread's Python stack every 20
ms (``sys._current_frames()``), then writes the inclusive seconds of
every function on the stack and of every ``chip_smoke.py`` line on it,
largest first.  A sample counts once for each function (and line) on
its stack, so a caller holds its callees' time; a C call that releases
the GIL (a kernel launch, a copy, a sync) is charged to the Python line
that made it.  The sampler adds a thread that takes the GIL 50 times a
second: the smoke runs a few per cent slower under it, and its training
phase's steps more (their autograd threads take the GIL too).

Usage (one card, from the repo root; arguments go to the smoke):
  python3 scripts/profile_smoke.py [--out chiprun_out/smoke_profile.txt]
"""

from __future__ import annotations

import collections
import os
import runpy
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PERIOD_S = 0.02


def main(argv: list[str]) -> int:
    out = ROOT / "chiprun_out" / "smoke_profile.txt"
    if argv[:1] == ["--out"]:
        out, argv = Path(argv[1]), argv[2:]
    main_id = threading.get_ident()
    by_fn: collections.Counter = collections.Counter()
    by_line: collections.Counter = collections.Counter()
    samples = 0
    stop = threading.Event()

    def sample() -> None:
        nonlocal samples
        while not stop.wait(PERIOD_S):
            frame = sys._current_frames().get(main_id)
            fns, lines = set(), set()
            samples += 1
            while frame is not None:
                code = frame.f_code
                fns.add(f"{os.path.basename(code.co_filename)}:"
                        f"{code.co_name}")
                if code.co_filename.endswith("chip_smoke.py"):
                    lines.add(f"line {frame.f_lineno} ({code.co_name})")
                frame = frame.f_back
            by_fn.update(fns)
            by_line.update(lines)

    threading.Thread(target=sample, daemon=True).start()
    sys.argv = [str(ROOT / "chip_smoke.py"), *argv]
    rc = 0
    try:
        runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        stop.set()
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            fh.write(f"{samples} samples of {PERIOD_S * 1e3:.0f} ms\n"
                     f"== inclusive seconds by function\n")
            for key, n in by_fn.most_common(400):
                fh.write(f"{n * PERIOD_S:9.1f}s {key}\n")
            fh.write("== inclusive seconds by chip_smoke.py line\n")
            for key, n in by_line.most_common(600):
                fh.write(f"{n * PERIOD_S:9.1f}s {key}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
