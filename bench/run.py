"""Entry of the port's benchmark; see ``bench/lib/harness.py``.

    python3 bench/run.py --workload olmo-1b.chat --seed 7 --seconds 30 --trace 0

Run from the root of a checkout: it imports the benchmark as ``bench`` and
the program under test, ``repro_torch``, from ``src/``.
"""
import os
import sys
import time


def _process_start() -> float:
    """This process's start on the wall clock: its start time since boot
    (``/proc/self/stat``, 10 ms ticks) set against the boot clock now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - since if 0.0 <= since < 600.0 else time.time()
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time()


T_PROC0 = _process_start()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROC0))
