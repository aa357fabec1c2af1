"""Profile two versions of the port in turns on one card: parent, change,
change, parent for each model, so that the host clock's drift between
processes falls on both alike.

    PYTHONPATH=src python -m repro_torch.launch.profile_turns \
        --parent _copies/parent/src --out profiles.jsonl

Each run is ``launch/profile.py`` of THIS tree in a fresh process, with
``PYTHONPATH`` set to the version's package (``--parent``, or this tree's
``src``), so both versions are measured by the same script. Writes a
"== <arch> <version>" line before each run's JSON line, and each run's
standard error to ``<out stem>_err_<arch>_<turn>_<version>.log``. Prints the
number of runs that printed a result and exits 1 if any run failed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
SRC = HERE.parents[2]                              # this tree's src/
ARCHS = ("qwen3-8b", "rwkv6-1.6b", "recurrentgemma-2b")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the parent version's src/ directory")
    ap.add_argument("--out", required=True, help="JSON lines file")
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds per run")
    args = ap.parse_args()
    paths = {"parent": str(Path(args.parent).resolve()), "change": str(SRC)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ok = failed = 0
    with out.open("w") as f:
        for arch in args.archs:
            for n, who in enumerate(("parent", "change", "change",
                                     "parent")):
                f.write(f"== {arch} {who}\n")
                f.flush()
                err = out.with_name(f"{out.stem}_err_{arch}_{n}_{who}.log")
                env = dict(os.environ, PYTHONPATH=paths[who])
                with err.open("w") as ef:
                    try:
                        # -P: the script's directory, which holds this
                        # profile.py, must not shadow the standard
                        # library's profile module (torch imports cProfile)
                        run = subprocess.run(
                            [sys.executable, "-P",
                             str(HERE.with_name("profile.py")), "--arch",
                             arch], env=env, stdout=subprocess.PIPE,
                            stderr=ef, text=True, timeout=args.timeout)
                        rc = run.returncode
                        f.write(run.stdout)
                    except subprocess.TimeoutExpired:
                        rc = "timeout"
                if rc == 0:
                    ok += 1
                else:
                    failed += 1
                    f.write(f"FAILED {arch} {who} rc={rc}\n")
                f.flush()
    print(f"profile_turns: {ok} runs printed a result, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
