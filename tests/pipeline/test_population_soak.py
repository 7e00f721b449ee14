"""Population-scale soak (VERDICT r3 #10), perf-marked: the full 500x1Mb
run is tools/soak_population.py (numbers in STATUS.md at commit b1e1878); this committed test
runs a scaled-down version of the same path by default so the soak recipe
itself stays green, and the full scale under GT_SOAK_FULL=1."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("scale", ["small"])
def test_population_soak_recipe(scale, tmp_path):
    full = bool(os.environ.get("GT_SOAK_FULL"))
    args = ["--samples", "500", "--kb", "1000"] if full else \
           ["--samples", "16", "--kb", "120", "--coverage", "10"]
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "soak_population.py"), *args,
         "--processes", "4"],
        capture_output=True, text=True, timeout=7200 if full else 900, env=env, cwd=REPO,
    )
    assert p.returncode == 0, p.stderr[-1500:]
    line = [l for l in p.stdout.splitlines() if l.startswith("{")][-1]
    d = json.loads(line)
    assert d["n_records"] > 0 and d["md5"]
    assert d["peak_tree_rss_mb"] > 0
    # the orchestrator + workers stay far below the cohort's decompressed
    # footprint (streaming pools bound RSS)
    assert d["peak_tree_rss_mb"] < 12000
