"""A checkout with the TUM cell `fr1.desk` put back beside the benchmark's
own, built from the configuration and mix files the folder keeps for it,
so that the TUM path of the generator, the loaders and the check stays
tested while the cell waits (PERF.md, Open questions)."""
import json
import os
import shutil

import pytest

from portbench.harness.spec import BENCH, ROOT

FR1_CONFIG = {"name": "tum-fr1-desk",
              "source": "configs/tum/fr1_config.py",
              "file": "portbench/configs/tum-fr1-desk.json",
              "reduced": ["use_wandb"], "why": "TUM fr1/desk"}
FR1_CELL = {"name": "fr1.desk", "config": "tum-fr1-desk",
            "traffic": "handheld", "chips": 1, "why": "TUM fr1/desk"}


@pytest.fixture(scope="session")
def fr1_root(tmp_path_factory) -> str:
    root = tmp_path_factory.mktemp("fr1_checkout")
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(FR1_CONFIG)
    bench["workloads"].append(FR1_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "portbench" / "limits" / "room0.scan.json",
                root / "portbench" / "limits" / "fr1.desk.json")
    return str(root)


@pytest.fixture
def cell_root(request, fr1_root):
    """The checkout that holds the cell a test is parametrised with."""
    return fr1_root if request.node.callspec.params["cell"] == "fr1.desk" \
        else None
