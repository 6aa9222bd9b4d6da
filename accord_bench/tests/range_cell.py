"""A range configuration added as data alone, for the tests: a key model
file, a configuration, a mix and a cell, written into a copy of the
benchmark.  The key model draws YCSB-style one-key writes and range reads
of 1-16 consecutive records, both from YCSB's scrambled Zipf keys; its
writes keep creating keys inside live scans."""

import json
import shutil
from pathlib import Path

KEY_MODEL = "test_ranges"
CONFIG = "ycsb-ranges"
MIX = "lifecycle-w32-ranges"
CELL = "ycsb-ranges.win32"

KEY_MODEL_SOURCE = '''"""A test key model: one-key blind writes and range reads of 1-16
consecutive records, each starting at a scrambled Zipf key."""

from accord_bench.generate import (KEY_DOMAIN, RANGE_DOMAIN, READ, WRITE,
                                   ScrambledZipfian)


class KeyModel:
    def __init__(self, config, rng, seed):
        self.rng = rng
        self.records = config["recordcount"]
        self.zipf = ScrambledZipfian(self.records, config["zipfian_constant"])
        self.scan = config["scanproportion"]
        self.longest = config["maxscanlength"]

    def draw(self):
        start = self.zipf.draw(self.rng)
        if self.rng.random() < self.scan:
            end = min(self.records, start + 1 + int(
                self.rng.integers(self.longest)))
            return READ, RANGE_DOMAIN, ((start, end),), ()
        return WRITE, KEY_DOMAIN, (start,), (start,)
'''

CONFIG_DATA = {
    "name": CONFIG, "key_model": KEY_MODEL, "recordcount": 400,
    "zipfian_constant": 0.99, "scanproportion": 0.5, "maxscanlength": 16,
    "span": [0, 1048576], "source_replicas": 3, "replicas": 1}

MIX_DATA = {"shape": "lifecycle", "window": 32, "accept_every": 4,
            "commit_lag": 2, "warmup_txns": 96, "windows_per_s": 4.0}


def write_key_model(key_models: Path) -> None:
    key_models.mkdir(parents=True, exist_ok=True)
    (key_models / f"{KEY_MODEL}.py").write_text(KEY_MODEL_SOURCE)


def add_range_cell(root: Path, into: Path) -> str:
    """Copy the benchmark at `root` into `into` and add the range cell to
    the copy as files and entries only -> the cell's name."""
    bench_dir = into / "accord_bench"
    shutil.copytree(root / "accord_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    write_key_model(bench_dir / "key_models")
    (bench_dir / "configs" / f"{CONFIG}.json").write_text(
        json.dumps(CONFIG_DATA))
    (bench_dir / "traffic" / f"{MIX}.json").write_text(json.dumps(MIX_DATA))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": CONFIG, "source": "https://github.com/brianfrankcooper/YCSB",
        "file": f"accord_bench/configs/{CONFIG}.json", "reduced": [],
        "why": "a test: one-key writes and short scans"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": "a test: range reads beside the writes that create their keys"})
    (into / "BENCHMARK.json").write_text(json.dumps(bench))
    return CELL
