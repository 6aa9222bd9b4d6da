"""YCSB's CoreWorkload as a key model: one key an operation, READ with
``readproportion``, else an UPDATE (a blind write); keys drawn by
``ScrambledZipfianGenerator`` (a Zipf(0.99) rank over 10**10 items, then
FNV-1a-64 hashed onto the records)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from accord_bench.generate import KEY_DOMAIN, READ, WRITE, ScrambledZipfian


class YcsbKeys:
    """YCSB core workload operations: one key each, READ with probability
    `readproportion`, else UPDATE."""

    def __init__(self, config: dict, rng: np.random.Generator, seed: int):
        self.rng = rng
        self.zipf = ScrambledZipfian(config["recordcount"],
                                     config["zipfian_constant"])
        self.read = config["readproportion"]

    def draw(self) -> Tuple[int, tuple, tuple]:
        kind = READ if self.rng.random() < self.read else WRITE
        key = (self.zipf.draw(self.rng),)
        return kind, key, key if kind == WRITE else ()


class KeyModel(YcsbKeys):
    """The harness's entry: YCSB's operations in the key domain."""

    def draw(self) -> Tuple[int, int, tuple, tuple]:
        kind, keys, writes = super().draw()
        return kind, KEY_DOMAIN, keys, writes
