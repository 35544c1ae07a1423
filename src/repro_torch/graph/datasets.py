"""Table II dataset registry.

The paper's benchmarks (Table II) are synthesized to their published
statistics because this environment has no network access:

    rmat-19-32 (R19)  |V|=524K |E|=16.8M  deg=32    synthetic (Kronecker)
    HiggsTwitter (HT) |V|=457K |E|=14.9M  deg=32.5  social (power law)
    wiki-topcats (TC) |V|=1.8M |E|=28.5M  deg=15.9  web (power law)
    Amazon2003 (AM)   |V|=403K |E|=3.4M   deg=8.4   social (power law)
    pokec (PK)        |V|=1.6M |E|=30.6M  deg=18.8  social (power law)

``scale`` shrinks |V| and |E| proportionally (CPU-friendly benchmarking);
``scale=1.0`` reproduces the full published sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .generators import power_law, rmat
from .storage import GraphData


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    short: str
    n_vertices: int
    n_edges: int
    kind: str  # 'rmat' | 'power_law'


TABLE_II = {
    "R19": DatasetSpec("rmat-19-32", "R19", 524_288, 16_800_000, "rmat"),
    "HT": DatasetSpec("HiggsTwitter", "HT", 457_000, 14_900_000, "power_law"),
    "TC": DatasetSpec("wiki-topcats", "TC", 1_800_000, 28_500_000, "power_law"),
    "AM": DatasetSpec("Amazon2003", "AM", 403_000, 3_400_000, "power_law"),
    "PK": DatasetSpec("pokec-relationships", "PK", 1_600_000, 30_600_000, "power_law"),
}


def make_dataset(short: str, scale: float = 1.0, weighted: bool = False, seed: int = 0) -> GraphData:
    spec = TABLE_II[short]
    n_v = max(64, int(spec.n_vertices * scale))
    n_e = max(256, int(spec.n_edges * scale))
    if spec.kind == "rmat":
        # choose RMAT scale/edge-factor approximating the target sizes
        s = max(6, (n_v - 1).bit_length())
        ef = max(1, round(n_e / (1 << s)))
        return rmat(s, ef, seed=seed, weighted=weighted)
    return power_law(n_v, n_e, seed=seed, weighted=weighted)


def available() -> Dict[str, DatasetSpec]:
    return dict(TABLE_II)
