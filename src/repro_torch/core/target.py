"""Target: a hashable description of the execution substrate.

Everything the lowering needs to know about *where* a program runs, and
nothing about *what* it computes. This package runs on one device, so the
only kind is ``"local"``; the device itself (``"cuda"`` or ``"cpu"``) is
chosen at :meth:`~repro_torch.core.program.Program.bind`.

The memory-access knobs are the paper's §III-C3 optimizations:

* ``burst`` — dst-partitioned, ascending-src streaming order.
* ``cache`` — hub-vertex relabeling (hot properties in a dense prefix).
* ``shuffle`` — dst-binned sorted segment reduction (conflict-free).
* ``compact_frontier`` — only traverse active edges when the frontier is
  small (direction optimization).
* ``n_partitions`` — dst-range partition count (0 = auto from
  ``partition_vertices``).
* ``partition_vertices`` — auto-partitioning targets one dst-range slice
  of about this many vertices per partition.

There is no kernel knob: on a CUDA device every reduction that a program
scatters commits through the hand-written kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

_KINDS = ("local",)


@dataclass(frozen=True)
class Target:
    kind: str = "local"
    burst: bool = True
    cache: bool = True
    shuffle: bool = True
    compact_frontier: bool = True
    n_partitions: int = 0
    partition_vertices: int = 4096

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown Target.kind {self.kind!r}; expected one of {_KINDS}"
            )
        if self.partition_vertices < 1:
            raise ValueError("partition_vertices must be >= 1")
        if self.n_partitions < 0:
            raise ValueError("n_partitions must be >= 0 (0 = auto)")

    def auto_partitions(self, n_vertices: int) -> int:
        """Resolve the dst-range partition count for a vertex count."""
        if self.n_partitions:
            return self.n_partitions
        return max(1, n_vertices // self.partition_vertices)

    @staticmethod
    def baseline() -> "Target":
        """Unoptimized reference substrate: random scatter, no
        partitioning/caching (the paper's handcrafted-HLS baseline)."""
        return Target(burst=False, cache=False, shuffle=False,
                      compact_frontier=False)

    @staticmethod
    def with_only(opt: str) -> "Target":
        """Fig. 9 ablation points: exactly one memory optimization enabled."""
        if opt not in ("burst", "cache", "shuffle"):
            raise ValueError(f"unknown ablation axis {opt!r}")
        return replace(Target.baseline(), **{opt: True})

    # -- serialization (artifact manifests) ---------------------------------
    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @staticmethod
    def from_dict(d: dict) -> "Target":
        known = {f.name for f in fields(Target)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown Target fields in artifact: {unknown}")
        return Target(**d)

    def describe(self) -> str:
        opts = ",".join(
            name for name in ("burst", "cache", "shuffle", "compact_frontier")
            if getattr(self, name)
        ) or "none"
        return f"{self.kind} [{opts}] parts={self.n_partitions or 'auto'}"
