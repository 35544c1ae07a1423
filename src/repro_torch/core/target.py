"""Target: a hashable description of the execution substrate.

Everything the lowering needs to know about *where* a program runs, and
nothing about *what* it computes. The device itself (``"cuda"`` or
``"cpu"``) is chosen at :meth:`~repro_torch.core.program.Program.bind`.

Backend placement:

* ``kind`` — ``"local"`` (one device, the paper's single-accelerator
  system) or ``"distributed"`` (shuffle supersteps across ``n_devices``
  shard devices, :class:`~repro_torch.core.dist_engine.DistEngine`).
* ``n_devices`` / ``axis`` — the shard count of a distributed target
  (``0`` = every visible device of the bind's type) and the name of its
  axis, as the reference's mesh shape.

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
from typing import List

_KINDS = ("local", "distributed")


@dataclass(frozen=True)
class Target:
    kind: str = "local"
    n_devices: int = 0
    axis: str = "data"
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
        if self.n_devices < 0:
            raise ValueError("n_devices must be >= 0 (0 = all visible devices)")
        if self.partition_vertices < 1:
            raise ValueError("partition_vertices must be >= 1")
        if self.n_partitions < 0:
            raise ValueError("n_partitions must be >= 0 (0 = auto)")

    def mesh(self, device: str = "cuda") -> List[str]:
        """The shard devices of a distributed target bound on ``device``:
        shard ``k`` of ``n_devices`` is ``cuda:{k % torch.cuda.device_count()}``
        on CUDA and ``"cpu"`` on the CPU (the counterpart of the reference's
        forced host device count). ``n_devices == 0`` takes every visible
        device of that type: ``torch.cuda.device_count()`` on CUDA, 1 on the
        CPU. Shards outnumbering the cards share them, so on one card all
        D shards live on ``cuda:0`` and the shuffle's copies stay on it."""
        if self.kind != "distributed":
            raise ValueError(f"Target kind {self.kind!r} has no device mesh")
        import torch

        if torch.device(device).type == "cpu":
            return ["cpu"] * (self.n_devices or 1)
        count = torch.cuda.device_count()
        if count < 1:
            raise ValueError("a distributed CUDA target needs a visible CUDA device")
        return [f"cuda:{k % count}" for k in range(self.n_devices or count)]

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
        return Target(**d)  # a manifest without n_devices/axis takes the defaults

    def describe(self) -> str:
        mesh = f" x{self.n_devices or 'all'}({self.axis})" if self.kind == "distributed" else ""
        opts = ",".join(
            name for name in ("burst", "cache", "shuffle", "compact_frontier")
            if getattr(self, name)
        ) or "none"
        return f"{self.kind}{mesh} [{opts}] parts={self.n_partitions or 'auto'}"
