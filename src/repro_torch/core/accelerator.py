"""Accelerator artifacts: lowered, serializable compile products.

Graphitron's output is not an in-process interpreter but a *generated
accelerator*: the back end lowers the algorithm against a hardware
description once, and the artifact is deployed and rebound to new graphs
(paper §IV; the ThunderGP-style template flow ships precompiled
bitstreams rebound per graph). The port's pipeline, as the reference's:

    program     = repro_torch.compile(src, options)    # front end + passes
    accelerator = program.lower(target, shape)          # back end, once a bucket
    session     = accelerator.bind(graph)               # shape check + upload

* :class:`GraphShape` is the **shape bucket** an accelerator is lowered
  against: ``(n_vertices, n_edges, weighted)``. Every state buffer and
  graph-binding array has a shape fixed by the bucket, so one lowering
  serves every graph in it (:meth:`GraphShape.bucketed` and
  ``GraphData.pad_to`` coarsen buckets).
* :class:`KernelLibrary` holds the shape-generic lowered kernels (graph
  bindings are arguments, :func:`~.backend.lower_kernel_generic`). On a
  CUDA device lowering builds, or finds built, and loads the CUDA
  libraries the graph path launches (``shuffle_reduce`` and
  ``edge_stream``); a build or load failure raises, and nothing falls back
  to the plain kernel versions. The library is shared by every session
  bound from one Accelerator, so rebinds never build again.
* :class:`Accelerator` is the deployable artifact: ``report()`` is the
  analogue of an HLS resource report (per-kernel launch plan, a static op
  estimate, state and graph-plan bytes), ``save(path)`` /
  :func:`load_accelerator` persist it: the source, the canonical MIR, the
  target, the shape and the CUDA libraries' build names. PyTorch has no
  executables to serialize, so loading always lowers again; a kernel is
  ``"aot-loaded"`` when its libraries were found built at the manifest's
  source hash (no ``nvcc`` ran), else ``"aot"``.

Distributed targets lower lazily at bind (each bind partitions its graph
over the target's shard devices, :mod:`.dist_engine`), but carry the same
artifact metadata, report and persistence, as the reference's do.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, TYPE_CHECKING

import torch

from . import backend, mir
from .backend import DTYPES
from .engine import race_safe_target
from .options import CompileOptions
from .session import resolve_device
from .target import Target
from .. import telemetry as tel
from ..kernels import _build

if TYPE_CHECKING:  # pragma: no cover - import cycle guards
    from ..graph.storage import GraphData
    from .program import Program
    from .session import BatchSession, Session, SessionPool

# the port's own artifact format: a manifest without executables, which
# `load_accelerator` re-lowers; the reference's manifests are refused
ARTIFACT_FORMAT = "repro_torch-1"
SUBSTRATE = "torch"
MANIFEST_NAME = "manifest.json"
# the CUDA libraries (csrc/<name>.cu) the graph path launches
GRAPH_LIBRARIES: Tuple[str, ...] = ("shuffle_reduce", "edge_stream")


class AcceleratorError(Exception):
    """Raised for shape/target mismatches and stale/corrupt artifacts."""


def accelerator_fingerprint(program_fingerprint: str, target: Target,
                            shape: "GraphShape") -> str:
    """Content identity of a lowered accelerator (program x target x shape).

    Computable without lowering: artifact stores key their directories on
    it, so a stale or foreign artifact lives at a different path.
    """
    h = hashlib.sha256()
    h.update(program_fingerprint.encode("ascii"))
    h.update(repr(target).encode("utf-8"))
    h.update(repr(shape).encode("utf-8"))
    return h.hexdigest()


@dataclass(frozen=True)
class GraphShape:
    """The shape bucket an Accelerator is lowered against.

    Two graphs with the same ``(n_vertices, n_edges, weighted)`` triple
    give identically shaped state buffers and graph-binding arrays, so they
    share one lowering. Pad graphs up to a common bucket with
    ``GraphData.pad_to`` when their raw shapes differ.
    """

    n_vertices: int
    n_edges: int
    weighted: bool = False

    def __post_init__(self):
        if self.n_vertices < 1 or self.n_edges < 1:
            raise ValueError("GraphShape needs n_vertices >= 1 and n_edges >= 1")

    @staticmethod
    def of(graph: "GraphData") -> "GraphShape":
        return GraphShape(int(graph.n_vertices), int(graph.n_edges), bool(graph.weighted))

    def bucketed(self, v_round: int = 1024, e_round: int = 4096) -> "GraphShape":
        """Round the shape up to multiples: a coarser bucket, so more
        graphs alias one lowering (pad graphs with ``GraphData.pad_to``).
        Padding changes |V|/|E|, which ``size()`` hides: it reads the
        graph's logical counts."""

        def up(n, m):
            return ((n + m - 1) // m) * m

        return GraphShape(up(self.n_vertices, v_round), up(self.n_edges, e_round),
                          self.weighted)

    @classmethod
    def bucket_for(cls, n_vertices: int, n_edges: int, weighted: bool = False,
                   *, headroom: float = 0.125, ratio: float = 1.25,
                   v_base: int = 1024, e_base: int = 4096) -> "GraphShape":
        """Geometric shape bucket for a (possibly growing) logical graph.

        Buckets grow by ``ratio`` steps above a base, after adding
        ``headroom`` slack, so the number of distinct buckets (lowerings)
        over any growth trajectory is logarithmic, and a fresh bucket has
        free padding slots for updates. Integer iteration, no float-log
        boundary jitter.
        """
        if n_vertices < 1 or n_edges < 1:
            raise ValueError("bucket_for needs n_vertices >= 1 and n_edges >= 1")

        def up(n: int, base: int) -> int:
            n = n + (n * int(headroom * 1024)) // 1024  # integer headroom
            b = base
            while b < n:
                b = max(b + 1, int(b * ratio))
            return b

        bv, be = up(n_vertices, v_base), up(n_edges, e_base)
        if be > n_edges and bv <= n_vertices:
            bv = max(bv + 1, int(bv * ratio))  # padded edges need a pad vertex
        return cls(bv, be, weighted)

    def accepts(self, graph: "GraphData") -> bool:
        return GraphShape.of(graph) == self

    def check_bucket(self, graph: "GraphData") -> None:
        """Raise unless ``graph`` can bind an accelerator of this bucket.

        Exact |V|/|E| match; a weighted graph may bind an unweighted bucket
        (the program never reads weights), but a weighted bucket promises
        weights the graph must have.
        """
        got = GraphShape.of(graph)
        ok = (got.n_vertices == self.n_vertices
              and got.n_edges == self.n_edges
              and (got.weighted or not self.weighted))
        if not ok:
            raise AcceleratorError(
                f"graph shape ({got.describe()}) does not match the "
                f"accelerator's bucket ({self.describe()}); pad the graph "
                f"with GraphData.pad_to(...) or lower a new bucket"
            )

    def to_dict(self) -> dict:
        return {"n_vertices": self.n_vertices, "n_edges": self.n_edges,
                "weighted": self.weighted}

    def describe(self) -> str:
        return (f"|V|={self.n_vertices} |E|={self.n_edges} "
                f"{'weighted' if self.weighted else 'unweighted'}")


# ---------------------------------------------------------------------------
# kernel library: shape-generic lowered kernels shared across binds
# ---------------------------------------------------------------------------

class KernelLibrary:
    """Shape-generic lowered kernels of one (module, target, bucket, device).

    One library backs every session bound from one Accelerator: the kernels
    take the graph's bindings as arguments, and :attr:`warm_keys` is the
    first-touch registry the engines consult for the compile/run time split.
    :meth:`compile_all` marks each kernel's full stream warm, as the
    reference's AOT compile does; a frontier pad or batch size is timed as
    compile time on its first touch by any engine of the library. A plain
    bind's engine owns a library of its own. ``builds`` holds what
    :func:`~repro_torch.kernels._build.build` reported for each CUDA
    library (empty on the CPU, where the plain kernel versions run).
    """

    def __init__(self, module: mir.Module, target: Target, shape: GraphShape,
                 device: str):
        self.module = module
        self.target, _ = race_safe_target(module, target)  # as every Engine does
        self.shape = shape
        self.device = device
        self.warm_keys: set = set()
        self.builds: Dict[str, dict] = {}
        self._generic: Dict[str, backend.GenericLoweredKernel] = {}
        self._lower_s: Dict[str, float] = {}
        for name, kern in module.kernels.items():
            t0 = time.perf_counter()
            self._generic[name] = backend.lower_kernel_generic(
                module, kern, shape.n_vertices, shape.n_edges, self.target)
            self._lower_s[name] = time.perf_counter() - t0

    def compile_all(self, libraries: Optional[Dict[str, str]] = None
                    ) -> Tuple["KernelPlan", ...]:
        """Build and load the CUDA libraries (on a CUDA device) and mark
        every kernel warm.

        ``libraries`` maps library name -> build file name, from a saved
        artifact's manifest: the kernels are ``"aot-loaded"`` when every
        library was found built under exactly that name (no ``nvcc`` ran),
        ``"aot"`` otherwise (a fresh lowering, a CPU device, or sources
        that changed since the artifact was saved).
        """
        loaded = False
        if self.device != "cpu":
            self.builds = _build.build(GRAPH_LIBRARIES)
            for name in GRAPH_LIBRARIES:
                _build.load(name)
            loaded = libraries is not None and all(
                libraries.get(n) == _build.lib_path(n).name and self.builds[n]["cached"]
                for n in GRAPH_LIBRARIES)
        mode = "aot-loaded" if loaded else "aot"
        plans = []
        for name in self._generic:
            self.warm_keys.add(("full", name))
            plans.append(_kernel_plan(self.module, self.module.kernels[name], mode,
                                      self._lower_s[name], self.shape))
        return tuple(plans)

    def kernel_for(self, name: str, gb: Dict[str, Any]) -> backend.LoweredKernel:
        """Adapt the shape-generic kernel to one graph's binding arrays."""
        g = self._generic.get(name)
        if g is None:
            raise AcceleratorError(f"{name!r} is not a device kernel")
        return g.bind(gb)


# ---------------------------------------------------------------------------
# resource report (the HLS report analogue)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelPlan:
    """Per-kernel launch plan + cost estimate of one lowered accelerator.

    PyTorch has no cost analysis of a compiled executable: ``flops`` is the
    reference's static estimate (one op per streamed lane per property
    access), and the byte estimates stay ``None`` (unknown).
    """

    name: str
    kind: str  # 'vertex' | 'edge' | 'pipeline'
    stages: Tuple[str, ...]  # fused stage names (pipelines), else ()
    direction: str  # compile-time push/pull verdict ('auto' pre-pass)
    mode: str  # 'aot' | 'aot-loaded' | 'lazy' (a distributed target's)
    flops: Optional[float] = None  # per full-stream launch
    bytes_accessed: Optional[float] = None
    arg_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    compile_time_s: float = 0.0


def _kernel_plan(module, kern, mode, compile_time_s, shape) -> KernelPlan:
    # the reference's static estimate: one op per streamed lane per
    # property access of a full-stream launch
    lanes = shape.n_edges if kern.kind is mir.KernelKind.EDGE else shape.n_vertices
    if isinstance(kern, mir.PipelineKernel):
        lanes = sum(shape.n_edges if s.kind is mir.KernelKind.EDGE else shape.n_vertices
                    for s in kern.stages)
        accesses = sum(len(s.reads) + len(s.writes) for s in kern.stages)
    else:
        accesses = len(kern.reads) + len(kern.writes)
    stages = tuple(s.name for s in kern.stages) if isinstance(kern, mir.PipelineKernel) else ()
    direction = getattr(getattr(kern, "direction", None), "value", "auto")
    return KernelPlan(name=kern.name, kind=kern.kind.value, stages=stages,
                      direction=direction, mode=mode, flops=float(lanes * max(1, accesses)),
                      compile_time_s=compile_time_s)


@dataclass(frozen=True)
class AcceleratorReport:
    """Queryable resource report of one lowered accelerator."""

    target: Target
    shape: GraphShape
    kernels: Tuple[KernelPlan, ...]
    state_bytes: int  # device property buffers (+ weights)
    #: graph-binding arrays of the bucket (backend.GB_ARRAY_KEYS, the Burst
    #: Read plan); leaves out each bind's work list ``es_split``, whose
    #: length follows the graph's degrees, not the bucket
    gb_bytes: int
    live_buffer_peak_bytes: int  # resident state + plan (no temp estimates)
    lower_time_s: float
    pass_report: Tuple[str, ...] = ()
    #: determinism certificate (deterministic / reduction-deterministic /
    #: racy), also stored in artifact manifests
    determinism: str = "unknown"
    #: profiling baseline from traced runs: ``{"runs": N, "spans": {name:
    #: {count, total_s, max_s}}}``, persisted with the artifact manifest
    profile: Dict[str, Any] = field(default_factory=dict)
    device: str = "cpu"

    @property
    def total_flops_per_launch_set(self) -> float:
        return sum(k.flops or 0.0 for k in self.kernels)

    def describe(self) -> str:
        lines = [
            f"accelerator [{self.target.describe()}] {self.shape.describe()}",
            f"  buffers: state {_fmt_bytes(self.state_bytes)}, "
            f"graph plan {_fmt_bytes(self.gb_bytes)}, "
            f"live peak {_fmt_bytes(self.live_buffer_peak_bytes)} "
            f"(+ each bind's split list)",
            f"  lowered in {self.lower_time_s:.3f}s on {self.device} "
            f"({sum(1 for k in self.kernels if k.mode.startswith('aot'))}"
            f"/{len(self.kernels)} kernels AOT)",
            f"  determinism: {self.determinism}",
        ]
        if self.profile.get("runs"):
            hot = sorted(
                ((k, v) for k, v in self.profile.get("spans", {}).items()
                 if k.startswith("launch:")),
                key=lambda kv: -kv[1].get("total_s", 0.0),
            )[:5]
            hottest = ", ".join(f"{k.split(':', 1)[1]} {v['total_s']:.3f}s" for k, v in hot)
            lines.append(f"  profile: {self.profile['runs']} traced run(s)"
                         + (f"; hottest: {hottest}" if hottest else ""))
        for k in self.kernels:
            extra = f" = {' -> '.join(k.stages)}" if k.stages else ""
            cost = f"{k.flops:.3g} flops" if k.flops else "?"
            lines.append(
                f"  kernel {k.name} [{k.kind}{extra}] {k.mode} "
                f"dir={k.direction} ~{cost} "
                f"(compile {k.compile_time_s * 1e3:.0f}ms)"
            )
        for entry in self.pass_report:
            lines.append(f"  pass {entry}")
        return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"  # pragma: no cover


def _module_state_bytes(module: mir.Module, shape: GraphShape) -> int:
    total = 0
    for p in module.properties.values():
        n = shape.n_edges if p.is_edge else shape.n_vertices
        total += n * DTYPES[p.scalar].itemsize
    if module.graph.weighted:
        total += shape.n_edges * DTYPES[module.graph.weight_scalar or "float"].itemsize
    return total


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


class Accelerator:
    """A lowered Graphitron accelerator for one (target, shape bucket) on
    one device.

    Produced by ``program.lower(target, shape)``. Bind it to any graph of
    the bucket: ``bind`` checks the shape, uploads the graph and returns a
    :class:`~.session.Session` whose kernels are the library's, already
    warm. ``save``/:func:`load_accelerator` persist it across processes.
    ``device`` is as for ``Program.bind``: ``None`` means ``"cuda"``,
    which raises without a GPU unless the caller asks for ``"cpu"``.
    """

    def __init__(self, program: "Program", target: Target, shape: GraphShape, *,
                 device: Optional[str] = None,
                 _libraries: Optional[Dict[str, str]] = None,
                 _profile: Optional[Dict[str, Any]] = None,
                 _tuned: Optional[Dict[str, Any]] = None):
        module = program.module
        if module.graph.weighted and not shape.weighted:
            raise AcceleratorError(
                "program declares a weighted edgeset but the shape bucket is "
                "unweighted; lower with GraphShape(..., weighted=True)"
            )
        self.program = program
        self.target = target
        self.shape = shape
        self.device = resolve_device(device)
        self.fingerprint = accelerator_fingerprint(program.fingerprint, target, shape)
        # profiling baseline fed by traced runs: per span name -> {count,
        # total_s, max_s}; persisted in the manifest
        self._profile_lock = threading.Lock()
        self._profile: Dict[str, Dict[str, float]] = dict((_profile or {}).get("spans", {}))
        self.profile_runs = int((_profile or {}).get("runs", 0))
        # provenance of an autotuned Target (a TunedConfig dict from
        # repro_torch.autotune, stamped by the tuner or a tuned lowering);
        # persisted in the manifest, so a process that loads the artifact
        # knows it runs a tuned Target without searching again
        self.tuned: Optional[Dict[str, Any]] = dict(_tuned) if _tuned else None
        tr = tel.get()
        sp = tr.span(
            "lower", fingerprint=self.fingerprint[:16], target=target.kind,
            bucket=f"{shape.n_vertices}v/{shape.n_edges}e",
            from_artifact=_libraries is not None,
        ) if tr.enabled else tel.NULL_SPAN
        t0 = time.perf_counter()
        with sp:
            if target.kind == "distributed":
                # each bind partitions its graph over the target's shards and
                # lowers its supersteps then, as the reference's distributed
                # accelerator does: the kernels are "lazy", the report holds
                self.library: Optional[KernelLibrary] = None
                self._plans = tuple(_kernel_plan(module, k, "lazy", 0.0, shape)
                                    for k in module.kernels.values())
            else:
                self.library = KernelLibrary(module, target, shape, self.device)
                self._plans = self.library.compile_all(_libraries)
        self.lower_time_s = time.perf_counter() - t0
        self.binds = 0

    # -- introspection -------------------------------------------------------
    def report(self) -> AcceleratorReport:
        """The HLS-resource-report analogue for this lowering."""
        module = self.program.module
        state_bytes = _module_state_bytes(module, self.shape)
        gb_bytes = backend.gb_array_bytes(self.shape.n_vertices, self.shape.n_edges)
        return AcceleratorReport(
            target=self.target, shape=self.shape, kernels=self._plans,
            state_bytes=state_bytes, gb_bytes=gb_bytes,
            live_buffer_peak_bytes=state_bytes + gb_bytes, lower_time_s=self.lower_time_s,
            pass_report=tuple(module.pass_report), determinism=self._determinism(),
            profile=self.profile(), device=self.device,
        )

    def _determinism(self) -> str:
        from ..analysis import determinism_certificate

        return determinism_certificate(self.program.module)

    def libraries(self) -> Dict[str, str]:
        """Build file name of each CUDA library the graph path launches
        (``_build.lib_path``: the source hash), whatever the device."""
        return {name: _build.lib_path(name).name for name in GRAPH_LIBRARIES}

    # -- profiling baseline (telemetry) --------------------------------------
    def record_profile(self, trace: Optional[Dict[str, Any]]) -> None:
        """Fold one traced run's summary (``EngineResult.trace``) into the
        profile. Sessions call this after every traced run."""
        if not trace:
            return
        spans = trace.get("spans") or {}
        with self._profile_lock:
            self.profile_runs += 1
            for name, a in spans.items():
                cur = self._profile.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                cur["count"] += a.get("count", 0)
                cur["total_s"] = round(cur["total_s"] + a.get("total_s", 0.0), 6)
                cur["max_s"] = max(cur["max_s"], a.get("max_s", 0.0))

    def profile(self) -> Dict[str, Any]:
        """The accumulated profiling baseline: ``{"runs": N, "spans":
        {name: {count, total_s, max_s}}}`` (empty until a traced run)."""
        with self._profile_lock:
            return {"runs": self.profile_runs,
                    "spans": {k: dict(v) for k, v in self._profile.items()}}

    def __repr__(self) -> str:
        return (f"Accelerator({self.fingerprint[:12]}, {self.target.describe()}, "
                f"{self.shape.describe()}, on {self.device}, kernels={len(self._plans)})")

    # -- binding -------------------------------------------------------------
    def bind(self, graph: "GraphData", *, argv: Optional[list] = None) -> "Session":
        """Place this accelerator onto a graph of the bucket.

        Checks the shape and uploads the graph's bindings; the returned
        Session launches the library's kernels, so N graphs of one bucket,
        and every process that loads the artifact, share one lowering.
        """
        from .session import Session

        self.shape.check_bucket(graph)
        self.binds += 1
        tr = tel.get()
        sp = tr.span(
            "bind", fingerprint=self.fingerprint[:16],
            n_vertices=graph.n_vertices, n_edges=graph.n_edges,
        ) if tr.enabled else tel.NULL_SPAN
        with sp:
            session = Session(self.program, graph, target=self.target, device=self.device,
                              argv=argv, library=self.library)
        session.accelerator = self
        return session

    def pool(self, graph: "GraphData", size: int = 2, *, argv: Optional[list] = None,
             batch: int = 0, batch_wait_s: float = 0.002) -> "SessionPool":
        """A SessionPool over one bucket graph; every worker shares the
        library (no per-worker build)."""
        from .session import SessionPool

        self.shape.check_bucket(graph)
        self.binds += 1
        return SessionPool(self.program, graph, size, target=self.target, device=self.device,
                           argv=argv, batch=batch, batch_wait_s=batch_wait_s,
                           library=self.library)

    def bind_batch(self, graph: "GraphData", *, argv: Optional[list] = None,
                   max_batch: Optional[int] = None, msbfs: bool = True) -> "BatchSession":
        """Batched multi-query twin of :meth:`bind` (see Program.bind_batch)."""
        from .session import BatchSession

        self.shape.check_bucket(graph)
        self.binds += 1
        session = BatchSession(self.program, graph, target=self.target, device=self.device,
                               argv=argv, max_batch=max_batch, msbfs=msbfs,
                               library=self.library)
        session.accelerator = self
        return session

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        """Persist this accelerator to a directory artifact: the manifest
        (format, substrate, fingerprints, target, shape, options, pass
        report, determinism, the CUDA libraries' build names, profile, tuned
        config), the
        ``.gt`` source and the canonical serialized MIR."""
        os.makedirs(path, exist_ok=True)
        opts = self.program.options
        manifest = {
            "format": ARTIFACT_FORMAT,
            "substrate": SUBSTRATE,
            "torch_version": torch.__version__,
            "device": torch.device(self.device).type,
            "libraries": self.libraries(),
            "fingerprint": self.fingerprint,
            "program_fingerprint": self.program.fingerprint,
            "mir_fingerprint": mir.fingerprint(self.program.module),
            "target": self.target.to_dict(),
            "shape": self.shape.to_dict(),
            "options": {
                "passes": opts.passes,
                "scalar_bindings": [list(b) for b in opts.scalar_bindings],
            },
            "pass_report": list(self.program.module.pass_report),
            "determinism": self._determinism(),
            "kernels": {p.name: {"mode": p.mode} for p in self._plans},
            "profile": self.profile(),
            "tuned": self.tuned,
        }
        with open(os.path.join(path, "program.gt"), "w") as f:
            f.write(self.program.source)
        with open(os.path.join(path, "mir.txt"), "w") as f:
            f.write(mir.canonical_serialize(self.program.module))
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


def quarantine_artifact(path: str) -> Optional[str]:
    """Move a failed artifact directory aside so it is never probed again.

    A rename keeps the bytes for a postmortem under
    ``<path>.quarantined[.N]``. Returns the new path, or None when the
    store does not permit the rename.
    """
    for i in range(1000):
        dst = f"{path}.quarantined" + ("" if i == 0 else f".{i}")
        if os.path.exists(dst):
            continue
        try:
            os.rename(path, dst)
            return dst
        except OSError:
            return None
    return None  # pragma: no cover - 1000 quarantines of one key


def load_or_lower(program: "Program", target: Target, shape: GraphShape,
                  artifact_dir: str, *, device: Optional[str] = None
                  ) -> Tuple[Accelerator, bool, float]:
    """Resolve an accelerator from an artifact store, lowering on a miss.

    Artifact directories are keyed by :func:`accelerator_fingerprint`, so a
    stale or foreign artifact is not found, and a corrupt one fails its
    load and is lowered again. On a miss the fresh lowering is saved back;
    an unwritable store still returns it. Returns ``(accelerator, loaded,
    seconds)``, the seconds of the load or the lowering.
    """
    key = accelerator_fingerprint(program.fingerprint, target, shape)
    path = os.path.join(artifact_dir, key[:24])
    if os.path.isdir(path):
        # a tampered manifest or truncated source raises anything from
        # AcceleratorError to ProgramError/ValueError: every load failure
        # means lowering again
        with contextlib.suppress(Exception):
            t0 = time.perf_counter()
            acc = load_accelerator(path, device=device)
            return acc, True, time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = Accelerator(program, target, shape, device=device)
    dt = time.perf_counter() - t0
    with contextlib.suppress(OSError):  # store not writable: the lowering stands
        acc.save(path)
    return acc, False, dt


def load_accelerator(path: str, *, device: Optional[str] = None) -> Accelerator:
    """Load a saved accelerator artifact (see :meth:`Accelerator.save`).

    The source is compiled again (through the Program cache) and checked
    against the stored program fingerprint: a drifted toolchain or an
    edited artifact fails loudly. Then the program is lowered again on
    ``device`` (``None`` means ``"cuda"``); its kernels are
    ``"aot-loaded"`` when the CUDA libraries were found built at the
    manifest's source hash. A manifest that is not the port's (the
    reference package's included) raises :class:`AcceleratorError`.
    """
    from .program import compile_program

    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise AcceleratorError(f"cannot read accelerator manifest: {e}") from e
    if manifest.get("format") != ARTIFACT_FORMAT or manifest.get("substrate") != SUBSTRATE:
        raise AcceleratorError(
            f"unsupported artifact format {manifest.get('format')!r} of substrate "
            f"{manifest.get('substrate')!r} (this build reads format {ARTIFACT_FORMAT} "
            f"of substrate {SUBSTRATE!r})"
        )
    try:
        with open(os.path.join(path, "program.gt")) as f:
            source = f.read()
    except OSError as e:
        raise AcceleratorError(f"artifact is missing program.gt: {e}") from e
    o = manifest.get("options", {})
    options = CompileOptions(
        passes=o.get("passes", "default"),
        scalar_bindings=tuple(tuple(b) for b in o.get("scalar_bindings", [])),
    )
    program = compile_program(source, options)
    if program.fingerprint != manifest.get("program_fingerprint"):
        raise AcceleratorError(
            "stale accelerator artifact: recompiling its source yields a "
            "different program fingerprint (source/options/toolchain drift); "
            "lower again with program.lower(target, shape) and save"
        )
    profile = manifest.get("profile")
    libraries = manifest.get("libraries")
    tuned = manifest.get("tuned")
    return Accelerator(program, Target.from_dict(manifest["target"]),
                       GraphShape(**manifest["shape"]), device=device,
                       _libraries=libraries if isinstance(libraries, dict) else {},
                       _profile=profile if isinstance(profile, dict) else None,
                       _tuned=tuned if isinstance(tuned, dict) else None)
