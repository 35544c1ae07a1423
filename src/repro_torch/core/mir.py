"""Middle-end IR (MIR) for the Graphitron compiler.

The middle-end traverses the FIR from a global perspective (paper §III-B2)
and produces:

* a symbol table: graphs, properties (``vector{V}(T)``), host scalars;
* one :class:`Kernel` per device function with the *Property Detector*
  results: which properties are read/written, through which index pattern,
  with which reduction, plus RAW-decoupling and frontier annotations;
* a :class:`HostProgram` for ``main()`` and any host helper functions;
* a :class:`MemoryPlan` assigning every property to a device buffer with a
  dtype and length class (|V| or |E|) — the FPGA memory-channel planning
  re-targeted at HBM buffers.
"""
from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import fir


class KernelKind(enum.Enum):
    VERTEX = "vertex"  # func f(v: Vertex)
    EDGE = "edge"  # func f(src: Vertex, dst: Vertex[, w: int|float])
    HOST = "host"  # zero-parameter functions (incl. main)
    PIPELINE = "pipeline"  # fused multi-stage launch (created by passes.py)


class Direction(enum.Enum):
    """Compile-time traversal-direction decision for an edge kernel.

    The paper's direction optimization (Fig. 2) is a runtime heuristic in
    the engine; the ``direction`` pass replaces it with a per-kernel
    compile-time verdict derived from frontier information:

    * ``DENSE``  — the frontier condition is loop-invariant (e.g. the
      ``deg[src] > 0`` guard of PageRank) or absent: always stream the full
      edge list, never evaluate a host-side frontier mask.
    * ``SPARSE`` — the frontier props are mutated between launches (a real
      shrinking/growing frontier, e.g. BFS levels): always attempt frontier
      compaction, with the edge-count threshold kept as the switch-back.
    * ``AUTO``   — no pass ran; the engine keeps its runtime-only fallback.
    """

    AUTO = "auto"
    DENSE = "dense"
    SPARSE = "sparse"


class IndexPattern(enum.Enum):
    """How a property access is indexed inside a kernel (Property Detector)."""

    SELF = "self"  # P[v] in a vertex kernel — sequential (burst) access
    SRC = "src"  # P[src] in an edge kernel — gather along source
    DST = "dst"  # P[dst] in an edge kernel — scatter along destination
    NEIGHBOR = "ngh"  # P[ngh] inside a neighbor loop — gather/scatter via CSR
    CONST = "const"  # P[0] — a global accumulator cell
    OTHER = "other"  # anything else (computed index)


@dataclass(frozen=True)
class PropAccess:
    prop: str
    pattern: IndexPattern
    reduce_op: Optional[str] = None  # None for plain assign / read


@dataclass
class PropertyInfo:
    name: str
    element: str  # 'Vertex' | 'Edge' element name
    scalar: str  # 'int' | 'float' | 'bool'
    is_edge: bool = False


@dataclass
class ScalarInfo:
    name: str
    scalar: str
    init: Optional[fir.Expr] = None


@dataclass
class GraphInfo:
    edgeset_name: str
    vertexset_name: Optional[str]
    weighted: bool
    weight_scalar: Optional[str]  # 'int' | 'float'
    load_args: List[fir.Expr] = field(default_factory=list)


@dataclass
class FrontierInfo:
    """A top-level guard ``if cond`` whose cond only reads props at the
    kernel's primary index — the paper's *Frontier Check* module."""

    cond: fir.Expr
    props: Set[str] = field(default_factory=set)


@dataclass
class Kernel:
    name: str
    kind: KernelKind
    func: fir.FuncDecl
    # parameter roles
    vertex_param: Optional[str] = None  # vertex kernels
    src_param: Optional[str] = None  # edge kernels
    dst_param: Optional[str] = None
    weight_param: Optional[str] = None
    # Property Detector results
    reads: List[PropAccess] = field(default_factory=list)
    writes: List[PropAccess] = field(default_factory=list)
    scalar_reads: Set[str] = field(default_factory=set)
    # transforms / annotations
    snapshot_props: Set[str] = field(default_factory=set)  # RAW decoupling (Fig. 5->6)
    frontier: Optional[FrontierInfo] = None
    has_neighbor_loop: bool = False
    writes_weight: bool = False
    accumulators: Set[str] = field(default_factory=set)  # props written at const index
    # compile-time push/pull decision (assigned by the `direction` pass)
    direction: Direction = Direction.AUTO

    @property
    def scatter_props(self) -> Set[str]:
        """Properties written through a scattered index (shuffle path)."""
        return {
            w.prop
            for w in self.writes
            if w.pattern in (IndexPattern.DST, IndexPattern.NEIGHBOR, IndexPattern.OTHER)
        }

    @property
    def sequential_props(self) -> Set[str]:
        """Properties written at the kernel's own lane (burst-write path)."""
        return {
            w.prop
            for w in self.writes
            if w.pattern in (IndexPattern.SELF, IndexPattern.SRC)
        }


@dataclass
class PipelineKernel:
    """A fused multi-stage launch: the paper's Fig. 4 single pipeline.

    Created by the ``fuse`` pass when an edge kernel and the vertex apply
    over its scatter target (or adjacent vertex kernels that cannot be
    body-merged) are launched back to back with no intervening host
    dependency. The back-end lowers all stages into ONE jitted executable;
    each stage's scattered writes commit before the next stage runs, so
    the result is bit-identical to the unfused launch sequence.

    Stage kernels keep their own entries in ``Module.kernels`` (the host
    program may still launch them individually elsewhere).
    """

    name: str
    stages: List[Kernel] = field(default_factory=list)
    kind: KernelKind = KernelKind.PIPELINE

    # -- aggregate views so engines can treat this like a Kernel ----------
    @property
    def scalar_reads(self) -> Set[str]:
        out: Set[str] = set()
        for s in self.stages:
            out |= s.scalar_reads
        return out

    @property
    def accumulators(self) -> Set[str]:
        out: Set[str] = set()
        for s in self.stages:
            out |= s.accumulators
        return out

    @property
    def writes_weight(self) -> bool:
        return any(s.writes_weight for s in self.stages)

    @property
    def has_neighbor_loop(self) -> bool:
        return any(s.has_neighbor_loop for s in self.stages)

    @property
    def frontier(self) -> Optional[FrontierInfo]:
        return None  # pipelines always run the full stream

    @property
    def edge_stages(self) -> List[Kernel]:
        return [s for s in self.stages if s.kind is KernelKind.EDGE]


@dataclass
class MemoryPlan:
    """Device buffer plan: property -> (length class, dtype, channel id).

    The FPGA version assigns HBM pseudo-channels; here the channel id is
    informational (used by the textual codegen dump and by tests asserting
    the Property Detector found everything).
    """

    buffers: Dict[str, Tuple[str, str, int]] = field(default_factory=dict)

    def add(self, prop: PropertyInfo):
        length = "E" if prop.is_edge else "V"
        self.buffers[prop.name] = (length, prop.scalar, len(self.buffers))


@dataclass
class HostProgram:
    main: fir.FuncDecl
    host_funcs: Dict[str, fir.FuncDecl] = field(default_factory=dict)


@dataclass
class Module:
    """The complete MIR context handed to the back-end."""

    program: fir.Program
    graph: GraphInfo
    properties: Dict[str, PropertyInfo] = field(default_factory=dict)
    scalars: Dict[str, ScalarInfo] = field(default_factory=dict)
    kernels: Dict[str, Kernel] = field(default_factory=dict)
    host: Optional[HostProgram] = None
    memory: MemoryPlan = field(default_factory=MemoryPlan)
    # degree vectors requested via edges.getOutDegrees()/getInDegrees()
    degree_props: Dict[str, str] = field(default_factory=dict)  # prop -> 'out'|'in'
    # optimization-pass bookkeeping (populated by passes.run_pipeline):
    # fused launch name -> the original kernel names it replaces, in order
    fusion_groups: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # human-readable log of what each pass did (golden-tested via describe)
    pass_report: List[str] = field(default_factory=list)

    def describe(self) -> str:
        """Textual MIR dump — the analogue of the generated-OpenCL listing.

        When optimization passes ran (``CompileOptions.passes``), the dump
        ends with one ``pass <name>: ...`` line per transformation applied,
        so golden tests can pin exactly which kernels fused, which buffers
        were eliminated, and which direction each edge kernel was assigned.
        """
        lines = [f"graph {self.graph.edgeset_name} (weighted={self.graph.weighted})"]
        for p in self.properties.values():
            ln, dt, ch = self.memory.buffers[p.name]
            lines.append(f"  buffer {p.name}: {dt}[{ln}] @channel{ch}")
        for s in self.scalars.values():
            lines.append(f"  host scalar {s.name}: {s.scalar}")
        for k in self.kernels.values():
            if isinstance(k, PipelineKernel):
                stages = " -> ".join(s.name for s in k.stages)
                lines.append(f"  kernel {k.name} [pipeline: {stages}]")
                continue
            lines.append(f"  kernel {k.name} [{k.kind.value}]")
            for r in k.reads:
                lines.append(f"    read  {r.prop}[{r.pattern.value}]")
            for w in k.writes:
                op = f" {w.reduce_op}=" if w.reduce_op else " ="
                lines.append(f"    write {w.prop}[{w.pattern.value}]{op}")
            if k.snapshot_props:
                lines.append(f"    decouple(RAW): snapshot {sorted(k.snapshot_props)}")
            if k.frontier is not None:
                lines.append(f"    frontier-check on {sorted(k.frontier.props)}")
            if k.accumulators:
                lines.append(f"    accumulators {sorted(k.accumulators)}")
            if k.kind is KernelKind.EDGE and k.direction is not Direction.AUTO:
                lines.append(f"    direction {k.direction.value}")
        for entry in self.pass_report:
            lines.append(f"  pass {entry}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# incremental-recomputation metadata (streaming path)
# ---------------------------------------------------------------------------
# Derived lazily by repro.core.passes.analyze_incremental and consumed by
# repro.streaming — deliberately NOT part of Module.describe(), so the
# canonical serialization (and with it program fingerprints, cache
# identities and saved artifacts) is unchanged by this analysis.


@dataclass(frozen=True)
class IncrementalTemplate:
    """A recognized monotone-convergence shape with a repair recipe.

    ``kind`` selects the host-side repair driver in
    :mod:`repro.streaming.incremental`:

    * ``unit_distance`` — level/hop propagation guarded on a host round
      scalar (BFS family): ``dist + 1`` relaxations.
    * ``weighted_distance`` — active-mask guarded ``dist + weight``
      relaxations (SSSP family).
    * ``label`` — symmetric min-label propagation (connected components).
    """

    kind: str  # 'unit_distance' | 'weighted_distance' | 'label'
    dist_prop: str  # the converged result property (levels/distances/labels)
    tuple_prop: Optional[str] = None  # tentative-min buffer (distance kinds)
    mirror_props: Tuple[str, ...] = ()  # equal to dist_prop at the fixpoint
    unreached: Optional[int] = None  # sentinel literal for unreached vertices
    round_scalar: Optional[str] = None  # host scalar = max(level) + 1 at exit


@dataclass(frozen=True)
class IncrementalInfo:
    """Monotonicity verdict for a module (streaming re-convergence).

    ``monotone`` is true when every scattered vertex write (DST / NEIGHBOR
    / OTHER index pattern) carries a ``min=`` / ``max=`` reduction —
    additional edges can then only tighten the fixpoint, so re-convergence
    may be seeded from the delta endpoints alone. ``template`` is the
    matched repair recipe, or None when the program is monotone but not of
    a recognized shape (repair falls back to full recompute either way).
    """

    monotone: bool
    reduce_ops: Tuple[str, ...] = ()
    reasons: Tuple[str, ...] = ()
    template: Optional[IncrementalTemplate] = None

    @property
    def incremental_ok(self) -> bool:
        return self.monotone and self.template is not None


# ---------------------------------------------------------------------------
# canonical serialization / fingerprinting
# ---------------------------------------------------------------------------


def canonical_serialize(module: Module) -> str:
    """Canonical text form of an analyzed module, front-end independent.

    Two programs that reach the middle-end as the same MIR — whether they
    were parsed from ``.gt`` text or built by the embedded Python front-end
    (:mod:`repro.frontend`) — serialize to the same string: the symbol
    table / Property Detector dump (:meth:`Module.describe`) followed by
    the normalized FIR program (``fir.dump`` is formatting-, comment- and
    parenthesization-independent, and semantic analysis has already applied
    the RMW normalization, so surface spelling differences vanish).

    This is the string the Program cache is keyed on: see
    :func:`fingerprint` and :func:`repro.core.program.compile_program`.
    """
    return module.describe() + "\n%% fir\n" + fir.dump(module.program)


def fingerprint(module: Module) -> str:
    """Content hash of the canonical serialized MIR (the cache identity)."""
    return hashlib.sha256(canonical_serialize(module).encode("utf-8")).hexdigest()
