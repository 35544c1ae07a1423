"""repro_torch.autotune: profile-guided design-space exploration over Targets.

Graphitron's back-end exposes algorithm-independent hardware knobs —
burst/caching memory access, conflict-free shuffling, frontier
compaction, partition sizing — whose best combination varies per
algorithm and graph shape. On FPGAs picking that combination is design-
space exploration; this module is its software twin over
:class:`~repro_torch.core.target.Target`:

    program = repro_torch.compile(src)
    report  = repro_torch.autotune.AutoTuner().tune(program, graph,
                                                    params={"root": 0})
    acc     = program.lower(report.config.target, graph=graph)

The search is **analysis-pruned enumeration followed by measured
trials**:

* *Pruning* consults the static-analysis layer before any measurement:
  GT101-racy programs can never disable ``shuffle`` (the engine forces
  it back on, so ``shuffle=False`` candidates are dead duplicates), and
  pipelines whose edge kernels all carry a ``DENSE`` direction verdict
  skip ``compact_frontier`` variants (compaction never fires without a
  sparse frontier). Every other field of the base target is kept.
* *Cost-model warm start* orders the surviving candidates by a static
  estimate derived from ``accelerator.report()`` per-kernel FLOPs/bytes.
  PyTorch has no cost analysis of a compiled executable, so the byte
  estimates are ``None`` and the ranking falls back to the lane-count
  ``flops`` estimate (a missing estimate never crashes a trial).
* *Measured trials* lower each candidate, bind it to the probe graph,
  and take the best-of-``reps`` objective: the sum of ``launch:<kernel>``
  span aggregates from :mod:`repro_torch.telemetry` (wall time as fallback
  when tracing yields no launch spans). These are host clocks and nothing
  synchronises per launch, so on a CUDA device a span can close before its
  kernel ends. A candidate whose first
  repetition already exceeds ``margin`` x the incumbent is *dominated*
  and dropped without finishing its repetitions.

The winning :class:`TunedConfig` is keyed on (MIR fingerprint x
geometric shape bucket) and persisted in a :class:`TuningCache` living
alongside the artifact store (``<artifact_dir>/tuning/<key>.json``), so

* ``program.lower(..., tuned=True)`` transparently swaps in the tuned
  Target on a cache hit — a pure lookup, zero re-search;
* the serving tier (:class:`~repro_torch.serving.GraphService`) resolves every
  submission's Target through the same cache and counts ``tuned_hits``
  per program in ``service.stats()``;
* ``Accelerator.save`` stamps the config into the artifact manifest, so
  a fresh process that loads the artifact knows it runs a tuned Target.

``python -m repro_torch.autotune`` is the offline CLI;
``python -m repro_torch.launch.serve --graph bfs --autotune`` tunes online
before serving. Trials run on the tuner's ``device`` (``None`` means
``"cuda"``, as for ``Program.bind``).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import weakref
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from ..core import mir
from ..core.accelerator import Accelerator, GraphShape
from ..core.target import Target
from .. import telemetry as tel

__all__ = [
    "AutoTuner",
    "TunedConfig",
    "TuneReport",
    "TuningCache",
    "autotune",
    "default_tuning_dir",
    "shape_bucket",
    "tuning_key",
]

#: Target knobs the tuner searches (boolean grid) — the paper's
#: algorithm-independent memory-access optimizations (§III-C3).
SEARCHED_KNOBS: Tuple[str, ...] = (
    "burst", "cache", "shuffle", "compact_frontier",
)

#: Objective identifier recorded in every TunedConfig: the per-run sum of
#: ``launch:<kernel>`` span totals from repro_torch.telemetry.
OBJECTIVE = "launch_total_s"


def default_tuning_dir() -> str:
    """The TuningCache's on-disk home: ``<artifact store>/tuning``.

    Nesting under the artifact store
    (:func:`~repro_torch.serving.registry.default_artifact_dir`) means one
    directory persists both artifacts and tuned configs across runs.
    """
    from ..serving.registry import default_artifact_dir

    return os.path.join(default_artifact_dir(), "tuning")


def tuning_dir_for(store_dir: Optional[str]) -> Optional[str]:
    """Tuning-cache directory colocated with an artifact store dir."""
    return os.path.join(store_dir, "tuning") if store_dir else None


_MIR_FP_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program_mir_fingerprint(program) -> str:
    """The MIR-only content hash tuned configs are keyed on.

    Options-independent on purpose: the knobs being tuned live on Target,
    not CompileOptions, so the text and embedded twins of one algorithm
    (and every options ablation of it) share tuned configs. Memoized per
    Program object — the serving tier consults it on every submission.
    """
    try:
        fp = _MIR_FP_CACHE.get(program)
    except TypeError:  # unhashable/unweakrefable stand-in (tests)
        return mir.fingerprint(program.module)
    if fp is None:
        fp = mir.fingerprint(program.module)
        _MIR_FP_CACHE[program] = fp
    return fp


def shape_bucket(graph=None, shape: Optional[GraphShape] = None) -> GraphShape:
    """The geometric shape bucket a tuned config is keyed on.

    Graphs key on their *logical* counts (padding-invariant: a graph and
    its padded twin tune once); explicit shapes key on their counts
    directly. Both go through :meth:`GraphShape.bucket_for`, so similar
    sizes alias one tuned config.
    """
    if graph is not None:
        return GraphShape.bucket_for(
            int(graph.n_vertices_logical), int(graph.n_edges_logical),
            weighted=bool(graph.weighted),
        )
    if shape is None:
        raise ValueError("shape_bucket needs graph= or shape=")
    return GraphShape.bucket_for(
        shape.n_vertices, shape.n_edges, weighted=shape.weighted
    )


def tuning_key(mir_fingerprint: str, bucket: GraphShape,
               kind: str = "local") -> str:
    """Content key of one tuned config: MIR x shape bucket x backend kind."""
    h = hashlib.sha256()
    h.update(mir_fingerprint.encode("ascii"))
    h.update(b"\x00")
    h.update(repr(bucket).encode("utf-8"))
    h.update(b"\x00")
    h.update(kind.encode("ascii"))
    return h.hexdigest()


@dataclass(frozen=True)
class TunedConfig:
    """The winner of one search: a Target plus the evidence behind it."""

    mir_fingerprint: str
    bucket: GraphShape
    target: Target
    objective_s: float          # best measured objective of the winner
    baseline_s: float           # same objective under Target.baseline()
    trials: int                 # measured candidates in the producing search
    objective: str = OBJECTIVE

    @property
    def speedup(self) -> float:
        return self.baseline_s / max(self.objective_s, 1e-12)

    @property
    def key(self) -> str:
        return tuning_key(self.mir_fingerprint, self.bucket, self.target.kind)

    def to_dict(self) -> dict:
        return {
            "mir_fingerprint": self.mir_fingerprint,
            "bucket": self.bucket.to_dict(),
            "target": self.target.to_dict(),
            "objective_s": self.objective_s,
            "baseline_s": self.baseline_s,
            "trials": self.trials,
            "objective": self.objective,
        }

    @staticmethod
    def from_dict(d: dict) -> "TunedConfig":
        return TunedConfig(
            mir_fingerprint=str(d["mir_fingerprint"]),
            bucket=GraphShape(**d["bucket"]),
            target=Target.from_dict(d["target"]),
            objective_s=float(d["objective_s"]),
            baseline_s=float(d["baseline_s"]),
            trials=int(d["trials"]),
            objective=str(d.get("objective", OBJECTIVE)),
        )

    def describe(self) -> str:
        return (
            f"tuned[{self.mir_fingerprint[:12]} x "
            f"{self.bucket.n_vertices}v/{self.bucket.n_edges}e] "
            f"{self.target.describe()} — {self.objective}="
            f"{self.objective_s * 1e3:.2f}ms, {self.speedup:.2f}x over "
            f"baseline ({self.trials} trials)"
        )


class TuningCache:
    """Persistent (MIR x bucket x kind) -> :class:`TunedConfig` store.

    A thread-safe in-memory map over per-key JSON files in ``store_dir``
    (``None`` = memory-only). One file per key keeps writes atomic-enough
    for concurrent tuners (last writer wins, both winners are measured-
    valid) and lets a deployment persist the directory with the artifact
    store. A file holds the port's ``Target.to_dict()``; the reference
    package's files are never read. ``hits``/``misses``/``stores`` count
    lookups.
    """

    def __init__(self, store_dir: Optional[str] = None) -> None:
        self.store_dir = store_dir
        self._lock = threading.Lock()
        self._mem: Dict[str, TunedConfig] = {}
        self.hits = 0
        self.misses = 0
        self.stores = 0

    def _path(self, key: str) -> Optional[str]:
        if not self.store_dir:
            return None
        return os.path.join(self.store_dir, f"{key[:24]}.json")

    def get(self, mir_fingerprint: str, bucket: GraphShape,
            kind: str = "local") -> Optional[TunedConfig]:
        key = tuning_key(mir_fingerprint, bucket, kind)
        with self._lock:
            cfg = self._mem.get(key)
        if cfg is None:
            path = self._path(key)
            if path and os.path.isfile(path):
                # corrupt/foreign file: a miss, never a crash — the tuner
                # simply searches again and overwrites it
                try:
                    with open(path) as f:
                        cfg = TunedConfig.from_dict(json.load(f))
                except (OSError, ValueError, KeyError, TypeError):
                    cfg = None
                if cfg is not None and cfg.key != key:
                    cfg = None  # renamed/moved file: content disagrees
                if cfg is not None:
                    with self._lock:
                        self._mem[key] = cfg
        with self._lock:
            if cfg is None:
                self.misses += 1
            else:
                self.hits += 1
        return cfg

    def put(self, cfg: TunedConfig) -> None:
        key = cfg.key
        with self._lock:
            self._mem[key] = cfg
            self.stores += 1
        path = self._path(key)
        if path:
            # unwritable store degrades to memory-only, never to a failure
            try:
                os.makedirs(self.store_dir, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(cfg.to_dict(), f, indent=2, sort_keys=True)
                    f.write("\n")
                os.replace(tmp, path)
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._mem),
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __repr__(self) -> str:
        return (
            f"TuningCache(store={self.store_dir!r}, "
            f"entries={len(self)}, hits={self.hits}, misses={self.misses})"
        )


@dataclass
class TuneReport:
    """What one ``tune()`` call did: the config plus search accounting."""

    config: TunedConfig
    trials: int                 # candidates measured by THIS call (0 = hit)
    cache_hit: bool
    candidates: int             # candidates after pruning (pre-cap)
    pruned: Tuple[str, ...] = ()      # human-readable prune decisions
    measurements: List[Dict[str, Any]] = field(default_factory=list)
    #: the winner's already-lowered Accelerator (stamped with the config;
    #: ready to ``save``); None on a cache hit — lower via
    #: ``program.lower(report.config.target, ...)`` instead
    accelerator: Optional[Accelerator] = None

    def describe(self) -> str:
        how = "cache hit, zero search" if self.cache_hit else (
            f"{self.trials} measured trial(s) over {self.candidates} "
            f"candidate(s)"
        )
        lines = [f"{self.config.describe()}", f"  search: {how}"]
        for p in self.pruned:
            lines.append(f"  pruned: {p}")
        for m in self.measurements:
            mark = "*" if m.get("winner") else (
                "x" if m.get("dominated") else " ")
            lines.append(
                f"  {mark} {m['target']}: "
                f"{m['objective_s'] * 1e3:.2f}ms"
                + (" (dominated)" if m.get("dominated") else "")
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# analysis-driven pruning helpers
# ---------------------------------------------------------------------------


def _is_racy(module: mir.Module) -> bool:
    from ..analysis import determinism_certificate

    return determinism_certificate(module) == "racy"


def _kernels_flat(module: mir.Module):
    """Every kernel including pipeline stages (direction lives per stage)."""
    for k in module.kernels.values():
        if isinstance(k, mir.PipelineKernel):
            yield k
            for s in k.stages:
                yield s
        else:
            yield k


def _frontier_relevant(module: mir.Module) -> bool:
    """True when some edge kernel could take the compacted-frontier path.

    A kernel with no frontier annotation never compacts; a ``DENSE``
    direction verdict means the pass proved the frontier loop-invariant
    and the engine always streams the full edge list. Only ``SPARSE`` /
    undecided (``AUTO``) frontier kernels make ``compact_frontier``
    observable.
    """
    for k in _kernels_flat(module):
        if getattr(k, "frontier", None) is None:
            continue
        direction = getattr(k, "direction", mir.Direction.AUTO)
        if direction is not mir.Direction.DENSE:
            return True
    return False


def _has_edge_kernel(module: mir.Module) -> bool:
    return any(
        k.kind is mir.KernelKind.EDGE for k in _kernels_flat(module)
    )


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


class AutoTuner:
    """Searches the Target knob space for one (program, shape bucket).

    Parameters
    ----------
    cache
        The :class:`TuningCache` consulted before and written after a
        search. Defaults to a cache over :func:`default_tuning_dir`.
    reps
        Best-of-``reps`` measured repetitions per surviving candidate.
    margin
        Early-termination factor: a candidate whose *first* repetition
        exceeds ``margin`` x the incumbent best is dominated — its
        remaining repetitions are skipped.
    max_candidates
        Cap on measured candidates; the cost-model ranking decides which
        make the cut (the base target always does).
    device
        Where trials lower, bind and run, as for ``Program.bind``: ``None``
        means ``"cuda"``.
    """

    def __init__(self, cache: Optional[TuningCache] = None, *,
                 reps: int = 3, margin: float = 1.5,
                 max_candidates: int = 12, device: Optional[str] = None) -> None:
        if reps < 1:
            raise ValueError("reps must be >= 1")
        if margin <= 1.0:
            raise ValueError("margin must be > 1.0")
        if max_candidates < 1:
            raise ValueError("max_candidates must be >= 1")
        self.cache = cache if cache is not None else TuningCache(
            default_tuning_dir()
        )
        self.reps = reps
        self.margin = margin
        self.max_candidates = max_candidates
        self.device = device

    # -- candidate enumeration ------------------------------------------------
    def candidates(self, program, base: Target) -> Tuple[List[Target], List[str]]:
        """Analysis-pruned knob grid around ``base``.

        Returns ``(targets, prune_notes)``. The grid enumerates the
        boolean memory-access knobs; knobs proven irrelevant (or
        forbidden) by static analysis are pinned to their forced value
        instead of doubling the grid.
        """
        module = program.module
        pruned: List[str] = []
        axes: Dict[str, Tuple[Any, ...]] = {}
        for knob in SEARCHED_KNOBS:
            axes[knob] = (True, False)
        if _is_racy(module):
            # the engine forces shuffle back on for racy programs
            # (determinism guard): shuffle=False lowers to the same
            # executable — dead duplicate candidates
            axes["shuffle"] = (True,)
            pruned.append(
                "shuffle pinned on: GT101-racy program (engine forces "
                "deterministic shuffle)"
            )
        if not _frontier_relevant(module):
            axes["compact_frontier"] = (getattr(base, "compact_frontier"),)
            pruned.append(
                "compact_frontier variants skipped: no SPARSE/AUTO frontier "
                "kernel (DENSE verdicts stream the full edge list)"
            )
        if not _has_edge_kernel(module):
            axes["burst"] = (base.burst,)
            axes["cache"] = (base.cache,)
            pruned.append(
                "burst/cache variants skipped: no edge kernel (vertex "
                "streams are already sequential)"
            )
        out: List[Target] = []
        names = list(axes)
        def rec(i: int, acc: Dict[str, Any]) -> None:
            if i == len(names):
                out.append(replace(base, **acc))
                return
            for v in axes[names[i]]:
                acc[names[i]] = v
                rec(i + 1, acc)
            acc.pop(names[i], None)
        rec(0, {})
        # dedupe while keeping enumeration order (pinning can alias)
        seen = set()
        uniq = []
        for t in out:
            if t not in seen:
                seen.add(t)
                uniq.append(t)
        return uniq, pruned

    # -- cost-model warm start ------------------------------------------------
    @staticmethod
    def _cost_score(candidate: Target, plans) -> float:
        """Static cost estimate used only to *order* measured trials.

        Seeds from the base lowering's per-kernel report. ``None`` byte
        estimates (the port's reports carry none) degrade to the flops
        field's lane-count fallback — ordering quality drops, but nothing
        crashes.
        """
        score = 0.0
        for plan in plans:
            unit = plan.bytes_accessed
            if unit is None:
                unit = plan.flops
            if unit is None:
                unit = 1.0
            factor = 1.0
            is_edge = plan.kind in ("edge", "pipeline")
            if is_edge:
                if not candidate.burst:
                    # unpartitioned random-order streaming: the dominant
                    # term — every gather walks DRAM out of order
                    factor *= 1.35
                if not candidate.cache:
                    factor *= 1.10   # no hub-vertex gather cache
                if not candidate.shuffle:
                    factor *= 1.15   # random scatter vs binned reduction
                if candidate.compact_frontier and plan.direction != "dense":
                    factor *= 0.95   # sparse frontiers skip inactive edges
            score += float(unit) * factor
        return score

    # -- measurement ----------------------------------------------------------
    @staticmethod
    def _objective_from_trace(trace: Optional[Dict[str, Any]],
                              wall_s: float) -> float:
        """Sum of ``launch:<kernel>`` span totals, else the wall time."""
        spans = (trace or {}).get("spans") or {}
        total = sum(
            v.get("total_s", 0.0)
            for name, v in spans.items() if name.startswith("launch:")
        )
        return total if total > 0.0 else wall_s

    def _measure(self, program, target: Target, shape: GraphShape, graph,
                 params: Dict[str, Any],
                 stop_after_s: Optional[float]) -> Tuple[float, bool, Accelerator]:
        """Best-of-reps objective for one candidate.

        Returns ``(objective_s, dominated, accelerator)``; ``dominated``
        means the first repetition already exceeded ``stop_after_s`` and
        the remaining repetitions were skipped.
        """
        acc = Accelerator(program, target, shape, device=self.device)
        session = acc.bind(graph)
        try:
            session.run(**params)  # warm-up: first touches out of the trials
            best = float("inf")
            for rep in range(self.reps):
                t0 = time.perf_counter()
                res = session.run(**params)
                wall = time.perf_counter() - t0
                best = min(best, self._objective_from_trace(
                    getattr(res, "trace", None), wall
                ))
                if rep == 0 and stop_after_s is not None \
                        and best > stop_after_s:
                    return best, True, acc
            return best, False, acc
        finally:
            session.close()

    # -- the search -----------------------------------------------------------
    def tune(self, program, graph, *, params: Optional[Dict[str, Any]] = None,
             target: Optional[Target] = None,
             force: bool = False) -> TuneReport:
        """Resolve (search or recall) the tuned Target for this program
        on this graph's shape bucket.

        ``params`` are the probe query's run-time parameters (required
        parameters of the program must be supplied — e.g. ``{"root": 0}``
        for BFS). ``target`` seeds the search (kind, pinned knobs);
        defaults to ``Target()``. ``force=True`` re-searches even on a
        cache hit.
        """
        if target is None:
            target = Target()
        mir_fp = program_mir_fingerprint(program)
        bucket = shape_bucket(graph=graph)
        if not force:
            cached = self.cache.get(mir_fp, bucket, target.kind)
            if cached is not None:
                return TuneReport(
                    config=cached, trials=0, cache_hit=True, candidates=0,
                )
        params = program.validate_params(dict(params or {}))
        shape = GraphShape.of(graph)
        cands, pruned = self.candidates(program, target)
        sp = tel.get().span(
            "autotune", fingerprint=mir_fp[:16],
            bucket=f"{bucket.n_vertices}v/{bucket.n_edges}e",
            candidates=len(cands),
        ) if tel.enabled() else tel.NULL_SPAN
        with sp:
            report = self._search(
                program, graph, params, target, shape, mir_fp, bucket,
                cands, pruned,
            )
            sp.set(trials=report.trials)
        return report

    def _search(self, program, graph, params, base: Target,
                shape: GraphShape, mir_fp: str, bucket: GraphShape,
                cands: List[Target], pruned: List[str]) -> TuneReport:
        # trials need launch-span objectives: enable tracing for the
        # search, restore the caller's state after (an already-enabled
        # tracer is left untouched — enable() is idempotent)
        was_enabled = tel.enabled()
        if not was_enabled:
            tel.enable()
        try:
            # cost-model warm start: lower the base target once, rank the
            # rest by the static estimate seeded from its report
            measurements: List[Dict[str, Any]] = []
            best_s, _, best_acc = self._measure(
                program, base, shape, graph, params, None
            )
            best_target = base
            trials = 1
            measurements.append({
                "target": base.describe(), "objective_s": best_s,
                "dominated": False,
            })
            plans = best_acc.report().kernels
            rest = [t for t in cands if t != base]
            rest.sort(key=lambda t: self._cost_score(t, plans))
            rest = rest[: max(0, self.max_candidates - 1)]
            for cand in rest:
                obj_s, dominated, acc = self._measure(
                    program, cand, shape, graph, params,
                    stop_after_s=best_s * self.margin,
                )
                trials += 1
                measurements.append({
                    "target": cand.describe(), "objective_s": obj_s,
                    "dominated": dominated,
                })
                if not dominated and obj_s < best_s:
                    best_s, best_target, best_acc = obj_s, cand, acc
            # the baseline referee: measured when not already among the
            # trials, so every TunedConfig records a like-for-like speedup
            baseline = replace(Target.baseline(), kind=base.kind, n_devices=base.n_devices,
                               axis=base.axis)
            baseline_s = next(
                (m["objective_s"] for m, t in zip(measurements, [base] + rest)
                 if t == baseline and not m["dominated"]),
                None,
            )
            if baseline_s is None:
                baseline_s, _, base_acc = self._measure(
                    program, baseline, shape, graph, params, None
                )
                trials += 1
                measurements.append({
                    "target": baseline.describe(),
                    "objective_s": baseline_s, "dominated": False,
                })
                # the referee competes too: "tuned" must never be slower
                # than the all-optimizations-off baseline it is judged
                # against
                if baseline_s < best_s:
                    best_s, best_target, best_acc = (
                        baseline_s, baseline, base_acc
                    )
            for m in measurements:
                m["winner"] = m["target"] == best_target.describe()
            cfg = TunedConfig(
                mir_fingerprint=mir_fp, bucket=bucket, target=best_target,
                objective_s=best_s, baseline_s=baseline_s, trials=trials,
            )
            self.cache.put(cfg)
            best_acc.tuned = cfg.to_dict()
            return TuneReport(
                config=cfg, trials=trials, cache_hit=False,
                candidates=len(cands), pruned=tuple(pruned),
                measurements=measurements, accelerator=best_acc,
            )
        finally:
            if not was_enabled:
                tel.disable()


def autotune(program, graph, *, params: Optional[Dict[str, Any]] = None,
             cache: Optional[TuningCache] = None,
             target: Optional[Target] = None,
             force: bool = False, **tuner_opts) -> TuneReport:
    """One-call convenience: ``AutoTuner(cache, **opts).tune(...)``."""
    return AutoTuner(cache, **tuner_opts).tune(
        program, graph, params=params, target=target, force=force
    )
