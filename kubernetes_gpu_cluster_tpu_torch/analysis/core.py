"""kgct-torch-lint core: module model, shared analyses, runner.

Design constraints:

- Pure :mod:`ast`: the linter never imports torch (or the linted modules),
  so it runs in milliseconds anywhere, including a build host and a fresh
  CI container with no accelerator stack.
- Shared analyses live HERE and are computed once per module
  (:class:`LintModule` caches them): which methods are reachable from the
  engine step hot path, which of them only behind a sanctioned
  ``with ph("device_fetch")`` sync window, which statements sit inside
  such a window. Rules stay small and declarative on top.
- Sound-where-it-matters, syntactic everywhere else: every rule is an
  approximation of a semantic property (host syncs, KV ownership, await
  windows, ...). Approximations here are tuned to ZERO findings on
  invariant-holding code: the tier-1 baseline test enforces an empty
  baseline with no allowlist, so a rule that cries wolf cannot ship.

The JAX package's traced functions, jit cache and donated buffers have
their counterparts in the engine's step programs
(``engine/step_programs.py``): a step body the program cache captures
into a CUDA graph, one graph per key of its family (the draft runner's
bodies registered in the engine's cache too), and the static outputs each
replay overwrites. :meth:`LintModule.captured_functions`
finds the bodies as the JAX core finds jitted functions; KGCT001,
KGCT003 and KGCT004 police them.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
from functools import cached_property
from pathlib import Path
from typing import Iterable, Iterator, Optional


# Attributes and calls whose result on a tensor is host-side metadata, not
# a device value: branching on them reads nothing back.
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                          "itemsize"})
STATIC_CALLS = frozenset({"len", "isinstance", "type", "size", "dim",
                          "numel", "element_size"})

# The program cache: the class whose constructor takes step bodies, the
# method by which another owner registers more (the draft runner in its
# engine's cache, which returns the cache), and its one capture method
# (where a graph may be captured).
PROGRAM_CACHE = "StepPrograms"
PROGRAM_REGISTER = "add_families"
CAPTURE_METHOD = "_capture"


@dataclasses.dataclass(frozen=True)
class CapturedFn:
    """A function the program cache captures: ``body(key, buffers)``. The
    key is static Python data; ``tensor_params`` (the buffers) carry device
    values."""
    node: ast.AST
    tensor_params: tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str       # e.g. "KGCT002"
    name: str       # e.g. "host-sync-in-hot-path"
    path: str       # repo-relative when a root was given
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.name}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute chains, 'f' for Names, ''
    otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def tainted_refs(expr: ast.AST, tainted: set) -> list:
    """Names in ``expr`` that carry device values, EXCLUDING references
    that resolve to host-side metadata (``.shape``, ``.dtype``,
    ``len()``, ``.size()``)."""
    hits: list = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
            return
        if isinstance(node, ast.Call):
            callee = node.func
            name = (callee.id if isinstance(callee, ast.Name)
                    else getattr(callee, "attr", ""))
            if name in STATIC_CALLS:
                return
        if isinstance(node, ast.Name) and node.id in tainted:
            hits.append(node.id)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return hits


def propagate_taint(fn: ast.AST, seeds: Iterable[str]) -> set:
    """Fixpoint over simple assignments: a name assigned from a tainted
    expression becomes tainted (one function's scope, nested defs
    included)."""
    tainted = set(seeds)
    for _ in range(10):
        grew = False
        for node in ast.walk(fn):
            value = targets = None
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.For):
                value, targets = node.iter, [node.target]
            if value is None or not tainted_refs(value, tainted):
                continue
            for tgt in targets:
                for leaf in ast.walk(tgt):
                    if (isinstance(leaf, ast.Name)
                            and leaf.id not in tainted):
                        tainted.add(leaf.id)
                        grew = True
        if not grew:
            break
    return tainted


def _params(fn: ast.AST) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def is_program_cache_call(node: ast.AST) -> bool:
    """``StepPrograms(...)``, ``<module>.StepPrograms(...)`` or
    ``<cache>.add_families(...)``: a call that hands step bodies to a
    program cache and returns the cache."""
    if not isinstance(node, ast.Call):
        return False
    return (_dotted(node.func).split(".")[-1] == PROGRAM_CACHE
            or (isinstance(node.func, ast.Attribute)
                and node.func.attr == PROGRAM_REGISTER))


class LintModule:
    """One parsed source file plus lazily computed shared analyses."""

    def __init__(self, path: Path, source: Optional[str] = None,
                 root: Optional[Path] = None):
        global PARSE_COUNT
        PARSE_COUNT += 1
        self.path = Path(path)
        self.source = (self.path.read_text() if source is None else source)
        self.tree = ast.parse(self.source, filename=str(path))
        # Set by run_lint to the run's package-wide PackageModel; rules on
        # a standalone module build a single-module model on demand.
        self.package: Optional["PackageModel"] = None
        try:
            self.relpath = str(self.path.resolve().relative_to(
                Path(root).resolve())) if root else str(path)
        except ValueError:
            self.relpath = str(path)
        self._parents: dict = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    # -- generic structure ---------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    @cached_property
    def functions(self) -> list:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    @cached_property
    def classes(self) -> list:
        return [n for n in ast.walk(self.tree) if isinstance(n, ast.ClassDef)]

    def inside_phase_block(self, node: ast.AST, phase: str) -> bool:
        """Is ``node`` lexically inside ``with <anything>("<phase>")``?
        The engine brackets every sanctioned device->host sync in
        ``with ph("device_fetch")`` — the phase attribution that makes the
        sync visible in /metrics is exactly what makes it sanctioned."""
        for anc in self.ancestors(node):
            if not isinstance(anc, ast.With):
                continue
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and any(
                        isinstance(a, ast.Constant) and a.value == phase
                        for a in expr.args):
                    return True
        return False

    def enclosing_class(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    @staticmethod
    def methods_of(cls: ast.ClassDef) -> dict:
        return {n.name: n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    # -- step-program analysis ----------------------------------------------

    @cached_property
    def captured_functions(self) -> list:
        """Every step body handed to the program cache (``StepPrograms(body,
        ...)``, or each value of ``StepPrograms({family: body, ...},
        ...)`` or of ``<cache>.add_families({family: body, ...}, ...)``),
        resolved like the JAX core's jitted functions:
        ``self.<method>`` to the method of the enclosing class, a bare name
        to the def of the enclosing scope or module; a body named twice is
        taken once. The cache calls ``body(key, buffers)``: every parameter
        after the key (and ``self``) carries tensors. The methods of the
        class the body calls with tensor arguments run inside the capture
        too; they are followed, with the parameters those arguments bind as
        seeds."""
        out: list = []
        defs: dict = {}
        for fn in self.functions:
            defs.setdefault(self.enclosing_function(fn), {})[fn.name] = fn
        seen: set = set()
        for node in ast.walk(self.tree):
            if not (is_program_cache_call(node) and node.args):
                continue
            first = node.args[0]
            bodies = first.values if isinstance(first, ast.Dict) else [first]
            for body in bodies:
                target, cls = None, None
                if (isinstance(body, ast.Attribute)
                        and isinstance(body.value, ast.Name)
                        and body.value.id == "self"):
                    cls = self.enclosing_class(node)
                    if cls is not None:
                        target = self.methods_of(cls).get(body.attr)
                elif isinstance(body, ast.Name):
                    scope = self.enclosing_function(node)
                    target = (defs.get(scope, {}).get(body.id)
                              or defs.get(None, {}).get(body.id))
                if target is None or id(target) in seen:
                    continue
                seen.add(id(target))
                params = _params(target)
                skip = 2 if params[:1] == ["self"] else 1
                out.extend(self._follow_captured(
                    target, tuple(params[skip:]),
                    self.methods_of(cls) if cls is not None else {}))
        return out

    def _follow_captured(self, root, seeds: tuple, methods: dict) -> list:
        """``root`` and every method of ``methods`` it reaches through
        ``self.<m>(...)`` calls with tainted arguments, each with the
        parameters those arguments bind (unioned over call sites)."""
        seeded = {root.name: (root, set(seeds))}
        frontier = [root.name]
        while frontier:
            fn, seeds_now = seeded[frontier.pop()]
            tainted = propagate_taint(fn, seeds_now)
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "self"
                        and call.func.attr in methods):
                    continue
                callee = methods[call.func.attr]
                params = _params(callee)[1:]
                bound = {params[i] for i, a in enumerate(call.args)
                         if i < len(params) and tainted_refs(a, tainted)}
                bound |= {kw.arg for kw in call.keywords
                          if kw.arg in params
                          and tainted_refs(kw.value, tainted)}
                if not bound:
                    continue
                known = seeded.get(callee.name, (callee, set()))[1]
                if not bound <= known:
                    seeded[callee.name] = (callee, known | bound)
                    frontier.append(callee.name)
        return [CapturedFn(fn, tuple(sorted(sd)))
                for fn, sd in seeded.values()]

    def program_cache_attrs(self, cls: ast.ClassDef) -> set:
        """``self.<attr>`` names of ``cls`` bound to a program cache."""
        return {tgt.attr for node in ast.walk(cls)
                if isinstance(node, ast.Assign)
                and is_program_cache_call(node.value)
                for tgt in node.targets
                if isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"}

    def program_calls(self, fn: ast.AST, attrs: set, method: str) -> list:
        """Calls ``self.<attr>.<method>(...)`` in ``fn`` on a program-cache
        attribute."""
        return [node for node in ast.walk(fn)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == method
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr in attrs
                and isinstance(node.func.value.value, ast.Name)
                and node.func.value.value.id == "self"]

    # -- hot-path analysis ---------------------------------------------------

    def _step_reachable(self, skip_phase: Optional[str] = None) -> list:
        """Methods reachable from an Engine class's step entry points via
        direct ``self.<method>()`` calls, not following calls made inside
        ``with <anything>("<skip_phase>")`` when one is given. Scope:
        classes whose name contains "Engine" with a ``step``/``_step*``
        method; reachability is intra-class (cross-module hops land in
        that module's own lint run)."""
        out: list = []
        for cls in self.classes:
            if "Engine" not in cls.name:
                continue
            methods = self.methods_of(cls)
            roots = [name for name in methods
                     if name == "step" or name.startswith("_step")]
            if not roots:
                continue
            seen: set = set()
            frontier = list(roots)
            while frontier:
                name = frontier.pop()
                if name in seen or name not in methods:
                    continue
                seen.add(name)
                for node in ast.walk(methods[name]):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and isinstance(node.func.value, ast.Name)
                            and node.func.value.id == "self"
                            and not (skip_phase and self.inside_phase_block(
                                node, skip_phase))):
                        frontier.append(node.func.attr)
            out.extend(methods[n] for n in sorted(seen))
        return out

    @cached_property
    def hot_path_functions(self) -> list:
        """The per-token serving hot path: every method reachable from
        ``step``/``_step*``."""
        return self._step_reachable()

    @cached_property
    def unfetched_hot_path_functions(self) -> list:
        """The hot path minus what is reached only from inside a
        ``with ph("device_fetch")`` window: a fetch helper (the engine's
        ``_sync``, ``_finish_fetch``) whose every hot-path call sits in the
        window inherits its sanction; one called outside it does not."""
        return self._step_reachable(skip_phase="device_fetch")

    # -- concurrency analysis ------------------------------------------------

    @property
    def package_model(self) -> "PackageModel":
        """The run's package-wide concurrency model (attached by run_lint);
        a standalone module gets a single-module model, so per-rule pins
        and ad-hoc CLI runs over one file still resolve local structure."""
        if self.package is None:
            self.package = PackageModel([self])
        return self.package

    @cached_property
    def concurrency(self) -> "ModuleConcurrency":
        """Per-module facts the PackageModel combines: functions and their
        async-ness, thread targets, worker-op callables, resolvable call
        edges, attribute->class bindings, lock definitions/acquisitions."""
        return ModuleConcurrency(self)


class Rule:
    """Base class: one invariant, checked per module. Subclasses set
    ``code``/``name``/``description`` and implement :meth:`check`."""

    code: str = ""
    name: str = ""
    description: str = ""

    def check(self, mod: LintModule) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: LintModule, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.code, name=self.name, path=mod.relpath,
                       line=getattr(node, "lineno", 0), message=message)


# -- interprocedural concurrency model ----------------------------------------

# Wrappers that execute a callable argument on the engine worker thread —
# the ONE sanctioned seam between the serving event loop and engine state.
WORKER_WRAPPERS = frozenset({"run_in_worker", "post_to_worker"})

# threading constructors whose instances are mutual-exclusion locks (the
# Condition wraps one). Events/Semaphores are signalling primitives with
# different blocking semantics and are out of scope here.
LOCK_CONSTRUCTORS = frozenset({"Lock", "RLock", "Condition"})

# Execution contexts a function can be proven to run in.
CTX_LOOP = "loop"       # the asyncio event loop thread
CTX_WORKER = "worker"   # the engine step-loop worker thread (or a peer
                        # daemon thread: heartbeats, watchdog, detach loops)


def _last_attr(node: ast.AST) -> str:
    """'Condition' for threading.Condition / Name('Condition'); '' else."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class ModuleConcurrency:
    """Syntactic concurrency facts for one module (no cross-module
    resolution — that is :class:`PackageModel`'s job)."""

    def __init__(self, mod: LintModule):
        self.mod = mod
        # local qualname ("Class.meth" | "func") -> (node, class name | None)
        self.functions: dict = {}
        # class name -> {method name: node}
        self.classes: dict = {}
        self.async_functions: set = set()
        # local qualnames handed to threading.Thread(target=...)
        self.thread_targets: set = set()
        # node ids lexically inside a callable passed to a worker wrapper
        self.worker_wrapped: set = set()
        # (lineno, wrapper name) for every run_in_worker/post_to_worker call
        self.seam_sites: list = []
        # method names called on a worker-op callable's own parameter (the
        # engine handle the worker passes in): the async->engine hop
        self.worker_op_targets: dict = {}   # method -> [lineno, ...]
        # caller local qualname -> worker-op target method names it reaches
        self.worker_ops_by_function: dict = {}
        # caller local qualname -> {("self", name) | ("local", name)
        #                           | ("attr", self_attr, method)} call edges
        self.calls: dict = {}
        # self.<attr> = ClassName(...) bindings (last definition wins)
        self.self_attr_class: dict = {}
        # lock names: self-attrs and module-level Names bound to a
        # threading Lock/RLock/Condition constructor call
        self.lock_names: set = set()
        # (lock name, enclosing local qualname | "", with-stmt lineno)
        self.acquisitions: list = []
        self._collect()

    def _qualname(self, fn: ast.AST) -> str:
        """Local qualname; nested defs fold into their outermost enclosing
        function (they run in — and inherit the context of — its frame)."""
        outer = fn
        for anc in self.mod.ancestors(fn):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                outer = anc
        cls = None
        for anc in self.mod.ancestors(outer):
            if isinstance(anc, ast.ClassDef):
                cls = anc.name
                break
        name = outer.name
        return f"{cls}.{name}" if cls else name

    def _collect(self) -> None:
        mod = self.mod
        for cls in mod.classes:
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            self.classes[cls.name] = methods
        for fn in mod.functions:
            if mod.enclosing_function(fn) is not None:
                continue        # nested defs run in their outer frame
            cls = None
            for anc in mod.ancestors(fn):
                if isinstance(anc, ast.ClassDef):
                    cls = anc.name
                    break
            key = f"{cls}.{fn.name}" if cls else fn.name
            self.functions[key] = (fn, cls)
            if isinstance(fn, ast.AsyncFunctionDef):
                self.async_functions.add(key)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                self._collect_call(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._collect_assign(node)
            elif isinstance(node, ast.With):
                self._collect_with(node)

    def _collect_call(self, node: ast.Call) -> None:
        mod = self.mod
        enclosing = mod.enclosing_function(node)
        caller = self._qualname(enclosing) if enclosing is not None else ""
        callee = node.func
        # threading.Thread(target=...): the target runs on its own thread.
        if _last_attr(callee) == "Thread":
            for kw in node.keywords:
                if kw.arg != "target":
                    continue
                tgt = kw.value
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    for anc in mod.ancestors(node):
                        if isinstance(anc, ast.ClassDef):
                            self.thread_targets.add(
                                f"{anc.name}.{tgt.attr}")
                            break
                elif isinstance(tgt, ast.Name):
                    self.thread_targets.add(tgt.id)
        # run_in_worker/post_to_worker: callable args execute on the
        # worker thread; calls on the callable's own parameter are engine
        # methods (the worker passes the engine in).
        if (isinstance(callee, ast.Attribute)
                and callee.attr in WORKER_WRAPPERS):
            self.seam_sites.append((node.lineno, callee.attr))
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, (ast.Lambda, ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    params = {a.arg for a in arg.args.args}
                    for sub in ast.walk(arg):
                        self.worker_wrapped.add(id(sub))
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and isinstance(sub.func.value, ast.Name)
                                and sub.func.value.id in params):
                            self.worker_op_targets.setdefault(
                                sub.func.attr, []).append(sub.lineno)
                            if caller:
                                self.worker_ops_by_function.setdefault(
                                    caller, set()).add(sub.func.attr)
                elif (isinstance(arg, ast.Attribute)
                      and isinstance(arg.value, ast.Name)
                      and arg.value.id == "self"):
                    for anc in mod.ancestors(node):
                        if isinstance(anc, ast.ClassDef):
                            self.thread_targets.add(f"{anc.name}.{arg.attr}")
                            break
        # Resolvable call edges for context propagation.
        if not caller:
            return
        edges = self.calls.setdefault(caller, set())
        if isinstance(callee, ast.Name):
            edges.add(("local", callee.id))
        elif isinstance(callee, ast.Attribute):
            base = callee.value
            if isinstance(base, ast.Name) and base.id == "self":
                edges.add(("self", callee.attr))
            elif (isinstance(base, ast.Attribute)
                  and isinstance(base.value, ast.Name)
                  and base.value.id == "self"):
                # self.<attr>.<method>() — resolved through the
                # self_attr_class binding by the PackageModel.
                edges.add(("attr", base.attr, callee.attr))

    def _collect_assign(self, node) -> None:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        value = node.value
        if not isinstance(value, ast.Call):
            return
        ctor = _last_attr(value.func)
        for tgt in targets:
            attr = None
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                attr = tgt.attr
            elif isinstance(tgt, ast.Name):
                attr = tgt.id
            if attr is None:
                continue
            if ctor in LOCK_CONSTRUCTORS:
                self.lock_names.add(attr)
            elif ctor and ctor[0].isupper():
                self.self_attr_class[attr] = ctor

    def _collect_with(self, node: ast.With) -> None:
        for item in node.items:
            expr = item.context_expr
            name = None
            if (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                name = expr.attr
            elif isinstance(expr, ast.Name):
                name = expr.id
            if name is None or name not in self.lock_names:
                continue
            enclosing = self.mod.enclosing_function(node)
            self.acquisitions.append(
                (name, self._qualname(enclosing) if enclosing else "",
                 node.lineno))


class PackageModel:
    """Package-wide call graph + async-reachability over one lint run.

    Answers the questions the concurrency rules (KGCT019–021) need and a
    per-module AST cannot: which functions run on the asyncio event loop,
    which run on the engine worker thread (seeded by ``async def``s,
    ``threading.Thread(target=...)`` loops and the callables handed to the
    ``run_in_worker``/``post_to_worker`` seam, then propagated through
    resolvable call edges — ``self.m()``, module-level ``f()``, and
    ``self.<attr>.<m>()`` through ``self.<attr> = ClassName(...)``
    bindings), which engine methods the worker-op seam reaches from which
    async functions, and which locks are acquired in which contexts.

    Soundness stance: the graph is a best-effort UNDER-approximation
    (unresolvable dynamic calls contribute no edges), so rules treat
    "proven loop AND proven worker" as the dangerous overlap and unknown
    contexts as silent. The vacuous-pass guard in tests/test_torch_lint.py
    pins that the model keeps resolving the real package's seam and at
    least one async->engine path — an empty graph fails there, loudly."""

    def __init__(self, modules: Iterable):
        self.modules = list(modules)
        # global qualname "relpath::Class.meth" -> context set
        self.contexts: dict = {}
        # class name -> (relpath, {method: node}) — first definition wins,
        # ambiguous re-definitions drop the entry (never guess).
        self.class_table: dict = {}
        self._ambiguous: set = set()
        # (relpath, lineno, wrapper) of every worker-op seam call site
        self.seam_sites: list = []
        # engine-method name -> [(relpath, lineno)] reached via worker ops
        self.worker_op_targets: dict = {}
        # (async caller global qualname, engine method name) pairs: the
        # proven async->engine paths through the seam
        self.async_engine_paths: list = []
        # (relpath, lock name) -> context set of its acquiring functions
        self.lock_contexts: dict = {}
        self._build()

    @staticmethod
    def _gq(relpath: str, local: str) -> str:
        return f"{relpath}::{local}"

    def _build(self) -> None:
        facts = [(m.relpath.replace("\\", "/"), m.concurrency)
                 for m in self.modules]
        for rel, fc in facts:
            for cls, methods in fc.classes.items():
                if cls in self.class_table or cls in self._ambiguous:
                    self.class_table.pop(cls, None)
                    self._ambiguous.add(cls)
                else:
                    self.class_table[cls] = (rel, methods)
            for lineno, wrapper in fc.seam_sites:
                self.seam_sites.append((rel, lineno, wrapper))
            for meth, lines in fc.worker_op_targets.items():
                self.worker_op_targets.setdefault(meth, []).extend(
                    (rel, ln) for ln in lines)
        # Context seeds.
        for rel, fc in facts:
            for local in fc.async_functions:
                self.contexts.setdefault(self._gq(rel, local),
                                         set()).add(CTX_LOOP)
            for local in fc.thread_targets:
                if local in fc.functions:
                    self.contexts.setdefault(self._gq(rel, local),
                                             set()).add(CTX_WORKER)
        # Worker-op engine methods: mark on Engine-named classes wherever
        # they resolve (cross-module: the LLMEngine the worker hands in).
        for meth in self.worker_op_targets:
            for cls, (rel, methods) in self.class_table.items():
                if "Engine" in cls and meth in methods:
                    self.contexts.setdefault(
                        self._gq(rel, f"{cls}.{meth}"),
                        set()).add(CTX_WORKER)
        # Propagate through resolvable edges to a fixpoint.
        for _ in range(20):
            grew = False
            for rel, fc in facts:
                for caller, edges in fc.calls.items():
                    src = self.contexts.get(self._gq(rel, caller))
                    if not src:
                        continue
                    for edge in edges:
                        tgt = self._resolve(rel, fc, caller, edge)
                        if tgt is None:
                            continue
                        dst = self.contexts.setdefault(tgt, set())
                        if not src <= dst:
                            dst.update(src)
                            grew = True
            if not grew:
                break
        # Async->engine paths: an async (loop) function whose worker-op
        # callable calls engine methods — the sanctioned crossing.
        for rel, fc in facts:
            for caller, meths in fc.worker_ops_by_function.items():
                gq = self._gq(rel, caller)
                if CTX_LOOP in self.contexts.get(gq, ()):
                    for meth in sorted(meths):
                        self.async_engine_paths.append((gq, meth))
        # Lock contexts: union of acquiring functions' contexts.
        for rel, fc in facts:
            for lock, local, _lineno in fc.acquisitions:
                ctxs = self.lock_contexts.setdefault((rel, lock), set())
                ctxs.update(self.contexts.get(self._gq(rel, local), ()))

    def _resolve(self, rel: str, fc: ModuleConcurrency, caller: str,
                 edge: tuple) -> Optional[str]:
        if edge[0] == "self":
            cls = caller.split(".", 1)[0] if "." in caller else None
            if cls and edge[1] in fc.classes.get(cls, ()):
                return self._gq(rel, f"{cls}.{edge[1]}")
        elif edge[0] == "local":
            if edge[1] in fc.functions and fc.functions[edge[1]][1] is None:
                return self._gq(rel, edge[1])
        elif edge[0] == "attr":
            cls_name = fc.self_attr_class.get(edge[1])
            entry = self.class_table.get(cls_name) if cls_name else None
            if entry and edge[2] in entry[1]:
                return self._gq(entry[0], f"{cls_name}.{edge[2]}")
        return None

    # -- rule-facing queries -------------------------------------------------

    def contexts_of(self, mod: LintModule, local_qualname: str) -> frozenset:
        rel = mod.relpath.replace("\\", "/")
        return frozenset(self.contexts.get(self._gq(rel, local_qualname),
                                           ()))

    def lock_contexts_of(self, mod: LintModule, lock: str) -> frozenset:
        rel = mod.relpath.replace("\\", "/")
        return frozenset(self.lock_contexts.get((rel, lock), ()))


# -- module cache -------------------------------------------------------------

# LintModule constructions this process has paid for. The warm-cache test
# pins that a re-run over unchanged files adds ZERO to this — the tier-1
# budget spends one parse per file per process, not per run_lint call.
PARSE_COUNT = 0

_MODULE_CACHE: dict = {}   # (resolved path, root key) -> (sha256, LintModule)


def get_module(path, root: Optional[Path] = None) -> LintModule:
    """Cached :class:`LintModule` keyed by (path, content hash). Content
    hash — not mtime — keys correctness: an edited file can never serve
    stale analyses, an untouched file never re-parses (the rules and
    every test sharing this process reuse one module model per file)."""
    p = Path(path)
    data = p.read_bytes()
    key = (str(p.resolve()), str(Path(root).resolve()) if root else None)
    digest = hashlib.sha256(data).hexdigest()
    hit = _MODULE_CACHE.get(key)
    if hit is not None and hit[0] == digest:
        return hit[1]
    mod = LintModule(p, source=data.decode("utf-8"), root=root)
    _MODULE_CACHE[key] = (digest, mod)
    return mod


# -- runner -------------------------------------------------------------------

def iter_py_files(paths: Iterable) -> list:
    files: list = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*.py")
                                if "__pycache__" not in f.parts))
        elif p.suffix == ".py":
            files.append(p)
    return files


def run_lint(paths: Iterable, rules: Optional[list] = None,
             root: Optional[Path] = None) -> list:
    """Run ``rules`` (default: all registered) over every .py under
    ``paths``; returns findings sorted by location. A syntactically broken
    file is itself a finding — the linter must never silently skip.

    Modules come from the content-hash cache (one parse per file per
    process) and share one :class:`PackageModel` built over THIS run's
    file set, so the concurrency rules see the whole package's call
    graph, not one file at a time."""
    from .rules import ALL_RULES
    rules = list(ALL_RULES) if rules is None else list(rules)
    findings: list = []
    modules: list = []
    for path in iter_py_files(paths):
        try:
            modules.append(get_module(path, root=root))
        except SyntaxError as e:
            findings.append(Finding(
                rule="KGCT000", name="parse-error", path=str(path),
                line=e.lineno or 0, message=f"cannot parse: {e.msg}"))
    package = PackageModel(modules)
    for mod in modules:
        mod.package = package
        for rule in rules:
            findings.extend(rule.check(mod))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
