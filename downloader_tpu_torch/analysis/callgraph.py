"""Module-resolved call graph over an analyzed module set.

Nodes are functions keyed ``(module_path, class_name | None, name)``;
edges come from the engine's per-function ``CallSite`` facts, resolved
through a whole-program index of module-level defs, classes (with
their base-class chains), and import bindings. Resolution is
*precision-first*: a call the index cannot pin to exactly one package
function stays unresolved and contributes no edge — the same
false-negatives-over-false-positives stance the engine takes for lock
paths, because every interprocedural rule treats an unresolved callee
as effect-free.

What resolves:

- ``name(...)``         — a def in the same module, a nested helper of
  the calling class, a local class (its ``__init__``), or a
  ``from m import name`` binding into another package module;
- ``self.m(...)`` / ``cls.m(...)`` — the calling class's method,
  walking resolvable base classes (cross-module via imports);
- ``C.m(...)``          — a method of a class named in scope;
- ``alias.f(...)`` / ``a.b.f(...)`` — a def/class of the imported
  module the prefix names;
- ``self._x.m(...)``    — via one level of attribute-type inference:
  ``self._x = SomeClass(...)`` (or a parameter annotated
  ``SomeClass``) anywhere in the class pins ``_x``'s type; two
  conflicting assignments unpin it.

Everything else (locals of unknown type, results of calls, dynamic
dispatch) is out of static reach — the runtime recorders exist for
that residue.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import engine
from .core import Module

# a function key: (module_path, class_name | None, function name)
FuncKey = tuple[str, str | None, str]


def _key_sort(key: FuncKey):
    return (key[0], key[1] or "", key[2])


def module_dotted_name(path: str) -> str:
    """The dotted import name of a source file, anchored at the
    package root, the last path part named ``downloader_tpu_torch``
    (``.../downloader_tpu_torch/fetch/http.py`` ->
    ``downloader_tpu_torch.fetch.http``). Files outside the package
    (fixture trees) use their stem — same-module resolution still
    works."""
    parts = path.replace("\\", "/").split("/")
    try:
        anchor = len(parts) - 1 - parts[::-1].index("downloader_tpu_torch")
    except ValueError:
        stem = parts[-1]
        return stem[:-3] if stem.endswith(".py") else stem
    dotted = parts[anchor:]
    leaf = dotted[-1]
    if leaf.endswith(".py"):
        leaf = leaf[:-3]
    dotted[-1] = leaf
    if leaf == "__init__":
        dotted = dotted[:-1]
    return ".".join(dotted)


@dataclass
class ClassInfo:
    module_path: str
    name: str
    bases: list[str] = field(default_factory=list)  # dotted source text
    methods: dict[str, engine.FunctionAnalysis] = field(default_factory=dict)
    # attr -> (module_dotted, class_name) pinned type, or None when
    # two sites disagree (conflict sentinel)
    attr_types: dict[str, tuple[str, str] | None] = field(default_factory=dict)


@dataclass
class ModuleIndex:
    module: Module
    scan: engine.ModuleScan
    dotted: str
    defs: dict[str, engine.FunctionAnalysis] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    # local name -> ("module", dotted) | ("symbol", dotted, name)
    imports: dict[str, tuple] = field(default_factory=dict)
    # module-level singletons: `MONITOR = Watchdog(...)` pins the
    # global's type; raw (name, dotted-ctor-text) pairs resolved into
    # global_types once every module is indexed
    global_assigns: list = field(default_factory=list)
    global_types: dict[str, tuple[str, str] | None] = field(default_factory=dict)


def _dotted_text(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class CallGraph:
    """The whole-program index plus the resolved edge set."""

    def __init__(self, modules: list[Module], scans: dict[str, engine.ModuleScan]):
        self.indexes: dict[str, ModuleIndex] = {}
        self.by_dotted: dict[str, ModuleIndex] = {}
        self.functions: dict[FuncKey, engine.FunctionAnalysis] = {}
        # per-function local/param type memo (resolve-time, lazy)
        self._local_types: dict[int, dict] = {}
        for module in modules:
            scan = scans[module.path]
            index = self._index_module(module, scan)
            self.indexes[module.path] = index
            self.by_dotted.setdefault(index.dotted, index)
            for (cls, name), fa in scan.methods.items():
                self.functions[(module.path, cls, name)] = fa
            # the (None, name) slot must hold the TRUE module-level def
            # (scan.methods is first-scanned-wins; a nested def sharing
            # the name could otherwise occupy the key)
            for name, fa in index.defs.items():
                self.functions[(module.path, None, name)] = fa
        self._infer_attr_types()
        # resolved edges: caller key -> sorted callee keys
        self.edges: dict[FuncKey, list[FuncKey]] = {}
        self.reverse: dict[FuncKey, list[FuncKey]] = {}
        for key, fa in self.functions.items():
            targets: set[FuncKey] = set()
            for site in fa.call_sites:
                resolved = self.resolve(key[0], fa, site)
                if resolved is not None and resolved != key:
                    targets.add(resolved)
            ordered = sorted(targets, key=_key_sort)
            self.edges[key] = ordered
            for target in ordered:
                self.reverse.setdefault(target, []).append(key)

    # -- indexing ---------------------------------------------------------

    def _index_module(self, module: Module, scan: engine.ModuleScan) -> ModuleIndex:
        index = ModuleIndex(module, scan, module_dotted_name(module.path))

        top_nodes: dict[str, ast.AST] = {}

        def visit(body: list[ast.stmt], class_name: str | None) -> None:
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if class_name is None:
                        top_nodes[node.name] = node  # last def wins
                elif isinstance(node, ast.ClassDef):
                    info = ClassInfo(module.path, node.name)
                    for base in node.bases:
                        text = _dotted_text(base)
                        if text is not None:
                            info.bases.append(text)
                    index.classes.setdefault(node.name, info)
                    visit(node.body, node.name)
                elif isinstance(node, ast.Import):
                    for alias in node.names:
                        index.imports[alias.asname or alias.name.split(".")[0]] = (
                            ("module", alias.name)
                            if alias.asname
                            else ("module", alias.name.split(".")[0])
                        )
                        if alias.asname is None:
                            # `import a.b` binds "a" but makes "a.b"
                            # addressable through the attribute chain
                            index.imports.setdefault(
                                alias.name, ("module", alias.name)
                            )
                elif isinstance(node, ast.ImportFrom):
                    base = node.module or ""
                    if node.level:
                        # level 1 is the containing package: for a
                        # plain module that means dropping the leaf,
                        # for a package __init__ the dotted name IS
                        # the package already
                        anchor = index.dotted.split(".")
                        is_package = module.path.replace("\\", "/").endswith(
                            "/__init__.py"
                        )
                        drop = node.level - (1 if is_package else 0)
                        if drop:
                            anchor = anchor[: len(anchor) - drop]
                        base = ".".join(anchor + ([node.module] if node.module else []))
                    for alias in node.names:
                        if alias.name == "*":
                            continue
                        index.imports[alias.asname or alias.name] = (
                            "symbol",
                            base,
                            alias.name,
                        )
                else:
                    if (
                        class_name is None
                        and isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)
                    ):
                        text = _dotted_text(node.value.func)
                        if text is not None:
                            index.global_assigns.append(
                                (node.targets[0].id, text)
                            )
                    for child in ast.iter_child_nodes(node):
                        if isinstance(child, ast.stmt):
                            visit([child], class_name)

        visit(module.tree.body, None)
        # bind def/method FunctionAnalysis records from the scan. Bind
        # module-level defs by AST NODE identity, not name: a nested
        # def sharing the name occupies the same (None, name) key in
        # scan.methods (first scanned wins) but is not addressable
        # from module scope — matching by node keeps a closure from
        # shadowing (or being shadowed by) the real top-level def
        for fa in scan.functions:
            if fa.class_name is None:
                if top_nodes.get(fa.node.name) is fa.node:
                    index.defs[fa.node.name] = fa
            elif fa.class_name in index.classes:
                index.classes[fa.class_name].methods.setdefault(
                    fa.node.name, fa
                )
        return index

    def _infer_attr_types(self) -> None:
        """One level of attribute-type inference per class:
        ``self._x = SomeClass(...)`` (or ``self._x = param`` with
        ``param: SomeClass``) pins ``_x``; conflicting sites unpin.
        Module-level singletons (``MONITOR = Watchdog(...)``) pin the
        global's type the same way."""
        for index in self.indexes.values():
            for global_name, text in index.global_assigns:
                pinned = self._class_named(index, text)
                if pinned is None:
                    continue
                known = index.global_types.get(global_name, ())
                if known == ():
                    index.global_types[global_name] = pinned
                elif known != pinned:
                    index.global_types[global_name] = None  # conflict
        for index in self.indexes.values():
            for info in index.classes.values():
                for fa in info.methods.values():
                    annotations: dict[str, tuple[str, str] | None] = {}
                    args = fa.node.args
                    for arg in list(args.posonlyargs) + list(args.args) + list(
                        args.kwonlyargs
                    ):
                        if arg.annotation is None:
                            continue
                        text = None
                        if isinstance(arg.annotation, ast.Constant) and isinstance(
                            arg.annotation.value, str
                        ):
                            text = arg.annotation.value
                        else:
                            text = _dotted_text(arg.annotation)
                        if text:
                            annotations[arg.arg] = self._class_named(index, text)
                    for stmt in engine.own_statements(fa.node):
                        if not (
                            isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Attribute)
                            and isinstance(stmt.targets[0].value, ast.Name)
                            and stmt.targets[0].value.id == "self"
                        ):
                            continue
                        attr = stmt.targets[0].attr
                        pinned: tuple[str, str] | None = None
                        value = stmt.value
                        if isinstance(value, ast.BoolOp) and isinstance(
                            value.op, ast.Or
                        ):
                            # `self.pool = pool or ConnectionPool(...)`:
                            # the default names the type either way
                            value = value.values[-1]
                        if isinstance(value, ast.Call):
                            text = _dotted_text(value.func)
                            if text:
                                pinned = self._class_named(index, text)
                        elif isinstance(value, ast.Name):
                            pinned = annotations.get(value.id)
                        if pinned is None:
                            continue
                        known = info.attr_types.get(attr, ())
                        if known == ():
                            info.attr_types[attr] = pinned
                        elif known != pinned:
                            info.attr_types[attr] = None  # conflict

    def _follow_symbol(
        self, dotted: str, symbol: str, depth: int = 0
    ) -> tuple[str, str] | None:
        """(module_dotted, class) for ``symbol`` exported by module
        ``dotted``, following ``from .x import C`` re-export chains
        (package ``__init__`` facades) a few hops."""
        target = self.by_dotted.get(dotted)
        if target is None or depth > 4:
            return None
        if symbol in target.classes:
            return (target.dotted, symbol)
        binding = target.imports.get(symbol)
        if binding and binding[0] == "symbol":
            return self._follow_symbol(binding[1], binding[2], depth + 1)
        return None

    def _class_named(self, index: ModuleIndex, text: str) -> tuple[str, str] | None:
        """Resolve dotted source text to (module_dotted, class) when it
        names a class visible from ``index``."""
        head, _, rest = text.partition(".")
        if not rest:
            if head in index.classes:
                return (index.dotted, head)
            binding = index.imports.get(head)
            if binding and binding[0] == "symbol":
                return self._follow_symbol(binding[1], binding[2])
            return None
        binding = index.imports.get(head)
        if binding and binding[0] == "module":
            # a.b.C — find the longest module prefix, the leaf is the class
            mod, _, cls = text.rpartition(".")
            resolved_mod = self._module_for_prefix(index, mod)
            if resolved_mod is not None:
                return self._follow_symbol(resolved_mod.dotted, cls)
        return None

    def _module_for_prefix(self, index: ModuleIndex, prefix: str) -> ModuleIndex | None:
        head, _, rest = prefix.partition(".")
        binding = index.imports.get(head)
        if binding is None:
            return None
        if binding[0] == "module":
            dotted = binding[1] + ("." + rest if rest else "")
            return self.by_dotted.get(dotted)
        if binding[0] == "symbol" and not rest:
            # `from a import b` where b is a submodule
            return self.by_dotted.get(binding[1] + "." + binding[2])
        return None

    # -- resolution -------------------------------------------------------

    def _class_info(self, ref: tuple[str, str] | None) -> ClassInfo | None:
        if ref is None:
            return None
        index = self.by_dotted.get(ref[0])
        if index is None:
            return None
        return index.classes.get(ref[1])

    def _method_in(
        self, index: ModuleIndex, cls: str, name: str, depth: int = 0
    ) -> FuncKey | None:
        """Method lookup through the base-class chain (depth-capped)."""
        info = index.classes.get(cls)
        if info is None or depth > 6:
            return None
        if name in info.methods:
            return (info.module_path, cls, name)
        for base_text in info.bases:
            base_ref = self._class_named(index, base_text)
            base_info = self._class_info(base_ref)
            if base_info is None:
                continue
            base_index = self.by_dotted.get(base_ref[0])
            found = self._method_in(base_index, base_ref[1], name, depth + 1)
            if found is not None:
                return found
        return None

    def _symbol_key(
        self, binding: tuple, name_hint: str, depth: int = 0
    ) -> FuncKey | None:
        """A ("symbol", module, name) import binding as a callable,
        following re-export chains."""
        target = self.by_dotted.get(binding[1])
        if target is None or depth > 4:
            return None
        symbol = binding[2]
        if symbol in target.defs:
            return (target.module.path, None, symbol)
        if symbol in target.classes:
            init = target.classes[symbol].methods.get("__init__")
            if init is not None:
                return (target.module.path, symbol, "__init__")
            return None
        onward = target.imports.get(symbol)
        if onward and onward[0] == "symbol":
            return self._symbol_key(onward, name_hint, depth + 1)
        return None

    def resolve(
        self, module_path: str, fa: engine.FunctionAnalysis, site: engine.CallSite
    ) -> FuncKey | None:
        index = self.indexes.get(module_path)
        if index is None:
            return None
        name, kind = site.name, site.kind
        if kind in ("self", "cls"):
            if fa.class_name is None:
                return None
            return self._method_in(index, fa.class_name, name)
        if kind == "bare":
            # nested helper defs of the calling class shadow the module
            nested = index.scan.methods.get((fa.class_name, name))
            if fa.class_name is not None and nested is not None and (
                name not in index.defs
            ):
                return (module_path, fa.class_name, name)
            if name in index.defs:
                return (module_path, None, name)
            if name in index.classes:
                init = index.classes[name].methods.get("__init__")
                return (module_path, name, "__init__") if init else None
            binding = index.imports.get(name)
            if binding and binding[0] == "symbol":
                return self._symbol_key(binding, name)
            return None
        if kind in ("attr", "dotted"):
            parts = (site.recv or "").split(".")
            # a typed local or annotated parameter shadows module scope
            # (Python semantics): `state: _FetchState` or
            # `state = _FetchState(...)` pins the receiver's class
            local_ref = self._value_type(index, fa, parts[0])
            if local_ref is not None:
                target = self._walk_attrs(("class", local_ref), parts[1:])
                return self._callable_on(target, name)
            target = self._walk_chain(index, parts)
            return self._callable_on(target, name)
        if kind == "selfattr":
            if fa.class_name is None:
                return None
            target = self._walk_attrs(
                ("class", (index.dotted, fa.class_name)),
                (site.recv or "").split("."),
            )
            return self._callable_on(target, name)
        return None

    def _callable_on(self, target: tuple | None, name: str) -> FuncKey | None:
        """``name`` called on a resolved receiver — a module's def or
        class constructor, or a class's method."""
        if target is None:
            return None
        tkind, tval = target
        if tkind == "module":
            tindex: ModuleIndex = tval
            if name in tindex.defs:
                return (tindex.module.path, None, name)
            if name in tindex.classes:
                init = tindex.classes[name].methods.get("__init__")
                return (tindex.module.path, name, "__init__") if init else None
            return None
        mod_dotted, cls = tval
        tindex = self.by_dotted.get(mod_dotted)
        if tindex is None:
            return None
        return self._method_in(tindex, cls, name)

    def _value_type(
        self, index: ModuleIndex, fa: engine.FunctionAnalysis, name: str
    ) -> tuple[str, str] | None:
        """The pinned class of a local value: an annotated parameter
        (``state: "_FetchState"``) or a single-constructor local
        (``state = _FetchState(...)``); conflicting assignments unpin."""
        cache = self._local_types.setdefault(id(fa), {})
        if name in cache:
            return cache[name]
        ref: tuple[str, str] | None = None
        args = fa.node.args
        for arg in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if arg.arg != name or arg.annotation is None:
                continue
            text = (
                arg.annotation.value
                if isinstance(arg.annotation, ast.Constant)
                and isinstance(arg.annotation.value, str)
                else _dotted_text(arg.annotation)
            )
            if text:
                ref = self._class_named(index, text)
        assigned: set = set()
        for stmt in engine.own_statements(fa.node):
            if not (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == name
            ):
                continue
            pinned = None
            if isinstance(stmt.value, ast.Call):
                text = _dotted_text(stmt.value.func)
                if text:
                    pinned = self._class_named(index, text)
            assigned.add(pinned)
        if assigned:
            # re-binding a local unpins it unless every assignment
            # agrees on one constructor
            ref = assigned.pop() if len(assigned) == 1 else None
        cache[name] = ref
        return ref

    def _walk_chain(self, index: ModuleIndex, parts: list[str]) -> tuple | None:
        """Resolve a receiver chain (``watchdog.MONITOR.scheduler``)
        part by part: import bindings, then submodules / classes /
        typed module globals, then typed instance attributes."""
        if not parts or not parts[0]:
            return None
        head = parts[0]
        binding = index.imports.get(head)
        current: tuple | None = None
        if binding is not None:
            if binding[0] == "module":
                mod = self.by_dotted.get(binding[1])
                current = ("module", mod) if mod is not None else None
            else:
                src = self.by_dotted.get(binding[1])
                sub = self.by_dotted.get(binding[1] + "." + binding[2])
                ref = self._follow_symbol(binding[1], binding[2])
                if sub is not None:
                    current = ("module", sub)
                elif ref is not None:
                    current = ("class", ref)
                elif src is not None and src.global_types.get(binding[2]):
                    current = ("class", src.global_types[binding[2]])
        elif head in index.classes:
            current = ("class", (index.dotted, head))
        elif index.global_types.get(head):
            current = ("class", index.global_types[head])
        if current is None:
            return None
        if len(parts) == 1:
            return current
        if current[0] == "module":
            return self._walk_module(current[1], parts[1:])
        return self._walk_attrs(current, parts[1:])

    def _walk_module(self, mod: ModuleIndex, parts: list[str]) -> tuple | None:
        for i, part in enumerate(parts):
            sub = self.by_dotted.get(mod.dotted + "." + part)
            if sub is not None:
                mod = sub
                continue
            if part in mod.classes:
                return self._walk_attrs(
                    ("class", (mod.dotted, part)), parts[i + 1:]
                )
            if mod.global_types.get(part):
                return self._walk_attrs(
                    ("class", mod.global_types[part]), parts[i + 1:]
                )
            return None
        return ("module", mod)

    def _walk_attrs(self, current: tuple, parts: list[str]) -> tuple | None:
        for part in parts:
            info = self._class_info(current[1])
            if info is None:
                return None
            ref = info.attr_types.get(part)
            if not ref:
                return None
            current = ("class", ref)
        return current

    def resolve_spawn(
        self, module_path: str, fa: engine.FunctionAnalysis, spawn: engine.ThreadSpawn
    ) -> FuncKey | None:
        """The function a ``threading.Thread(target=...)`` (or an
        executor ``submit(fn, ...)``) runs."""
        if spawn.target_name is None:
            return None
        if spawn.kind == "method":
            # `pool.submit(stream.ship, ...)` — the receiver's type is
            # out of reach, but a method name defined by exactly ONE
            # class in this module is unambiguous
            index = self.indexes.get(module_path)
            if index is None:
                return None
            owners = [
                cls
                for cls, info in index.classes.items()
                if spawn.target_name in info.methods
            ]
            if len(owners) == 1:
                return (module_path, owners[0], spawn.target_name)
            return None
        kind = "self" if spawn.kind == "self" else "bare"
        site = engine.CallSite(
            spawn.target_name, spawn.line, (), kind, None, (), ()
        )
        return self.resolve(module_path, fa, site)
